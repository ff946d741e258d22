"""Optimizers: AdamW and Adafactor, global-norm clipping (see
``repro.train.optimizer``).

Plain functions over a model's named parameters: ``params`` and ``grads``
are ``{name: tensor}`` dicts (``dict(model.named_parameters())``), the
state is a dict of such dicts, and ``update(params, grads, state, step,
hyper)`` writes the new values into ``params`` and ``state`` in place
(under ``torch.no_grad``) and returns them.  The update formulas are the
reference's, float32 scalars included, not ``torch.optim``'s variants.

Adafactor (factored second moments, Shazeer & Stern 2018) keeps a row and
a column factor per matrix instead of Adam's two full moments.  It sees
the parameters as the reference's pytree stacks them: the per-layer
leaves of one path (``layers.<i>.ln1.scale`` for every i) form one
stacked parameter (:func:`stack_groups`), whose factoring and update RMS
are the reference's.  Its state is therefore keyed by group, not by
parameter: ``state["f"]["layers.ln1.scale"]`` holds the factors of the
(n_layers, d) stacked scale (a row factor (n_layers,) and a column factor
(d,)); a stacked matrix (L, a, b) has factors (L, a) and (L, b); a leaf
that is not stacked (``embed.tok.table``) is a group of one under its own
name.  AdamW is elementwise and keeps one m and v per parameter.

``zero1_extend_spec`` / ``opt_state_specs`` are the reference's ZeRO-1
specs of the optimizer state (``launch/sharding.py``'s spec tuples over
``{name: ...}`` trees), read by ``launch/specs.py``.  The sharded train
step (``train/zero.py``) updates each rank's block of the parameters with
these same formulas: AdamW is elementwise, and Adafactor takes its means
over the whole parameter through a :class:`Means`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["OptHyper", "global_norm", "clip_by_global_norm", "adamw_init",
           "adamw_update", "adafactor_init", "adafactor_leaf",
           "adafactor_update", "stack_key", "stack_groups", "Means",
           "Optimizer",
           "get_optimizer", "zero1_extend_spec", "opt_state_specs"]

Tensors = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class OptHyper:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    epsilon1: float = 1e-30
    epsilon2: float = 1e-3


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _step(step, like: torch.Tensor) -> torch.Tensor:
    """The step as a float32 scalar on ``like``'s device (a Python int, or
    a tensor: the dry run's meta step)."""
    if torch.is_tensor(step):
        return step.to(device=like.device, dtype=torch.float32)
    return _f32(float(step), like)


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32."""
    total = None
    for x in tensors.values():
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tensors, max_norm: float,
                        inplace: bool = False,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / max(norm, 1e-9)) ->
    (grads, norm).  ``inplace`` scales the given tensors (the train step's
    choice: no second copy of the gradients).  ``norm``: the global norm
    when ``grads`` are blocks of it (default: :func:`global_norm`)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    out = {}
    with torch.no_grad():
        for k, g in grads.items():
            scaled = (g.float() * scale).to(g.dtype)
            out[k] = g.copy_(scaled) if inplace else scaled
    return out, norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params: Tensors) -> Dict[str, Tensors]:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return {"m": zeros,
            "v": {k: torch.zeros_like(z) for k, z in zeros.items()}}


@torch.no_grad()
def adamw_update(params: Tensors, grads: Tensors, state: Dict[str, Tensors],
                 step: int, h: OptHyper):
    """One AdamW step (bias-corrected moments, decoupled weight decay)."""
    any_p = next(iter(params.values()))
    t = _step(step, any_p) + 1.0
    bc1 = 1.0 - _f32(h.beta1, any_p) ** t
    bc2 = 1.0 - _f32(h.beta2, any_p) ** t
    for k, p in params.items():
        g = grads[k].float()
        m, v = state["m"][k], state["v"][k]
        m.copy_(h.beta1 * m + (1 - h.beta1) * g)
        v.copy_(h.beta2 * v + (1 - h.beta2) * g * g)
        pf = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + h.eps) \
            + h.weight_decay * pf
        p.copy_((pf - h.lr * delta).to(p.dtype))
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018): factored second moments, no momentum
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def stack_key(name: str) -> Tuple[str, Tuple[int, ...]]:
    """A parameter's place in the reference's stacked pytree: its path
    without the layer indices (``layers.3.mamba.1.in_proj.w`` ->
    ``layers.mamba.in_proj.w``) and those indices ((3, 1)); () for a leaf
    that is not stacked."""
    parts = name.split(".")
    return (".".join(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def stack_groups(names) -> Dict[str, Tuple[Tuple[int, ...],
                                           List[Tuple[Tuple[int, ...], str]]]]:
    """``{group key: (stack shape, [(index, name), ...] in index order)}``:
    the per-layer parameters ``names`` grouped as the reference's pytree
    stacks them (``layers.<i>.``, ``enc.layers.<i>.``, and a hybrid
    period's inner ``mamba.<j>.`` / ``moe.<j>.`` / ``mlp.<j>.``).  A
    parameter that is not stacked is a group of one, stack shape ()."""
    groups: Dict[str, List[Tuple[Tuple[int, ...], str]]] = {}
    for name in names:
        key, idx = stack_key(name)
        groups.setdefault(key, []).append((idx, name))
    out = {}
    for key, members in groups.items():
        members.sort()
        stack = tuple(max(ix[a] for ix, _ in members) + 1
                      for a in range(len(members[0][0])))
        if math.prod(stack) != len(members):
            raise ValueError(f"{key}: {len(members)} leaves do not fill a "
                             f"{stack} stack")
        out[key] = (stack, members)
    return out


def adafactor_leaf(stack: Tuple[int, ...], block: Tuple[int, ...],
                   factored: bool, device=None) -> Tensors:
    """One group's zero Adafactor state: the row and column factors, or a
    full second moment, of a ``stack + block`` parameter (``block``: the
    held piece of each stacked leaf; ``factored``: the whole stacked
    parameter's factoring)."""
    z = dict(dtype=torch.float32, device=device)
    shape = tuple(stack) + tuple(block)
    if factored:
        return {"vr": torch.zeros(shape[:-1], **z),
                "vc": torch.zeros(shape[:-2] + shape[-1:], **z)}
    return {"v": torch.zeros(shape, **z)}


def adafactor_init(params: Tensors) -> Dict[str, Dict[str, Tensors]]:
    """The reference's state of the stacked parameters: ``{"f": {group
    key: factors}}`` (:func:`stack_groups`)."""
    out = {}
    for key, (stack, members) in stack_groups(params).items():
        p = params[members[0][1]]
        out[key] = adafactor_leaf(stack, tuple(p.shape),
                                  _factored(stack + tuple(p.shape)),
                                  p.device)
    return {"f": out}


class Means:
    """The sums Adafactor takes over a whole parameter ``k``, given the
    tensor it holds: here the parameter itself.  ``train/zero.py``'s
    subclass holds a block and adds the other ranks' partial sums."""

    def shape(self, k: str, p: torch.Tensor) -> tuple:
        """The whole parameter's shape."""
        return tuple(p.shape)

    def part(self, k: str, t: torch.Tensor, dim: int,
             pdim: int) -> torch.Tensor:
        """``t`` on its dim ``dim``, which is the parameter's dim ``pdim``,
        cut to the positions this piece counts in a sum over that dim:
        here all of them."""
        return t

    def total(self, k: str, part: torch.Tensor, dims) -> torch.Tensor:
        """``part``, the held block's sum over the parameter's ``dims``
        (with any leading dims; taken of :meth:`part` on each of them),
        summed over every piece of the parameter."""
        return part


#: the float32 bytes of gradient one stacked pass of Adafactor takes at
#: once: a group's layers go in stacks of this size, a large layer alone
STACK_BYTES = 1 << 28


def _stacked_update(ps, gs, s, stack, full, means: Means, key: str, rho,
                    h: OptHyper) -> None:
    """One group's Adafactor step (:func:`adafactor_update`), in place:
    ``ps`` / ``gs`` its layers' held blocks and float32 gradients in index
    order, ``s`` its state, ``full`` one layer's whole shape.  The layers
    go through in stacks of at most :data:`STACK_BYTES` (the update made
    twice, once for its RMS, rather than held for the whole group)."""
    n, k, nl = len(gs), len(stack), len(full)
    shape = tuple(stack) + tuple(full)
    per = max(1, STACK_BYTES // max(4 * gs[0].numel(), 1))
    spans = [(a, min(a + per, n)) for a in range(0, n, per)]

    def layers(ts, a, b):
        return ts[a][None] if b == a + 1 else torch.stack(ts[a:b])

    def flat(t, keep):      # the state with one leading layer axis
        return t.view((n,) + t.shape[keep:])

    if _factored(shape) and nl >= 2:
        rows = torch.empty(flat(s["vr"], k).shape, device=gs[0].device)
        cols = torch.empty(flat(s["vc"], k).shape, device=gs[0].device)
        for a, b in spans:
            g2 = layers(gs, a, b) ** 2 + h.epsilon1
            rows[a:b] = means.part(key, g2, -1, nl - 1).sum(-1)
            cols[a:b] = means.part(key, g2, -2, nl - 2).sum(-2)
        vr = rho * flat(s["vr"], k) + (1 - rho) * means.total(
            key, rows, (nl - 1,)) / full[-1]
        vc = rho * flat(s["vc"], k) + (1 - rho) * means.total(
            key, cols, (nl - 2,)) / full[-2]
        rmean = means.total(key, means.part(key, vr, -1, nl - 2).sum(
            -1, keepdim=True), (nl - 2,)) / full[-2]
        r_sqrt = torch.sqrt(vr / torch.clamp(rmean, min=h.epsilon1))
        c_sqrt = torch.sqrt(vc)

        def update(a, b):
            return layers(gs, a, b) / (r_sqrt[a:b, ..., None]
                                       * c_sqrt[a:b, ..., None, :]
                                       + h.epsilon2)
        flat(s["vr"], k).copy_(vr)
        flat(s["vc"], k).copy_(vc)
    elif _factored(shape):      # a stacked vector: factors across layers
        if nl != 1:
            raise NotImplementedError(f"{key}: a stacked scalar {shape}; no "
                                      f"parameter of the port is one")
        g2 = torch.stack(gs) ** 2 + h.epsilon1                  # (n, b)
        vr = rho * s["vr"] + (1 - rho) * means.total(
            key, means.part(key, g2, -1, 0).sum(-1).view(stack), (0,)) \
            / full[0]
        vc = rho * s["vc"] + (1 - rho) * g2.view(stack + gs[0].shape) \
            .sum(k - 1) / stack[-1]
        rfac = vr / torch.clamp(vr.mean(-1, keepdim=True), min=h.epsilon1)
        r_sqrt = torch.sqrt(rfac).reshape(n, 1)
        c_sqrt = torch.sqrt(vc)[..., None, :].expand(stack + gs[0].shape) \
            .reshape(n, -1)

        def update(a, b):
            return layers(gs, a, b) / (r_sqrt[a:b] * c_sqrt[a:b]
                                       + h.epsilon2)
        s["vr"].copy_(vr)
        s["vc"].copy_(vc)
    else:
        v = flat(s["v"], k)
        for a, b in spans:
            v[a:b] = rho * v[a:b] + (1 - rho) * (layers(gs, a, b) ** 2
                                                 + h.epsilon1)

        def update(a, b):
            return layers(gs, a, b) / (torch.sqrt(v[a:b]) + h.epsilon2)
    def counted(u):     # the positions this piece counts, on every dim
        for j in range(nl):
            u = means.part(key, u, j - nl, j)
        return u

    # the update's RMS over every layer at once
    sq = sum(torch.sum(torch.square(counted(update(a, b))))
             for a, b in spans)
    rms = torch.sqrt(means.total(key, sq, tuple(range(nl)))
                     / math.prod(shape) + h.epsilon1)
    scale = torch.clamp(rms, min=1.0)
    for a, b in spans:      # p - lr·(u / scale) - lr·wd·p, in that order
        pf = layers(ps, a, b).float()
        new = update(a, b).div_(scale).mul_(h.lr)
        torch.sub(pf, new, out=new)
        new = new.sub_(pf * (h.lr * h.weight_decay)).to(ps[a].dtype)
        for i in range(a, b):
            ps[i].copy_(new[i - a])


@torch.no_grad()
def adafactor_update(params: Tensors, grads: Tensors, state, step: int,
                     h: OptHyper, means: Optional[Means] = None):
    """One Adafactor step with update clipping (RMS <= 1) of the stacked
    parameters (:func:`stack_groups`), as the reference takes it over its
    pytree: a stacked norm (L, d) is factored, a stacked matrix's row and
    column factors are its layers', and the update's RMS is one over every
    layer.  ``means`` (a :class:`Means`) adds the sums over each whole
    parameter."""
    means = means or Means()
    any_p = next(iter(params.values()))
    t = _step(step, any_p) + 1.0
    rho = 1.0 - t ** (-h.decay_rate)
    for key, (stack, members) in stack_groups(params).items():
        names = [n for _, n in members]
        _stacked_update([params[n] for n in names],
                        [grads[n].float() for n in names], state["f"][key],
                        stack, means.shape(names[0], params[names[0]]),
                        means, names[0], rho, h)
    return params, state


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (params, grads, state, step, hyper) -> (params, state)


def get_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return Optimizer(adamw_init, adamw_update)
    if name == "adafactor":
        return Optimizer(adafactor_init, adafactor_update)
    raise ValueError(f"unknown optimizer {name!r}")


# ---------------------------------------------------------------------------
# ZeRO-1 style optimizer-state specs
# ---------------------------------------------------------------------------


def _names(axis) -> Tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def zero1_extend_spec(spec, shape, mesh, data_axis="data") -> tuple:
    """Extend one spec by splitting the first large unsplit dim over the
    data axis (ZeRO-1: the optimizer state lives split across the
    data-parallel replicas).  ``mesh``: anything with ``shape``."""
    dsize = math.prod(mesh.shape[ax] for ax in _names(data_axis))
    axes = list(spec) if spec is not None else []
    axes = (axes + [None] * (len(shape) - len(axes)))[:len(shape)]
    # the data axis can appear at most once across the whole spec
    used = {x for a in axes if a is not None for x in _names(a)}
    if used & set(_names(data_axis)):
        return tuple(axes)
    for i in range(len(shape)):
        if axes[i] is None and shape[i] % dsize == 0 and shape[i] >= dsize:
            axes[i] = data_axis
            break
    return tuple(axes)


def opt_state_specs(opt_name: str, param_specs, state, mesh,
                    data_axis="data", zero1: bool = True):
    """Spec tree of the optimizer ``state`` (the tree ``init`` gives).

    adamw: m / v take the parameters' specs (ZeRO-extended); adafactor:
    each factor's largest unsplit dim goes over data.
    """
    if opt_name == "adamw":
        def one(k, t):
            if zero1:
                return zero1_extend_spec(param_specs[k], t.shape, mesh,
                                         data_axis)
            return tuple(param_specs[k])
        return {part: {k: one(k, t) for k, t in state[part].items()}
                for part in ("m", "v")}

    def fac(t):
        if zero1:
            return zero1_extend_spec((), t.shape, mesh, data_axis)
        return (None,) * t.dim()
    return {"f": {k: {n: fac(t) for n, t in leaves.items()}
                  for k, leaves in state["f"].items()}}
