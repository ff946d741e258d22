"""Optimizers: AdamW and Adafactor, global-norm clipping (see
``repro.train.optimizer``).

Plain functions over a model's named parameters: ``params`` and ``grads``
are ``{name: tensor}`` dicts (``dict(model.named_parameters())``), the
state is a dict of such dicts, and ``update(params, grads, state, step,
hyper)`` writes the new values into ``params`` and ``state`` in place
(under ``torch.no_grad``) and returns them.  The update formulas are the
reference's, float32 scalars included, not ``torch.optim``'s variants.

Adafactor (factored second moments, Shazeer & Stern 2018) keeps a row and
a column factor per matrix instead of Adam's two full moments.

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
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

__all__ = ["OptHyper", "global_norm", "clip_by_global_norm", "adamw_init",
           "adamw_update", "adafactor_init", "adafactor_leaf",
           "adafactor_update", "Means", "Optimizer",
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


def adafactor_leaf(p: torch.Tensor, factored: bool) -> Tensors:
    """One parameter's zero Adafactor state: its row and column factors,
    or a full second moment."""
    z = dict(dtype=torch.float32, device=p.device)
    if factored:
        return {"vr": torch.zeros(p.shape[:-1], **z),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
    return {"v": torch.zeros(p.shape, **z)}


def adafactor_init(params: Tensors) -> Dict[str, Dict[str, Tensors]]:
    return {"f": {k: adafactor_leaf(p, _factored(p.shape))
                  for k, p in params.items()}}


class Means:
    """The means Adafactor takes over a whole parameter ``k``, given the
    tensor it holds: here the parameter itself.  ``train/zero.py``'s
    subclass holds a block and adds the other ranks' partial sums."""

    def shape(self, k: str, p: torch.Tensor) -> tuple:
        """The whole parameter's shape."""
        return tuple(p.shape)

    def rows(self, k: str, x: torch.Tensor) -> torch.Tensor:
        """Mean over the parameter's last dim."""
        return torch.mean(x, dim=-1)

    def cols(self, k: str, x: torch.Tensor) -> torch.Tensor:
        """Mean over its second-to-last dim."""
        return torch.mean(x, dim=-2)

    def rows_of_vr(self, k: str, vr: torch.Tensor) -> torch.Tensor:
        """Mean of the row factor over its last dim (the parameter's
        second-to-last), keeping it."""
        return torch.mean(vr, dim=-1, keepdim=True)

    def all(self, k: str, x: torch.Tensor) -> torch.Tensor:
        """Mean over every element."""
        return torch.mean(x)


@torch.no_grad()
def adafactor_update(params: Tensors, grads: Tensors, state, step: int,
                     h: OptHyper, means: Optional[Means] = None):
    """One Adafactor step with update clipping (RMS <= 1); ``means`` (a
    :class:`Means`) takes the row, column and RMS means over each whole
    parameter."""
    means = means or Means()
    any_p = next(iter(params.values()))
    t = _step(step, any_p) + 1.0
    rho = 1.0 - t ** (-h.decay_rate)
    for k, p in params.items():
        g = grads[k].float()
        s = state["f"][k]
        g2 = g * g + h.epsilon1
        if _factored(means.shape(k, p)):
            vr = rho * s["vr"] + (1 - rho) * means.rows(k, g2)
            vc = rho * s["vc"] + (1 - rho) * means.cols(k, g2)
            rfac = vr / torch.clamp(means.rows_of_vr(k, vr), min=h.epsilon1)
            update = g / (torch.sqrt(rfac)[..., None]
                          * torch.sqrt(vc)[..., None, :] + h.epsilon2)
            s["vr"].copy_(vr)
            s["vc"].copy_(vc)
        else:
            v = rho * s["v"] + (1 - rho) * g2
            update = g / (torch.sqrt(v) + h.epsilon2)
            s["v"].copy_(v)
        rms = torch.sqrt(means.all(k, torch.square(update)) + h.epsilon1)
        update = update / torch.clamp(rms, min=1.0)
        pf = p.float()
        p.copy_((pf - h.lr * update - h.lr * h.weight_decay * pf).to(p.dtype))
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
