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

The reference's ``zero1_extend_spec`` / ``opt_state_specs`` are mesh
partition specs; the port has no mesh sharding of the model yet
(``ROADMAP.md`` Queue 1 item 15, ``launch/sharding``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Tuple

import torch

__all__ = ["OptHyper", "global_norm", "clip_by_global_norm", "adamw_init",
           "adamw_update", "adafactor_init", "adafactor_update", "Optimizer",
           "get_optimizer"]

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


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32."""
    total = None
    for x in tensors.values():
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tensors, max_norm: float,
                        inplace: bool = False) -> Tuple[Tensors, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / max(norm, 1e-9)) ->
    (grads, norm).  ``inplace`` scales the given tensors (the train step's
    choice: no second copy of the gradients)."""
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
    t = _f32(float(step), any_p) + 1.0
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


def adafactor_init(params: Tensors) -> Dict[str, Dict[str, Tensors]]:
    def init(p):
        z = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}

    return {"f": {k: init(p) for k, p in params.items()}}


@torch.no_grad()
def adafactor_update(params: Tensors, grads: Tensors, state, step: int,
                     h: OptHyper):
    """One Adafactor step with update clipping (RMS <= 1)."""
    any_p = next(iter(params.values()))
    t = _f32(float(step), any_p) + 1.0
    rho = 1.0 - t ** (-h.decay_rate)
    for k, p in params.items():
        g = grads[k].float()
        s = state["f"][k]
        g2 = g * g + h.epsilon1
        if _factored(p.shape):
            vr = rho * s["vr"] + (1 - rho) * torch.mean(g2, dim=-1)
            vc = rho * s["vc"] + (1 - rho) * torch.mean(g2, dim=-2)
            rfac = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=h.epsilon1)
            update = g / (torch.sqrt(rfac)[..., None]
                          * torch.sqrt(vc)[..., None, :] + h.epsilon2)
            s["vr"].copy_(vr)
            s["vc"].copy_(vc)
        else:
            v = rho * s["v"] + (1 - rho) * g2
            update = g / (torch.sqrt(v) + h.epsilon2)
            s["v"].copy_(v)
        rms = torch.sqrt(torch.mean(torch.square(update)) + h.epsilon1)
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
