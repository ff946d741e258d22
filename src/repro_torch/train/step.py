"""Train steps: one data-parallel rank's step and the explicit DDP step
with optional int8 compression (see ``repro.train.step``).

``make_train_step(cfg)`` returns
    ``train_step(model, opt_state, batch, step) -> (model, opt_state, metrics)``:
the value and gradient of ``model.loss_fn`` (K4 forward, the PyTorch
backward), clipping to ``hyper.clip_norm``, the optimizer's update of the
parameters in place, and the metrics ``loss``, ``ce``, ``aux`` and
``grad_norm`` as device scalars.  The gradients are freed after the
update.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..device import DeviceLike
from ..launch.mesh import ShardGroup
from ..models.transformer import Transformer
from . import compress as compress_mod
from .optimizer import OptHyper, clip_by_global_norm, get_optimizer

__all__ = ["make_train_step", "init_train_state", "make_ddp_step"]


def _grads(model: Transformer, batch, attn_chunk: int,
           skip_upper_triangle: bool = True):
    model.zero_grad(set_to_none=True)
    loss, aux = model.loss_fn(batch, chunk=attn_chunk,
                              skip_upper_triangle=skip_upper_triangle)
    loss.backward()
    params = dict(model.named_parameters())
    return params, {k: p.grad for k, p in params.items()}, loss, aux


def _metrics(loss, aux, gnorm) -> Dict[str, torch.Tensor]:
    return {"ce": aux["ce"].detach(), "aux": aux["aux"].detach(),
            "loss": loss.detach(), "grad_norm": gnorm}


def make_train_step(cfg, hyper: OptHyper = OptHyper(), *,
                    attn_chunk: int = 1024, skip_upper_triangle: bool = True):
    opt = get_optimizer(cfg.optimizer)

    def train_step(model: Transformer, opt_state, batch, step: int):
        params, grads, loss, aux = _grads(model, batch, attn_chunk,
                                          skip_upper_triangle)
        grads, gnorm = clip_by_global_norm(grads, hyper.clip_norm,
                                           inplace=True)
        opt.update(params, grads, opt_state, step, hyper)
        model.zero_grad(set_to_none=True)
        return model, opt_state, _metrics(loss, aux, gnorm)

    return train_step


def init_train_state(cfg, generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None):
    """(model with random weights from ``generator``, optimizer state)."""
    model = Transformer.init_params(cfg, generator, device=device)
    opt = get_optimizer(cfg.optimizer)
    return model, opt.init(dict(model.named_parameters()))


# ---------------------------------------------------------------------------
# explicit DDP with optional int8 gradient compression
# ---------------------------------------------------------------------------


def _ordered_mean(group: ShardGroup, t: torch.Tensor) -> torch.Tensor:
    """Mean over the members, added in rank order: the same bits on every
    rank whatever the backend's reduction order."""
    if group.d == 1:
        return t
    parts = group.all_gather_cat(t.reshape(1, *t.shape))
    acc = parts[0]
    for r in range(1, group.d):
        acc = acc + parts[r]
    return acc / group.d


def make_ddp_step(cfg, group: ShardGroup, hyper: OptHyper = OptHyper(), *,
                  compress: bool = False, attn_chunk: int = 1024):
    """Pure data parallelism with an explicit gradient mean over ``group``.

    ``ddp_step(model, opt_state, batch, step, residuals)`` takes the global
    batch and computes on its own rows (rank ``r`` of ``d`` takes rows
    ``[r·B/d, (r+1)·B/d)``, the reference's ``P(axis)``); the parameters
    are replicated.  Returns ``(model, opt_state, loss, residuals)`` with
    the loss averaged over the ranks.  ``compress`` sums the gradients
    through int8 with error feedback (:func:`compress_mod.compressed_psum`).
    Collective: every rank calls it in the same order.
    """
    opt = get_optimizer(cfg.optimizer)

    def ddp_step(model: Transformer, opt_state, batch, step: int, residuals):
        rows = next(iter(batch.values())).shape[0]
        if rows % group.d:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{group.d} ranks")
        per = rows // group.d
        mine = {k: v[group.rank * per:(group.rank + 1) * per]
                for k, v in batch.items()}
        params, grads, loss, _ = _grads(model, mine, attn_chunk)
        if compress:
            grads, residuals = compress_mod.compressed_psum(grads, residuals,
                                                            group)
        else:
            grads = {k: _ordered_mean(group, g) for k, g in grads.items()}
        grads, _ = clip_by_global_norm(grads, hyper.clip_norm, inplace=True)
        opt.update(params, grads, opt_state, step, hyper)
        model.zero_grad(set_to_none=True)
        return model, opt_state, _ordered_mean(group, loss.detach()), \
            residuals

    return ddp_step
