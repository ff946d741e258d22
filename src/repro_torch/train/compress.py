"""Gradient compression (int8 + error feedback) for the data-parallel
gradient sum (see ``repro.train.compress``).

Quantizing to int8 with one scale per tensor cuts the bytes of the
gradient all-reduce 4x against float32; the residual carried to the next
step (error feedback) keeps the sum unbiased in practice.  Used by
``train/step.py``'s ``make_ddp_step(..., compress=True)``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..launch.mesh import ShardGroup

__all__ = ["quantize_int8", "dequantize_int8", "init_error_feedback",
           "compressed_psum"]

Tensors = Dict[str, torch.Tensor]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization -> (q, scale)."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Tensors) -> Tensors:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compressed_psum(grads: Tensors, residuals: Tensors, group: ShardGroup
                    ) -> Tuple[Tensors, Tensors]:
    """Mean of the members' gradients through int8, with error feedback
    -> (mean gradients, new residuals).

    The reference's common-scale scheme: a max all-reduce of each tensor's
    ``amax`` fixes one scale every member shares, each member quantizes
    ``g + residual`` to int8 against it, the int8 values are summed in
    int32 (exact, in any order) and dequantized once.  The new residual is
    the member's value less its quantized representation.  Collective:
    every member calls it with the same names in the same order.
    """
    n = group.d
    mean, new_res = {}, {}
    for k, g in grads.items():
        gf = g.float() + residuals[k]
        amax = group.all_reduce_max(torch.max(torch.abs(gf)))
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        new_res[k] = gf - q.float() * scale
        summed = group.all_reduce_sum(q.to(torch.int32))
        mean[k] = (summed.float() * scale / n).to(g.dtype)
    return mean, new_res
