"""Mixture-of-Experts FFN with sort-based routing (see ``repro.models.moe``).

Tokens are sorted by assigned expert and gathered into per-expert capacity
buckets, as in the reference:

    flatten -> top-k route -> stable sort by expert -> bucket to (E, C, d)
    -> batched expert products -> combine with the router's weights.

The routing is the reference's, decision for decision (:func:`route`):

* capacity ``C = max(int(T·k/E·capacity_factor), 1)``, rounded up to a
  multiple of 128 once it is >= 128 (:func:`capacity`);
* the top k of the float32 router softmax, equal probabilities going to the
  lower expert index as ``jax.lax.top_k`` orders them (a stable descending
  sort: ``torch.topk`` promises no order for equal values);
* a stable argsort of the flat (token, slot) experts; an assignment's rank
  is its place in its expert's group, and an assignment of rank >= C is
  dropped (its combine weight is 0).  Pad tokens are routed and take
  capacity like any other.

All E buckets run, full or empty.  The expert products are ``torch.bmm``
in the compute dtype (cuBLAS on the card): the reference computes them
with ``jnp.einsum`` outside any Pallas kernel, so this module has no
kernel of its own.  Where the reference scatter-adds the sorted
contributions into their tokens (``jax.ops.segment_sum``), the port puts
them back in (token, slot) order and sums each token's k slots in float32,
then casts to the compute dtype: the same sum in a fixed order.
``index_add_`` adds with atomics on the card, in no fixed order, so two
runs on the same input could differ in the last bit and a greedy decode
could then pick another token.

``"expert_tp"`` (the reference's expert-parallel ``shard_map``) needs an
expert group over ranks, which the port does not have yet; without one the
reference runs the sorted path, and so does the port.  The ``shard(...)``
annotations are dropped, as in the dense port.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, _empty

__all__ = ["MoE", "Routing", "capacity", "route", "moe_apply",
           "moe_apply_sorted", "MOE_IMPLS"]

MOE_IMPLS = ("sorted", "expert_tp")


class MoE(nn.Module):
    """``router.w`` (d, E), always float32; ``wi`` (E, d, f), ``wo``
    (E, f, d) and, for SwiGLU, ``wg`` (E, d, f) in ``dtype``."""

    def __init__(self, d: int, d_ff: int, n_experts: int, act: str, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        if act not in ("swiglu", "gelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.router = Dense(d, n_experts, device=device, dtype=torch.float32)
        self.wi = _empty((n_experts, d, d_ff), device, dtype)
        self.wg = _empty((n_experts, d, d_ff), device, dtype) \
            if act == "swiglu" else None
        self.wo = _empty((n_experts, d_ff, d), device, dtype)

    def reset(self, generator: torch.Generator) -> None:
        """``moe_init``'s distributions: normal/√d for the router, ``wi``
        and ``wg``; normal/√f for ``wo``."""
        self.router.reset(generator)
        d, f = self.wi.shape[1:]
        for w, fan_in in ((self.wi, d), (self.wg, d), (self.wo, f)):
            if w is not None:
                w.copy_(torch.randn(w.shape, generator=generator,
                                    device=w.device) * (1.0 / fan_in ** 0.5))


class Routing(NamedTuple):
    """One apply's routing.  ``order``, ``expert``, ``token``, ``gate``,
    ``rank`` and ``keep`` are over the T·k assignments in sorted (stable by
    expert) order."""
    probs: torch.Tensor         # (T, E) float32 router softmax
    gate_idx: torch.Tensor      # (T, k) experts, best first
    gate_vals: torch.Tensor     # (T, k) renormalised over the top k
    order: torch.Tensor         # (T·k,) stable argsort of the flat experts
    expert: torch.Tensor        # (T·k,) expert of each sorted assignment
    token: torch.Tensor         # (T·k,) its token
    gate: torch.Tensor          # (T·k,) its gate value
    rank: torch.Tensor          # (T·k,) its place in its expert's group
    keep: torch.Tensor          # (T·k,) rank < capacity
    bucket_tok: torch.Tensor    # (E, C) token in each bucket slot (0 if empty)
    bucket_valid: torch.Tensor  # (E, C) slot holds an assignment
    capacity: int
    aux: torch.Tensor           # () Switch-style load-balance loss


def capacity(t: int, cfg) -> int:
    """Bucket capacity for ``t`` tokens, the reference's formula."""
    c = max(int(t * cfg.experts_per_token / cfg.n_experts
                * cfg.capacity_factor), 1)
    return -(-c // 128) * 128 if c >= 128 else c


def route(p: MoE, x: torch.Tensor, cfg) -> Routing:
    """Route ``x`` (B, S, d) as the reference's ``moe_apply_sorted`` does."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    cap = capacity(t, cfg)
    dev = x.device
    logits = torch.matmul(x.reshape(t, d).float(), p.router.w)     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # top-k as lax.top_k orders it: ties to the lower index
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :k], idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    me = probs.mean(dim=0)                                          # (E,)
    ce = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    aux = torch.sum(me * ce) * e

    flat_expert = gate_idx.reshape(-1)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    se_, st_ = flat_expert[order], flat_token[order]
    sg_ = gate_vals.reshape(-1)[order]

    experts = torch.arange(e, device=dev)
    seg_start = torch.searchsorted(se_, experts)                    # (E,)
    seg_end = torch.searchsorted(se_, experts, right=True)
    rank = torch.arange(t * k, device=dev) - seg_start[se_]
    keep = rank < cap

    bucket_pos = seg_start[:, None] + torch.arange(cap, device=dev)[None, :]
    bucket_valid = bucket_pos < seg_end[:, None]
    bucket_pos = torch.clamp(bucket_pos, max=t * k - 1)
    bucket_tok = torch.where(bucket_valid, st_[bucket_pos],
                             torch.zeros((), dtype=st_.dtype, device=dev))
    return Routing(probs, gate_idx, gate_vals, order, se_, st_, sg_, rank,
                   keep, bucket_tok, bucket_valid, cap, aux.float())


def moe_apply_sorted(p: MoE, x: torch.Tensor, cfg
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out in x's dtype, aux loss float32)."""
    compute = x.dtype
    b, s, d = x.shape
    t, k = b * s, cfg.experts_per_token
    r = route(p, x, cfg)
    cap = r.capacity

    xf = x.reshape(t, d)
    xe = xf[r.bucket_tok] * r.bucket_valid[..., None].to(compute)  # (E, C, d)
    h = torch.bmm(xe, p.wi.to(compute))
    if p.wg is not None:
        h = F.silu(torch.bmm(xe, p.wg.to(compute))) * h
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    ye = torch.bmm(h, p.wo.to(compute))                             # (E, C, d)

    # each assignment's bucket row and weight, back in (token, slot) order
    flat_out = ye.reshape(-1, d)
    assign_bucket = torch.where(r.keep, r.expert * cap +
                                torch.clamp(r.rank, max=cap - 1), 0)
    inv = torch.empty_like(r.order)
    inv[r.order] = torch.arange(t * k, device=x.device)
    weight = (r.gate * r.keep)[inv]
    contrib = flat_out[assign_bucket[inv]] * weight[:, None].to(compute)
    out = contrib.view(t, k, d).sum(dim=1, dtype=torch.float32)
    return out.to(compute).reshape(b, s, d), r.aux


def moe_apply(p: MoE, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on ``cfg.moe_impl``: ``"sorted"``, or ``"expert_tp"``,
    which without an expert group (the port has none yet: ROADMAP.md
    Queue 1 item 15, ``launch/sharding``) is the sorted path, as the
    reference's is without a mesh."""
    if cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}; want one of "
                         f"{MOE_IMPLS}")
    return moe_apply_sorted(p, x, cfg)
