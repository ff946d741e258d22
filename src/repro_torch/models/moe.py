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

Over ranks (an :class:`MoE` built with an :class:`ExpertShard`, by a
``Transformer`` built for a ``launch.mesh.ModelGrid``), a rank holds either
its experts [e0, e0 + E/m) (experts on "model") or a column block of
every expert's FFN (``expert_ff`` on "model"), and the routing runs on
tokens every model rank holds alike:

* ``"expert_tp"``, the reference's ``moe_apply_expert_tp``
  (``repro/models/moe.py:151-258``), where the experts are on "model":
  each data shard routes its own tokens with capacity ``max(int(t·k/E·cf),
  8)`` per (data shard, expert), no 128 round-up (:func:`tp_capacity`);
  each rank buckets its experts' assignments from the stable sort, runs
  them, combines in the fixed order above, and one all-reduce over the
  model group sums the ranks' parts (each cast to the compute dtype
  first, as the reference's ``psum`` sums them); the aux loss is the
  reference's pmean over the model group, then over the data group when
  the batch is split over it.
* ``"sorted"`` (and ``"expert_tp"`` wherever the reference's returns
  ``None``: experts not on "model"): the sorted path's global routing.
  Where the batch is split over the data group the ranks gather it
  first, so the capacity and the aux loss are those of the whole batch,
  as GSPMD computes them; each rank runs its share of the experts and the
  model group sums.

Trained over ranks (``launch/mesh.ModelGroup``'s gradients): the layer's
input passes ``model.enter``, so each rank's part of its gradient (its
experts', its gates') is summed over the model group; the output sum
passes its gradient through; the sorted path's gather over "data" sends
each data shard's rows their gradients from every shard's loss (a
reduce-scatter), and its aux loss, which every model rank computes alike,
passes ``model.same``; ``expert_tp``'s ``pmean`` over "model" sends back a
``m``-th of the gradient and over "data" the mean of the shards'.  The
router is whole on every rank but each rank's gradient of it is partial
(its combine weighs only its own experts' gates), so the train step sums
it over the model group (``models/transformer.grad_members``).

Where the rules put the weights' d_model dim on "data" (``two_d_weights``),
the router and the expert weights are read through ``layers.weight``,
which gathers each whole on that dim where it is used, under either
layout (experts on "model", or ``expert_ff`` on "model").  The
``shard(...)`` annotations are dropped, as in the dense port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, _empty, fill_normal_, full_shape, weight

__all__ = ["MoE", "Routing", "ExpertShard", "capacity", "tp_capacity",
           "route", "assign", "moe_apply", "moe_apply_sorted", "moe_apply_expert_tp",
           "MOE_IMPLS"]

MOE_IMPLS = ("sorted", "expert_tp")


@dataclass(frozen=True)
class ExpertShard:
    """An MoE layer's place on a ``launch.mesh.ModelGrid``: this rank holds
    experts [``lo``, ``lo + n``) (all E, with ``expert_ff`` split, when
    ``experts_on_model`` is false); ``batch_split``: the batch is split
    over the data group (the rules map "batch" to it)."""
    grid: object
    lo: int
    n: int
    experts_on_model: bool
    batch_split: bool


class MoE(nn.Module):
    """``router.w`` (d, E), always float32; ``wi`` (E, d, f), ``wo``
    (E, f, d) and, for SwiGLU, ``wg`` (E, d, f) in ``dtype``.  With
    ``shard``, ``n_experts`` and ``d_ff`` are the rank's share (the router
    stays whole)."""

    def __init__(self, d: int, d_ff: int, n_experts: int, act: str, *,
                 shard: Optional[ExpertShard] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if act not in ("swiglu", "gelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.shard = shard
        routed = n_experts * shard.grid.model.d \
            if shard is not None and shard.experts_on_model else n_experts
        self.router = Dense(d, routed, device=device, dtype=torch.float32)
        self.wi = _empty((n_experts, d, d_ff), device, dtype)
        self.wg = _empty((n_experts, d, d_ff), device, dtype) \
            if act == "swiglu" else None
        self.wo = _empty((n_experts, d_ff, d), device, dtype)

    def reset(self, generator: torch.Generator) -> None:
        """``moe_init``'s distributions: normal/√d for the router, ``wi``
        and ``wg``; normal/√f for ``wo``."""
        self.router.reset(generator)
        d, f = full_shape(self.wi)[1:]
        for w, fan_in in ((self.wi, d), (self.wg, d), (self.wo, f)):
            if w is not None:   # one float32 draw alive at a time
                fill_normal_(w, generator, 1.0 / fan_in ** 0.5)


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


def tp_capacity(t: int, cfg) -> int:
    """``moe_apply_expert_tp``'s capacity for a data shard's ``t`` tokens:
    per (data shard, expert), at least 8, no 128 round-up."""
    return max(int(t * cfg.experts_per_token / cfg.n_experts
                   * cfg.capacity_factor), 8)


def route(p: MoE, x: torch.Tensor, cfg, cap: Optional[int] = None
          ) -> Routing:
    """Route ``x`` (B, S, d) as the reference's ``moe_apply_sorted`` does
    (``cap``: another capacity than :func:`capacity`'s)."""
    b, s, d = x.shape
    k = cfg.experts_per_token
    t = b * s
    cap = capacity(t, cfg) if cap is None else cap
    logits = torch.matmul(x.reshape(t, d).float(),
                          weight(p.router.w, torch.float32))      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # top-k as lax.top_k orders it: ties to the lower index
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return assign(probs, idx[:, :k], vals[:, :k], cap)


def assign(probs: torch.Tensor, gate_idx: torch.Tensor,
           gate_vals: torch.Tensor, cap: int) -> Routing:
    """:func:`route`'s Routing from the router's ``probs`` (T, E) and each
    token's chosen experts ``gate_idx`` (T, k), best first, with their
    probabilities ``gate_vals``: the gates renormalised over the k, the
    aux loss, the stable sort by expert, the places in each expert's group
    and the capacity ``cap``'s buckets."""
    t, e = probs.shape
    k = gate_idx.shape[1]
    dev = probs.device
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


def _expert_outputs(p: MoE, xf: torch.Tensor, r: Routing, lo: int
                    ) -> torch.Tensor:
    """The held experts' FFNs on their buckets (buckets ``lo`` ...): (n, C,
    d) in ``xf``'s dtype, a bucket's empty slots zero."""
    compute = xf.dtype
    n = p.wi.shape[0]
    tok, valid = r.bucket_tok[lo:lo + n], r.bucket_valid[lo:lo + n]
    xe = xf[tok] * valid[..., None].to(compute)                   # (n, C, d)
    h = torch.bmm(xe, weight(p.wi, compute))
    if p.wg is not None:
        h = F.silu(torch.bmm(xe, weight(p.wg, compute))) * h
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    return torch.bmm(h, weight(p.wo, compute))


def _combine(ye: torch.Tensor, r: Routing, lo: int, t: int, k: int
             ) -> torch.Tensor:
    """Each token's kept slots on experts [lo, lo + len(ye)), weighted by
    their gates and summed in float32 in slot order -> (T, d) in ``ye``'s
    dtype."""
    compute, cap, d = ye.dtype, r.capacity, ye.shape[-1]
    mine = r.keep
    if lo or ye.shape[0] < r.bucket_tok.shape[0]:
        mine = mine & (r.expert >= lo) & (r.expert < lo + ye.shape[0])
    # each assignment's bucket row and weight, back in (token, slot) order
    assign_bucket = torch.where(mine, (r.expert - lo) * cap +
                                torch.clamp(r.rank, max=cap - 1), 0)
    inv = torch.empty_like(r.order)
    inv[r.order] = torch.arange(t * k, device=ye.device)
    weight = (r.gate * mine)[inv]
    contrib = ye.reshape(-1, d)[assign_bucket[inv]] * \
        weight[:, None].to(compute)
    out = contrib.view(t, k, d).sum(dim=1, dtype=torch.float32)
    return out.to(compute)


def moe_apply_sorted(p: MoE, x: torch.Tensor, cfg
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out in x's dtype, aux loss float32)."""
    b, s, d = x.shape
    sh = p.shard
    split = sh is not None and sh.batch_split and sh.grid.data.d > 1
    if split:                       # route the whole batch
        x = sh.grid.data.all_gather_dim(x, 0, own_loss=True)
    if sh is not None:
        x = sh.grid.model.enter(x)
    t, k = x.shape[0] * s, cfg.experts_per_token
    r = route(p, x, cfg)
    lo = sh.lo if sh is not None and sh.experts_on_model else 0
    out = _combine(_expert_outputs(p, x.reshape(t, d), r, lo), r, lo, t, k)
    aux = r.aux
    if sh is not None:
        out = sh.grid.model.psum(out)
        aux = sh.grid.model.same(aux)
    if split:                       # this data shard's rows
        out = out.view(sh.grid.data.d, b * s, d)[sh.grid.data.rank]
    return out.reshape(b, s, d), aux


def moe_apply_expert_tp(p: MoE, x: torch.Tensor, cfg
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``moe_apply_expert_tp`` on a layer whose experts are
    on "model" (module docstring); x: (B, S, d), this data shard's tokens
    -> (out in x's dtype, aux float32, equal on every rank)."""
    sh = p.shard
    b, s, d = x.shape
    t, k = b * s, cfg.experts_per_token
    x = sh.grid.model.enter(x)
    r = route(p, x, cfg, tp_capacity(t, cfg))
    out = _combine(_expert_outputs(p, x.reshape(t, d), r, sh.lo), r, sh.lo,
                   t, k)
    out = sh.grid.model.psum(out)
    aux = sh.grid.model.pmean(r.aux)
    if sh.batch_split:
        aux = sh.grid.data.pmean(aux, own_loss=True)
    return out.reshape(b, s, d), aux


def moe_apply(p: MoE, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on ``cfg.moe_impl``: ``"sorted"``, or ``"expert_tp"``, which
    runs the sorted path where the reference's returns ``None``: no grid
    (the reference's: no mesh), or the experts not on "model"."""
    if cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}; want one of "
                         f"{MOE_IMPLS}")
    if cfg.moe_impl == "expert_tp" and p.shard is not None and \
            p.shard.experts_on_model:
        return moe_apply_expert_tp(p, x, cfg)
    return moe_apply_sorted(p, x, cfg)
