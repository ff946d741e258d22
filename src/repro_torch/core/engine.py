"""Layer 2 of the traversal engine: backend-dispatched push/pull.

Counterpart of ``repro/core/engine.py:152-397, 641-895``:

    core/graph.py       Graph         static-shape dual-CSR storage
        |  .plan()  (identity-memoized)
        v
    core/plan.py        GraphPlan     sorted edges, degrees, oriented
        |                             adjacency, BSR tiles, chunk layouts
        v
    core/engine.py      Exec          gather + segment-reduce primitives
        |   push / pull / fixpoint    with backend dispatch:
        |                               "xla"    sorted segmented reductions
        |                               "pallas" kernel K2 (sum reductions)
        v                               "bsr"    kernel K1 (fused pulls/pushes)
    core/algorithms.py  pagerank, hits, connected_components, triangle_count

The backend names are the reference's, so one parity test runs over both
packages; a name means the same data layout and fallback rules, not the
same hardware.  A (combine, dtype, ndim) cell a backend does not serve falls
back to the "xla" primitives, so backend choice never changes semantics:

    backend    pull/push sum      min/max     weighted    batched
    "xla"      segment reduce     yes         yes         yes
    "pallas"   kernel K2          fallback    yes (f32)   fallback
    "bsr"      kernel K1          fallback    fallback    fallback

``fixpoint`` iterates a body a fixed number of rounds, until the state
stops changing, or until the L1 residual drops to ``tol``: a Python loop in
place of the reference's ``fori_loop`` / ``while_loop``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from ..kernels.bsr_spmv import bsr_spmv
from ..kernels.segment_sum import (DEFAULT_BLOCK, DEFAULT_CHUNK,
                                   segment_sum_chunked)

__all__ = ["BACKENDS", "select_backend", "get_exec", "push", "pull",
           "fixpoint", "XlaExec", "PallasExec", "BsrExec"]

BACKENDS = ("xla", "pallas", "bsr", "frontier", "sharded")

# backends of the reference that later slices port (ROADMAP.md Queue 1)
_NOT_PORTED = {"frontier": "Queue 1 item 7", "sharded": "Queue 1 item 14"}


def select_backend(plan, backend: Optional[str] = None) -> str:
    """Resolve the backend: an explicit choice, else ``"xla"``.

    ``None`` takes the reference's non-TPU rule.  No H100 measurement yet
    says when the kernels beat the plain reductions, so they run only when
    asked for.
    """
    if backend is None:
        return "xla"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of {BACKENDS}")
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (ROADMAP.md "
            f"{_NOT_PORTED[backend]})")
    return backend


# ---------------------------------------------------------------------------
# segmented reductions over sorted segment ids
# ---------------------------------------------------------------------------


def _identity(dtype: torch.dtype, combine: str):
    """Empty-segment value of ``jax.ops.segment_min`` / ``segment_max``."""
    if dtype.is_floating_point:
        return float("inf") if combine == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if combine == "min" else info.min


def _segment_reduce(vals: torch.Tensor, seg: torch.Tensor,
                    lengths: torch.Tensor, n: int,
                    combine: str) -> torch.Tensor:
    """Reduce edge-order ``vals`` into ``n`` segments; ``seg`` is sorted and
    ``lengths`` holds each segment's run length (its CSR degree).

    Float sums run segment by segment in edge order (``segment_reduce``
    over the lengths), never through CUDA ``index_add_``, whose atomics
    change the order from run to run.  Integer sums are exact in any order;
    min and max do not depend on order.
    """
    if combine not in ("sum", "min", "max"):
        raise ValueError(f"unknown combine {combine!r}")
    if combine == "sum" and vals.is_floating_point():
        return torch.segment_reduce(vals, "sum", lengths=lengths, axis=0,
                                    unsafe=True)
    shape = (n,) + tuple(vals.shape[1:])
    idx = seg.long()
    if combine == "sum":
        return torch.zeros(shape, dtype=vals.dtype,
                           device=vals.device).index_add_(0, idx, vals)
    idx = idx.view((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    out = torch.full(shape, _identity(vals.dtype, combine), dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(0, idx, vals, "amin" if combine == "min"
                               else "amax")


# ---------------------------------------------------------------------------
# Exec objects — one per backend
# ---------------------------------------------------------------------------


@dataclass
class XlaExec:
    """Traversal primitives over plan arrays; plain sorted reductions."""

    n_nodes: int
    n_edges: int
    in_src: torch.Tensor    # in-edge order = sorted by dst (pull order)
    in_dst: torch.Tensor
    out_src: torch.Tensor   # out-edge order = sorted by src (push order)
    out_dst: torch.Tensor
    in_len: torch.Tensor    # int64 in-degrees: run lengths of in_dst
    out_len: torch.Tensor   # int64 out-degrees: run lengths of out_src

    # -- edge-order gathers -----------------------------------------------------
    def in_src_vals(self, x: torch.Tensor) -> torch.Tensor:
        return x.index_select(0, self.in_src)

    def out_dst_vals(self, x: torch.Tensor) -> torch.Tensor:
        return x.index_select(0, self.out_dst)

    # -- segmented reductions ---------------------------------------------------
    def reduce_in(self, edge_vals: torch.Tensor,
                  combine: str = "sum") -> torch.Tensor:
        """Per-destination reduction of in-edge-order values."""
        return _segment_reduce(edge_vals, self.in_dst, self.in_len,
                               self.n_nodes, combine)

    def reduce_out(self, edge_vals: torch.Tensor,
                   combine: str = "sum") -> torch.Tensor:
        """Per-source reduction of out-edge-order values."""
        return _segment_reduce(edge_vals, self.out_src, self.out_len,
                               self.n_nodes, combine)

    # -- fused traversal primitives ---------------------------------------------
    def pull(self, x: torch.Tensor, combine: str = "sum",
             edge_values: Optional[torch.Tensor] = None,
             edge_op: str = "mul") -> torch.Tensor:
        """out[v] = combine over in-edges (u -> v) of x[u] (o edge_values)."""
        ev = self.in_src_vals(x)
        if edge_values is not None:
            ev = ev * edge_values if edge_op == "mul" else ev + edge_values
        return self.reduce_in(ev, combine)

    def push(self, x: torch.Tensor, combine: str = "sum",
             edge_values: Optional[torch.Tensor] = None,
             edge_op: str = "mul") -> torch.Tensor:
        """out[u] = combine over out-edges (u -> v) of x[v] (o edge_values)."""
        ev = self.out_dst_vals(x)
        if edge_values is not None:
            ev = ev * edge_values if edge_op == "mul" else ev + edge_values
        return self.reduce_out(ev, combine)


def _kernel_sum(combine: str, x: torch.Tensor) -> bool:
    """Whether a reduction takes a backend's kernel: 1-D float sums only.

    Non-sum, batched and integer reductions fall back, since the f32
    kernels would change exactness or dtype.
    """
    return combine == "sum" and x.dim() == 1 and x.is_floating_point()


@dataclass
class PallasExec(XlaExec):
    """Sum reductions through kernel K2 over the plan's chunk layouts.

    The chunk structure (which edge lands in which chunk and slot) is
    static per graph; each reduction scatters fresh values into a zeroed
    (C, L) buffer.  Every edge has its own slot, so the scatter is a plain
    indexed write with no collisions.
    """

    p_pos: torch.Tensor = None     # pull layout: (E,) int64 chunk*L + slot
    p_lids: torch.Tensor = None    # (C, L) local ids, pad = 128
    p_blk: torch.Tensor = None     # (C,) owning output block
    q_pos: torch.Tensor = None     # push layout (over out_src)
    q_lids: torch.Tensor = None
    q_blk: torch.Tensor = None
    nb_in: int = 0
    nb_out: int = 0

    def _chunked_sum(self, edge_vals, pos, lids, blk, nb):
        cvals = torch.zeros(lids.shape, dtype=torch.float32,
                            device=edge_vals.device)
        cvals.view(-1)[pos] = edge_vals.to(torch.float32)
        out = segment_sum_chunked(cvals, lids, blk, nb)
        return out.reshape(-1)[: self.n_nodes]

    def reduce_in(self, edge_vals, combine="sum"):
        if not _kernel_sum(combine, edge_vals):
            return super().reduce_in(edge_vals, combine)
        return self._chunked_sum(edge_vals, self.p_pos, self.p_lids,
                                 self.p_blk, self.nb_in)

    def reduce_out(self, edge_vals, combine="sum"):
        if not _kernel_sum(combine, edge_vals):
            return super().reduce_out(edge_vals, combine)
        return self._chunked_sum(edge_vals, self.q_pos, self.q_lids,
                                 self.q_blk, self.nb_out)


@dataclass
class BsrExec(XlaExec):
    """Fused gather+sum pulls and pushes as kernel K1 over BSR tiles.

    ``pull(x, "sum")`` is ``M @ x`` with M[dst, src] = 1; ``push(x, "sum")``
    is ``Mᵀ @ x`` over the transpose tile stream (``plan.bsr_t``).
    Min/max, weighted and batched reductions fall back to "xla".
    """

    tiles: torch.Tensor = None
    rows: torch.Tensor = None
    cols: torch.Tensor = None
    tiles_t: torch.Tensor = None   # transpose stream: M[src, dst]
    rows_t: torch.Tensor = None
    cols_t: torch.Tensor = None
    nb: int = 0
    block: int = DEFAULT_BLOCK

    def _spmv(self, tiles, rows, cols, x):
        nb, b = self.nb, self.block
        xp = torch.zeros((nb * b,), dtype=torch.float32, device=x.device)
        xp[: self.n_nodes] = x.to(torch.float32)
        y = bsr_spmv(tiles, rows, cols, xp.view(nb, b), nb)
        return y.reshape(-1)[: self.n_nodes]

    def pull(self, x, combine="sum", edge_values=None, edge_op="mul"):
        if edge_values is not None or not _kernel_sum(combine, x):
            return super().pull(x, combine, edge_values, edge_op)
        return self._spmv(self.tiles, self.rows, self.cols, x)

    def push(self, x, combine="sum", edge_values=None, edge_op="mul"):
        if edge_values is not None or not _kernel_sum(combine, x):
            return super().push(x, combine, edge_values, edge_op)
        return self._spmv(self.tiles_t, self.rows_t, self.cols_t, x)


# ---------------------------------------------------------------------------
# exec construction (cached on the plan)
# ---------------------------------------------------------------------------


def _flat_pos(chunk_of: torch.Tensor, slot_of: torch.Tensor,
              chunk: int) -> torch.Tensor:
    """Each edge's slot in the flattened (C, L) chunk buffer."""
    return chunk_of.long() * chunk + slot_of.long()


def get_exec(plan, backend: Optional[str] = None, *,
             block: int = DEFAULT_BLOCK,
             chunk: int = DEFAULT_CHUNK) -> XlaExec:
    """Backend Exec for a :class:`GraphPlan`, memoized on the plan."""
    backend = select_backend(plan, backend)
    if plan.n_nodes == 0:
        backend = "xla"   # degenerate: the re-blocked kernels have no rows
    key = (backend, block, chunk)
    ex = plan.execs.get(key)
    if ex is not None:
        return ex
    base = (plan.n_nodes, plan.n_edges, plan.in_src, plan.in_dst,
            plan.out_src, plan.out_dst, plan.in_deg.long(),
            plan.out_deg.long())
    if backend == "xla":
        ex = XlaExec(*base)
    elif backend == "pallas":
        p_chunk, p_slot, p_lids, p_blk, nb_in, _ = plan.chunk_layout_in(chunk)
        q_chunk, q_slot, q_lids, q_blk, nb_out, _ = plan.chunk_layout_out(chunk)
        ex = PallasExec(*base, _flat_pos(p_chunk, p_slot, chunk), p_lids,
                        p_blk, _flat_pos(q_chunk, q_slot, chunk), q_lids,
                        q_blk, nb_in=nb_in, nb_out=nb_out)
    else:
        tiles, rows, cols, nb = plan.bsr(block)
        tiles_t, rows_t, cols_t, _ = plan.bsr_t(block)
        ex = BsrExec(*base, tiles, rows, cols, tiles_t, rows_t, cols_t,
                     nb=nb, block=block)
    plan.execs[key] = ex
    return ex


def pull(plan, values: torch.Tensor, combine: str = "sum", *,
         backend: Optional[str] = None,
         edge_values: Optional[torch.Tensor] = None, edge_op: str = "mul",
         **exec_kw) -> torch.Tensor:
    """Module-level convenience: ``get_exec(plan, backend).pull(...)``."""
    return get_exec(plan, backend, **exec_kw).pull(values, combine,
                                                   edge_values, edge_op)


def push(plan, values: torch.Tensor, combine: str = "sum", *,
         backend: Optional[str] = None,
         edge_values: Optional[torch.Tensor] = None, edge_op: str = "mul",
         **exec_kw) -> torch.Tensor:
    """Module-level convenience: ``get_exec(plan, backend).push(...)``."""
    return get_exec(plan, backend, **exec_kw).push(values, combine,
                                                   edge_values, edge_op)


# ---------------------------------------------------------------------------
# fixpoint driver
# ---------------------------------------------------------------------------


def _leaves(state):
    return list(state) if isinstance(state, (tuple, list)) else [state]


def _changed(old, new) -> torch.Tensor:
    """Whether any leaf changed; a NaN that stays NaN counts as converged."""
    flag = None
    for o, n in zip(_leaves(old), _leaves(new)):
        neq = o != n
        if o.is_floating_point():
            neq = neq & ~(torch.isnan(o) & torch.isnan(n))
        flag = neq.any() if flag is None else flag | neq.any()
    return flag


def _residual(old, new) -> torch.Tensor:
    """L1 residual between two states (f32 accumulation)."""
    return sum((n.to(torch.float32) - o.to(torch.float32)).abs().sum()
               for o, n in zip(_leaves(old), _leaves(new)))


def fixpoint(plan_or_exec, body: Callable, init, *,
             n_iter: Optional[int] = None, max_iter: Optional[int] = None,
             tol: Optional[float] = None,
             backend: Optional[str] = None, args: Tuple = ()):
    """Iterate ``body(exec, state, *args) -> state`` on the engine.

    With ``n_iter``: exactly that many rounds.  With ``tol``: until the L1
    residual between consecutive states drops to ``tol``, capped at
    ``max_iter``.  Otherwise: until the state stops changing, capped at
    ``max_iter``.  The two convergence modes read one flag from the device
    each round (the reference keeps the test inside a ``while_loop``); that
    host sync per round is accepted in this slice.
    """
    ex = (plan_or_exec if isinstance(plan_or_exec, XlaExec)
          else get_exec(plan_or_exec, backend))
    state = init
    if n_iter is not None and tol is None:
        for _ in range(int(n_iter)):
            state = body(ex, state, *args)
        return state
    cap = (1 << 31) - 1 if max_iter is None else int(max_iter)
    i = 0
    while i < cap:
        new = body(ex, state, *args)
        i += 1
        if tol is not None:
            go = float(_residual(state, new)) > tol
        else:
            go = bool(_changed(state, new))
        state = new
        if not go:
            break
    return state
