"""Layer 2 of the traversal engine: backend-dispatched push/pull.

Counterpart of ``repro/core/engine.py:133-430, 641-1091``:

    core/graph.py       Graph         static-shape dual-CSR storage
        |  .plan()  (identity-memoized)
        v
    core/plan.py        GraphPlan     sorted edges, degrees, oriented
        |                             adjacency, BSR tiles, chunk layouts,
        |                             frontier CSR
        v
    core/engine.py      Exec          gather + segment-reduce primitives
        |   push / pull / fixpoint    with backend dispatch:
        |   frontier_fixpoint           "xla"      sorted segmented reductions
        |                               "pallas"   kernel K2 (sum reductions)
        |                               "bsr"      kernel K1 (fused pulls/pushes)
        |                               "frontier" compacted-frontier
        v                                          relaxation (monotone min)
    core/algorithms.py  pagerank, hits, eigenvector centrality, PPR, CC,
                        SCC, sssp/bfs, k-core, label propagation, triangles

The backend names are the reference's, so one parity test runs over both
packages; a name means the same data layout and fallback rules, not the
same hardware.  A (combine, dtype, ndim) cell a backend does not serve falls
back to the "xla" primitives, so backend choice never changes semantics:

    backend    pull/push sum      min/max     weighted    batched   frontier
    "xla"      segment reduce     yes         yes         yes       —
    "pallas"   kernel K2          fallback    yes (f32)   fallback  —
    "bsr"      kernel K1          fallback    fallback    fallback  —
    "frontier" fallback (xla)     fallback    —           —         sparse

``fixpoint`` iterates a body a fixed number of rounds, until the state
stops changing, or until the L1 residual drops to ``tol``: a Python loop in
place of the reference's ``fori_loop`` / ``while_loop``.

``frontier_fixpoint`` is its sparse dual for monotone min-relaxations
(BFS / SSSP / min-label propagation): each round relaxes only the out-edges
of the vertices whose value changed last round, gathered from the plan's
CSR through a compacted index array, and switches to a dense pull over all
in-edges once the frontier's out-edges reach a quarter of |E|.  For a
monotone relaxation the two are equal round for round, so the result is
the dense backends' bit for bit.

``select_backend(plan, backend, op=...)`` resolves an explicit backend,
then ``REPRO_ENGINE_BACKEND``, then the size rule; an op a backend has no
path for (``_FRONTIER_OPS`` for "frontier") resolves to "xla".
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..kernels.bsr_spmv import bsr_spmv
from ..kernels.segment_sum import (DEFAULT_BLOCK, DEFAULT_CHUNK,
                                   segment_sum_chunked)
from .table import next_capacity

__all__ = ["BACKENDS", "select_backend", "backend_supports", "get_exec",
           "push", "pull", "fixpoint", "frontier_fixpoint", "XlaExec",
           "PallasExec", "BsrExec", "FrontierExec"]

BACKENDS = ("xla", "pallas", "bsr", "frontier", "sharded")

# backends of the reference that later slices port (ROADMAP.md Queue 1)
_NOT_PORTED = {"sharded": "Queue 1 item 14"}

# below this the frontier path's per-round host read outweighs the edge
# relaxations it saves (the reference's threshold, from a CPU measurement;
# no H100 measurement has replaced it)
_FRONTIER_MIN_EDGES = 1 << 15
# ops auto-routed to "frontier" on large graphs: single-source traversals
# only (a batch's union frontier densifies fast; CC's dense body
# pointer-jumps in O(log n) rounds), so algorithms pass these op tags only
# for single-source calls
_FRONTIER_AUTO_OPS = frozenset({"bfs", "sssp"})
# ops with a sparse monotone-relaxation formulation; any other op on
# "frontier" resolves to "xla" (same results, dense speed)
_FRONTIER_OPS = frozenset({"bfs", "sssp", "connected_components",
                           "label_propagation"})


def backend_supports(backend: str, op: Optional[str]) -> bool:
    """Whether ``backend`` has a dedicated path for ``op`` (None = generic)."""
    if backend == "frontier" and op is not None:
        return op in _FRONTIER_OPS
    return True


def select_backend(plan, backend: Optional[str] = None,
                   op: Optional[str] = None) -> str:
    """Resolve the backend: per-call override > ``REPRO_ENGINE_BACKEND`` >
    size rule.

    The size rule is the reference's off-TPU one: single-source ``bfs`` and
    ``sssp`` on graphs of at least 2^15 edges take ``"frontier"``,
    everything else ``"xla"``.  No H100 measurement yet says when the
    kernels beat the plain reductions, so they run only when asked for.
    ``op`` (an algorithm name) resolves a backend without a path for it to
    ``"xla"``, so the call succeeds with the same results.
    """
    if backend is None:
        env = os.environ.get("REPRO_ENGINE_BACKEND")
        if env:
            return select_backend(plan, env, op)
        if op in _FRONTIER_AUTO_OPS and plan.n_edges >= _FRONTIER_MIN_EDGES:
            return "frontier"
        return "xla"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of {BACKENDS}")
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (ROADMAP.md "
            f"{_NOT_PORTED[backend]})")
    return backend if backend_supports(backend, op) else "xla"


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

    def in_dst_vals(self, x: torch.Tensor) -> torch.Tensor:
        return x.index_select(0, self.in_dst)

    def out_src_vals(self, x: torch.Tensor) -> torch.Tensor:
        return x.index_select(0, self.out_src)

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


@dataclass
class FrontierExec(XlaExec):
    """CSR-slice gathers for :func:`frontier_fixpoint`.

    Generic ``pull``/``push`` inherit the "xla" reductions (the fallback
    for ops without a sparse formulation); the frontier state is the
    plan's trimmed out-CSR and ``w_perm``, the in-order -> out-order weight
    permutation.
    """

    out_ptr: torch.Tensor = None   # (n+1,) trimmed row pointers
    adj: torch.Tensor = None       # capacity-padded out-neighbour array
    deg_pad: torch.Tensor = None   # (n+1,) out-degrees, sentinel row n = 0
    w_perm: torch.Tensor = None    # (E,) in-order position of each out edge


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
    elif backend == "frontier":
        ptr, idx, deg_pad = plan.csr_out()
        ex = FrontierExec(*base, ptr, idx, deg_pad, plan.in_perm_out())
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


# ---------------------------------------------------------------------------
# frontier fixpoint — sparse monotone min-relaxation
# ---------------------------------------------------------------------------

# direction-optimization switch: dense pull once the frontier's out-edges
# reach |E| / _DENSE_EDGE_DIV (the dense round costs ~|E|, the sparse round
# ~frontier edges plus compaction)
_DENSE_EDGE_DIV = 4
_MIN_BUCKET = 16


def _stats_of(mask: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """(frontier size, frontier out-edge count): the host's planning pair."""
    return torch.stack([mask.sum(), torch.where(mask, deg, 0).sum()])


def _frontier_round_out(ex, state, new, caps, t):
    """Shared step epilogue: freeze capped rows; next mask and its stats."""
    new = torch.where((t < caps)[:, None], new, state)
    mask = (new < state).any(dim=0)
    return new, mask, _stats_of(mask, ex.deg_pad[: ex.n_nodes])


def _frontier_push_step(ex, state, f_idx, w_out, caps, t, e_budget):
    """One sparse push round over the compacted frontier.

    ``f_idx`` is the frontier padded with the sentinel vertex ``n`` (degree
    0 in ``deg_pad``, so pad slots own no edge lanes); ``e_budget`` lanes
    (a bucketed power of two >= the frontier's out-edges) each find their
    frontier slot by a prefix-sum search, gather the neighbour from the
    CSR and scatter-min ``state[u] (+ w)`` into its column.  Min does not
    depend on order, so the scatter gives the same bits on every run.
    """
    n = ex.n_nodes
    k = state.shape[0]
    deg = ex.deg_pad[f_idx]
    off = ex.out_ptr[f_idx]
    cum = torch.cumsum(deg, 0) - deg                    # exclusive prefix
    total = deg.sum()
    j = torch.arange(e_budget, dtype=cum.dtype, device=state.device)
    owner = torch.clamp(torch.searchsorted(cum, j, right=True) - 1,
                        0, f_idx.shape[0] - 1)
    # lanes past the frontier's edges clamp to a real edge and write to
    # the sentinel column n
    pos = torch.clamp(off[owner] + (j - cum[owner]), 0, ex.n_edges - 1)
    v = torch.where(j < total, ex.adj[pos].long(), n)
    cand = state[:, torch.clamp(f_idx[owner], max=n - 1)]
    if w_out is not None:
        # scalar = uniform hop; array = per-edge, already in out order
        cand = cand + (w_out if w_out.dim() == 0 else w_out[pos])
    new = torch.nn.functional.pad(state, (0, 1)).scatter_reduce_(
        1, v.expand(k, -1), cand, "amin", include_self=True)[:, :n]
    return _frontier_round_out(ex, state, new, caps, t)


def _frontier_dense_step(ex, state, w_in, caps, t):
    """One dense pull round (the direction-optimized big-frontier path).

    Equal to the sparse push round for round: re-relaxing an edge whose
    source did not change last round is a no-op for a monotone min.
    """
    relaxed = torch.stack([ex.pull(s, "min", w_in, "add") for s in state])
    return _frontier_round_out(ex, state, torch.minimum(state, relaxed),
                               caps, t)


def frontier_fixpoint(plan_or_exec, init, frontier, *,
                      weights=None, caps=None) -> torch.Tensor:
    """Sparse monotone min-relaxation to fixpoint (BFS / SSSP / min-label).

    Iterates ``state[v] <- min(state[v], min over frontier in-neighbours u
    of state[u] (+ w(u, v)))``, where the frontier is the set of vertices
    whose value changed last round, until the frontier empties or every
    row reaches its cap.  ``init`` is ``(n,)`` or batched ``(k, n)``;
    ``frontier`` an ``(n,)`` bool mask seeding round 0 (batched: the union
    over rows).
    ``weights`` is a scalar hop or per-edge in in-edge order (the sssp
    convention), re-keyed to out order through ``w_perm``.  ``caps``
    (scalar or ``(k,)``) freezes row ``i`` after ``caps[i]`` rounds: the
    same as running that row alone for ``caps[i]`` rounds.

    The host plans each round from one read of the (frontier size,
    frontier out-edges) pair; everything else stays on the device.
    ``frontier_fixpoint.rounds`` and ``.dense_rounds`` count the rounds run
    and those that took the dense pull.
    """
    ex = (plan_or_exec if isinstance(plan_or_exec, FrontierExec)
          else get_exec(plan_or_exec, "frontier"))
    dev = ex.in_src.device
    init = torch.as_tensor(init, device=dev)
    batched = init.dim() == 2
    state = init if batched else init[None, :]
    k, n = state.shape
    if n == 0 or k == 0 or ex.n_edges == 0:
        return init                     # no edges: nothing can relax
    w_in = w_out = None
    if weights is not None:
        w_in = torch.as_tensor(weights, device=dev)
        w_out = w_in if w_in.dim() == 0 else w_in[ex.w_perm]
    big = int(np.iinfo(np.int32).max)
    if caps is None:          # made on the device: no copy, no host sync
        caps_t = torch.full((k,), big, dtype=torch.int64, device=dev)
        bound = big
    else:
        caps_np = np.minimum(np.broadcast_to(np.atleast_1d(
            np.asarray(caps, dtype=np.int64)), (k,)), big)
        caps_t = torch.from_numpy(caps_np).to(dev)
        bound = int(caps_np.max())

    mask = torch.as_tensor(frontier, dtype=torch.bool, device=dev)
    stats = _stats_of(mask, ex.deg_pad[:n])
    t = 0
    while t < bound:
        cnt, fe = stats.tolist()          # the one host read of the round
        if cnt == 0:
            break
        frontier_fixpoint.rounds += 1
        if fe * _DENSE_EDGE_DIV >= ex.n_edges:
            frontier_fixpoint.dense_rounds += 1
            state, mask, stats = _frontier_dense_step(ex, state, w_in,
                                                      caps_t, t)
        else:
            b = min(next_capacity(cnt, minimum=_MIN_BUCKET),
                    next_capacity(max(n, 1)))
            f_idx = torch.nonzero_static(mask, size=b, fill_value=n)[:, 0]
            eb = next_capacity(max(fe, 1), minimum=_MIN_BUCKET)
            state, mask, stats = _frontier_push_step(ex, state, f_idx, w_out,
                                                     caps_t, t, eb)
        t += 1
    return state if batched else state[0]


frontier_fixpoint.rounds = 0
frontier_fixpoint.dense_rounds = 0
