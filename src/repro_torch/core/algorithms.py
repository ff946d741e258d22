"""Graph algorithms (Ringo §2.2/§3, paper Tables 3 and 6) on the engine.

Counterpart of ``repro/core/algorithms.py`` except its ``incremental_*``
analytics: each algorithm is a thin composition over the plan and the
engine, so a backend's kernel serves every algorithm at once.  Every
algorithm that takes ``backend=`` resolves it with
``engine.select_backend`` and runs on the device of the graph's tensors;
results are per-node tensors in the graph's dense id space.

Batched (multi-source) ``sssp``, ``bfs``, ``personalized_pagerank`` and
``closeness_centrality`` run row by row through the 1-D fixpoint on the
dense backends (the reference ``vmap``s it), so row i equals a standalone
call on the same backend, through the same kernels; on ``"frontier"`` the
rows relax together in one ``(k, n)`` state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import engine
from .graph import Graph
from ..kernels.bsr_tricount import bsr_tricount

__all__ = [
    "pagerank",
    "personalized_pagerank",
    "triangle_count",
    "per_node_triangles",
    "clustering_coefficient",
    "connected_components",
    "strongly_connected_components",
    "sssp",
    "bfs",
    "k_core",
    "core_numbers",
    "hits",
    "degree_histogram",
    "degree_centrality",
    "eigenvector_centrality",
    "label_propagation",
    "closeness_centrality",
]

_I32 = torch.int32
_F32 = torch.float32
_INF = float("inf")


def _exec_for(g: Graph, backend: Optional[str]):
    plan = g.plan()
    return plan, engine.get_exec(plan, backend)


def _sources(g: Graph, source) -> Tuple[bool, torch.Tensor]:
    """(scalar?, (k,) int64 sources on the graph's device)."""
    src = torch.as_tensor(source, device=g.device)
    return src.dim() == 0, src.reshape(-1).long()


def _undirected_presence(g: Graph, u: Graph):
    """(pos, present): where each g-node lands in the undirected view.

    ``to_undirected`` rebuilds the node set from edge endpoints, so vertices
    of ``g`` with no non-loop edges are absent from ``u``; indexing ``u``'s
    results by ``u.dense_of`` alone would read a neighbour's slot for them.
    """
    orig = g.node_ids[: g.n_nodes]
    pos = torch.clamp(u.dense_of(orig), 0, u.n_nodes - 1).long()
    return pos, u.node_ids[pos] == orig


def _undirected_values_to_g(g: Graph, u: Graph, vals: torch.Tensor,
                            missing) -> torch.Tensor:
    """Per-node values on the undirected view -> g's id space; vertices
    absent from ``u`` get ``missing``."""
    if g.n_nodes == 0:
        return vals[:0]
    if u.n_nodes == 0:
        return torch.full((g.n_nodes,), missing, dtype=vals.dtype,
                          device=g.device)
    pos, present = _undirected_presence(g, u)
    return torch.where(present, vals[pos], missing)


def _undirected_ids_to_g(g: Graph, u: Graph,
                         labels: torch.Tensor) -> torch.Tensor:
    """Id-valued results (CC / LP labels are u-dense ids) -> g-dense ids.

    Both dense numberings ascend with original id, so min-id semantics
    survive; vertices absent from ``u`` label themselves.
    """
    own = torch.arange(g.n_nodes, dtype=_I32, device=g.device)
    if g.n_nodes == 0 or u.n_nodes == 0:
        return own
    pos, present = _undirected_presence(g, u)
    lab_g = g.dense_of(u.original_of(labels))
    return torch.where(present, lab_g[pos], own)


# ---------------------------------------------------------------------------
# PageRank (paper Table 3: 10 iterations on LiveJournal / Twitter2010)
# ---------------------------------------------------------------------------


def _pagerank_body(ex, pr, damping, inv_deg, dangling):
    n = ex.n_nodes
    summed = ex.pull(pr * inv_deg, "sum")        # rank mass along in-edges
    dang = torch.where(dangling, pr, torch.zeros_like(pr)).sum()
    return (1.0 - damping) / n + damping * (summed + dang / n)


def pagerank(g: Graph, n_iter: int = 10, damping: float = 0.85, *,
             tol: Optional[float] = None,
             init: Optional[torch.Tensor] = None,
             backend: Optional[str] = None) -> torch.Tensor:
    """Power-iteration PageRank with dangling-mass redistribution.

    The SpMV inner loop is ``engine.pull(pr * inv_deg, "sum")``: kernel K1
    on "bsr", kernel K2 on "pallas", a sorted segmented reduction on "xla".
    With ``tol`` set, ``n_iter`` is ignored and the iteration runs until the
    L1 residual between rounds drops to ``tol``; ``init`` seeds the iterate
    (default: uniform).
    """
    f32 = torch.float32
    if g.n_nodes == 0:
        return torch.zeros((0,), dtype=f32, device=g.device)
    plan, ex = _exec_for(g, backend)
    pr0 = (torch.as_tensor(init, dtype=f32, device=g.device)
           if init is not None
           else torch.full((g.n_nodes,), 1.0 / g.n_nodes, dtype=f32,
                           device=g.device))
    # damping as an f32 scalar, so (1 - d) / n rounds as the reference's does
    args = (torch.tensor(damping, dtype=f32, device=g.device),
            plan.inv_out_deg, plan.dangling)
    if tol is not None:
        return engine.fixpoint(ex, _pagerank_body, pr0, tol=float(tol),
                               max_iter=10_000, args=args)
    return engine.fixpoint(ex, _pagerank_body, pr0, n_iter=n_iter, args=args)


def _source_caps(k: int, n_iter) -> Optional[np.ndarray]:
    """Broadcast a scalar or per-source round limit to one cap per source."""
    if n_iter is None:
        return None
    return np.broadcast_to(np.atleast_1d(np.asarray(n_iter, np.int32)), (k,))


def _stack_rows(rows, n: int, device) -> torch.Tensor:
    return (torch.stack(rows) if rows
            else torch.zeros((0, n), dtype=_F32, device=device))


def _ppr_body(ex, pr, damping, inv_deg, dangling, restart):
    summed = ex.pull(pr * inv_deg, "sum")
    dang = torch.where(dangling, pr, torch.zeros_like(pr)).sum()
    return (1.0 - damping) * restart + damping * (summed + dang * restart)


def personalized_pagerank(g: Graph, source, n_iter=10, damping: float = 0.85,
                          *, tol: Optional[float] = None,
                          init: Optional[torch.Tensor] = None,
                          backend: Optional[str] = None) -> torch.Tensor:
    """Random-walk-with-restart PageRank personalized to ``source``.

    Teleport and dangling mass both return to the restart distribution (a
    one-hot at the source).  ``source`` may be a scalar (returns ``(n,)``)
    or k sources (returns ``(k, n)``); ``n_iter`` may be a ``(k,)`` array
    of per-source round counts.  ``tol``/``init`` mirror :func:`pagerank`:
    each row runs to its own L1-residual convergence from its ``init`` row
    (default: the restart distribution).
    """
    n = g.n_nodes
    if n == 0:
        return torch.zeros((0,), dtype=_F32, device=g.device)
    plan, ex = _exec_for(g, backend)
    scalar, sources = _sources(g, source)
    k = int(sources.shape[0])
    args = (torch.tensor(damping, dtype=_F32, device=g.device),
            plan.inv_out_deg, plan.dangling)
    caps = _source_caps(k, n_iter)
    init_rows = None if init is None else torch.atleast_2d(
        torch.as_tensor(init, dtype=_F32, device=g.device))
    rows = []
    for i in range(k):
        restart = torch.zeros((n,), dtype=_F32, device=g.device
                              ).index_fill_(0, sources[i:i + 1], 1.0)
        if tol is None:
            rows.append(engine.fixpoint(ex, _ppr_body, restart,
                                        n_iter=int(caps[i]),
                                        args=(*args, restart)))
        else:
            pr0 = restart if init_rows is None else init_rows[i]
            rows.append(engine.fixpoint(ex, _ppr_body, pr0, tol=float(tol),
                                        max_iter=10_000,
                                        args=(*args, restart)))
    prs = _stack_rows(rows, n, g.device)
    return prs[0] if scalar else prs


# ---------------------------------------------------------------------------
# Triangle counting (paper Table 3)
# ---------------------------------------------------------------------------


def _triangle_hits(plan, lo: int, hi: int):
    """Per-edge sorted-adjacency intersection over one oriented-edge chunk:
    ``(u, v, cand, hit)``, ``hit[e, i]`` when ``cand[e, i]`` closes a
    triangle over the oriented edge ``u[e] -> v[e]``."""
    osrc, odst, nbr, _ = plan.oriented()
    u, v = osrc[lo:hi].long(), odst[lo:hi].long()
    cand = nbr[u]                                  # (c, w)
    rows = nbr[v]                                  # (c, w), each row sorted
    pos = torch.clamp(torch.searchsorted(rows, cand), 0, rows.shape[1] - 1)
    hit = (torch.gather(rows, 1, pos) == cand) & (cand != plan.n_nodes)
    return u, v, cand, hit


def triangle_count(g: Graph, edge_chunk: int = 1 << 16, *,
                   backend: Optional[str] = None) -> int:
    """Exact triangle count of the undirected simple graph ``g``.

    Default path: degeneracy orientation (cached in the plan) + per-edge
    sorted-adjacency intersection, chunked over edges to bound memory.
    ``backend="bsr"`` runs kernel K3, A∘(A·A) over the plan's tiles and
    block triples.
    """
    if backend == "sharded":
        engine.select_backend(None, backend)      # raises: not ported yet
    if backend not in (None, "xla", "bsr"):
        raise ValueError(f"triangle_count backends are None/'xla' (oriented "
                         f"intersection) or 'bsr' (kernel K3); got "
                         f"{backend!r}")
    if g.n_edges == 0 or g.n_nodes == 0:
        return 0
    plan = g.plan()
    if backend == "bsr":
        tiles, _, _, _ = plan.bsr()
        t_ij, t_ik, t_kj = plan.tri_triples()
        six_t = bsr_tricount(torch.clamp(tiles, max=1.0), t_ij, t_ik, t_kj)
        return int(round(int(six_t) / 6.0))
    osrc, _, _, _ = plan.oriented()
    e = int(osrc.shape[0])
    total = 0
    for lo in range(0, e, edge_chunk):
        total += int(_triangle_hits(plan, lo, min(lo + edge_chunk, e))[3].sum())
    return total


def per_node_triangles(g: Graph, edge_chunk: int = 1 << 16) -> torch.Tensor:
    """Triangles incident to each node (undirected simple graph), int32."""
    n = g.n_nodes
    counts = torch.zeros((n,), dtype=_I32, device=g.device)
    if g.n_edges == 0 or n == 0:
        return counts
    plan = g.plan()
    e = int(plan.oriented()[0].shape[0])
    for lo in range(0, e, edge_chunk):
        u, v, cand, hit = _triangle_hits(plan, lo, min(lo + edge_chunk, e))
        per_edge = hit.sum(1, dtype=_I32)          # triangles over u -> v
        counts.index_add_(0, u, per_edge)
        counts.index_add_(0, v, per_edge)
        # the third vertex of each triangle
        w_hits = torch.where(hit, cand, n).reshape(-1).long()
        counts += torch.bincount(w_hits, minlength=n + 1)[:n].to(_I32)
    return counts


def clustering_coefficient(g: Graph) -> torch.Tensor:
    """Local clustering coefficient per node (undirected simple graph)."""
    tri = per_node_triangles(g).to(_F32)
    deg = g.plan().out_deg.to(_F32)
    wedges = deg * (deg - 1.0) / 2.0
    return torch.where(wedges > 0, tri / torch.clamp_min(wedges, 1.0), 0.0)


# ---------------------------------------------------------------------------
# Connected components (WCC) — min-label propagation + pointer jumping
# ---------------------------------------------------------------------------


def _cc_body(ex, labels):
    # min label over in-neighbors (the undirected view is symmetrized)
    m = ex.pull(labels, "min")
    new = torch.minimum(labels, m)
    # pointer jumping: label <- label[label], twice per round
    new = new[new.long()]
    new = new[new.long()]
    return new


def connected_components(g: Graph, *,
                         backend: Optional[str] = None) -> torch.Tensor:
    """Weakly-connected component labels (min dense node id in component).

    The ``"frontier"`` backend propagates min labels only from vertices
    whose label changed last round (no pointer jumping: more rounds, less
    work per round); both paths reach the same fixpoint.
    """
    u = g.plan().undirected()
    uplan = u.plan()
    be = engine.select_backend(uplan, backend, op="connected_components")
    labels0 = torch.arange(u.n_nodes, dtype=_I32, device=u.device)
    if be == "frontier" and u.n_nodes > 0:
        labels = engine.frontier_fixpoint(
            uplan, labels0, torch.ones((u.n_nodes,), dtype=torch.bool,
                                       device=u.device))
    else:
        labels = engine.fixpoint(engine.get_exec(uplan, be), _cc_body,
                                 labels0)
    # map back to g's dense id space; isolated vertices label themselves
    return _undirected_ids_to_g(g, u, labels)


# ---------------------------------------------------------------------------
# SSSP / BFS (paper Table 6)
# ---------------------------------------------------------------------------


def _sssp_body(ex, dist, w):
    relaxed = ex.pull(dist, "min", edge_values=w, edge_op="add")
    return torch.minimum(dist, relaxed)


def sssp(g: Graph, source, weights: Optional[torch.Tensor] = None,
         n_iter=None, *, backend: Optional[str] = None) -> torch.Tensor:
    """Single- or multi-source shortest paths (relaxation to fixpoint).

    ``weights`` is per-edge in in-edge order (sorted by dst); defaults to 1.
    ``source`` may be a scalar (returns ``(n,)``) or k sources (returns
    ``(k, n)``).  ``n_iter`` caps the relaxation rounds (None = to
    convergence), per source when it is a ``(k,)`` array; each row then
    equals a standalone run with its cap.  Only single-source calls carry
    the op tag the size rule routes to ``"frontier"``, whose sparse
    relaxation equals the dense one round for round.
    """
    plan = g.plan()
    n = g.n_nodes
    scalar, sources = _sources(g, source)
    k = int(sources.shape[0])
    caps = _source_caps(k, n_iter)
    auto_op = "sssp" if k == 1 else None
    be = engine.select_backend(plan, backend,
                               op="sssp" if backend is not None else auto_op)
    # unweighted runs relax with a scalar hop (no per-edge array)
    w = (torch.ones((), dtype=_F32, device=g.device) if weights is None
         else torch.as_tensor(weights, device=g.device).to(_F32))

    if be == "frontier" and n > 0:
        # index_fill_ takes its value as a scalar: no copy, no host sync
        dist0 = torch.full((k, n), _INF, dtype=_F32, device=g.device)
        dist0.view(-1).index_fill_(
            0, torch.arange(k, device=g.device) * n + sources, 0.0)
        mask0 = torch.zeros((n,), dtype=torch.bool,
                            device=g.device).index_fill_(0, sources, True)
        dists = engine.frontier_fixpoint(plan, dist0, mask0, weights=w,
                                         caps=caps)
        return dists[0] if scalar else dists

    ex = engine.get_exec(plan, be)
    rows = []
    for i in range(k):
        dist0 = torch.full((n,), _INF, dtype=_F32,
                           device=g.device).index_fill_(0, sources[i:i + 1],
                                                        0.0)
        rows.append(engine.fixpoint(
            ex, _sssp_body, dist0, args=(w,),
            max_iter=None if caps is None else int(caps[i])))
    dists = _stack_rows(rows, n, g.device)
    return dists[0] if scalar else dists


def bfs(g: Graph, source, n_iter=None, *,
        backend: Optional[str] = None) -> torch.Tensor:
    """BFS levels (unweighted SSSP), int32; -1 for unreachable.  Batched
    like :func:`sssp`; ``n_iter`` is the depth limit."""
    dist = sssp(g, source, n_iter=n_iter, backend=backend)
    return torch.where(torch.isinf(dist), -1, dist.to(_I32))


# ---------------------------------------------------------------------------
# k-core (paper Table 6)
# ---------------------------------------------------------------------------


def _k_core_body(ex, alive, k):
    # degree over alive neighbours; edges into dead nodes only reach rows
    # the ``alive &`` mask kills anyway
    deg = ex.pull(alive.to(_F32), "sum")
    return alive & (deg >= k)


def k_core(g: Graph, k: int, *, backend: Optional[str] = None
           ) -> torch.Tensor:
    """Boolean mask of nodes in the k-core (iterative parallel peeling).

    The degree pull is a 0/1 float sum, kernel K1 on "bsr" and K2 on
    "pallas": exact below 2^24 neighbours.
    """
    u = g.plan().undirected()
    _, ex = _exec_for(u, backend)
    alive = engine.fixpoint(
        ex, _k_core_body,
        torch.ones((u.n_nodes,), dtype=torch.bool, device=u.device),
        args=(float(k),))
    # vertices with no non-loop edges have degree 0: in the core iff k <= 0
    return _undirected_values_to_g(g, u, alive, k <= 0)


def core_numbers(g: Graph, k_max: Optional[int] = None, *,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Core number per node by sweeping k (exact; one peel per k), int32.

    Every peel shares one plan and exec; each reads one flag per round and
    the sweep one more per k.
    """
    u = g.plan().undirected()
    uplan, ex = _exec_for(u, backend)
    if k_max is None:
        k_max = int(uplan.out_deg.max()) if u.n_nodes else 0
    ones = torch.ones((u.n_nodes,), dtype=torch.bool, device=u.device)
    core = torch.zeros((u.n_nodes,), dtype=_I32, device=u.device)
    for k in range(1, k_max + 1):
        alive = engine.fixpoint(ex, _k_core_body, ones, args=(float(k),))
        if not bool(alive.any()):
            break
        core = torch.where(alive, k, core)
    return _undirected_values_to_g(g, u, core, 0)


# ---------------------------------------------------------------------------
# SCC (paper Table 6) — parallel coloring (Orzan)
# ---------------------------------------------------------------------------

_NOT_ASSIGNED = -1


def _scc_color_body(ex, color, un):
    # propagate color along forward edges: dst takes max(src color)
    m = ex.pull(torch.where(un, color, _NOT_ASSIGNED), "max")
    return torch.where(un, torch.maximum(color, m), color)


def _scc_reach_body(ex, reach, un, color):
    # a backward step (u -> v in G carries reach from v to u), restricted
    # to unassigned endpoints of equal color: reduce out-edges to the source
    ok = (ex.out_src_vals(un) & ex.out_dst_vals(un)
          & (ex.out_src_vals(color) == ex.out_dst_vals(color)))
    m = ex.reduce_out((ok & ex.out_dst_vals(reach)).to(_I32), "max")
    return reach | (m > 0)


def _scc_round(ex, scc):
    """Forward-max coloring, then backward containment: one round.

    1. color = max node id, propagated along forward edges among
       unassigned nodes, to fixpoint.
    2. Nodes with color == own id are SCC roots.
    3. Reach propagates backward from each root within its color; the
       nodes reached form the root's SCC.
    """
    un = scc == _NOT_ASSIGNED
    ids = torch.arange(ex.n_nodes, dtype=_I32, device=scc.device)
    color0 = torch.where(un, ids, _NOT_ASSIGNED)
    color = engine.fixpoint(ex, _scc_color_body, color0, args=(un,))
    is_root = un & (color == ids)
    reach = engine.fixpoint(ex, _scc_reach_body, is_root, args=(un, color))
    return torch.where(un & reach, color, scc)


def strongly_connected_components(g: Graph, *,
                                  backend: Optional[str] = None
                                  ) -> torch.Tensor:
    """SCC id per node (the max dense node id in its component), int32.

    Each round assigns at least the component of the largest unassigned
    id, so the until-unchanged fixpoint stops one round after the last
    assignment; each round runs two nested until-unchanged fixpoints.
    """
    _, ex = _exec_for(g, backend)
    scc0 = torch.full((g.n_nodes,), _NOT_ASSIGNED, dtype=_I32,
                      device=g.device)
    return engine.fixpoint(ex, _scc_round, scc0)


# ---------------------------------------------------------------------------
# HITS
# ---------------------------------------------------------------------------


def _hits_body(ex, ha):
    hub, auth = ha
    auth = ex.pull(hub, "sum")
    auth = auth / torch.clamp_min(torch.linalg.vector_norm(auth), 1e-30)
    hub = ex.push(auth, "sum")
    hub = hub / torch.clamp_min(torch.linalg.vector_norm(hub), 1e-30)
    return hub, auth


def hits(g: Graph, n_iter: int = 20, *, backend: Optional[str] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HITS hub/authority scores (paper §4.1 mentions Hits for experts)."""
    _, ex = _exec_for(g, backend)
    ones = torch.ones((g.n_nodes,), dtype=torch.float32, device=g.device)
    return engine.fixpoint(ex, _hits_body, (ones, ones), n_iter=n_iter)



# ---------------------------------------------------------------------------
# degree measures, centralities and communities
# ---------------------------------------------------------------------------


def _degrees(g: Graph, direction: str) -> torch.Tensor:
    plan = g.plan()
    return plan.out_deg if direction == "out" else plan.in_deg


def degree_histogram(g: Graph, direction: str = "out") -> torch.Tensor:
    """Count of nodes per degree, int32 (length max degree + 1)."""
    deg = _degrees(g, direction)
    mx = int(deg.max()) if g.n_nodes else 0
    return torch.bincount(deg, minlength=mx + 1).to(_I32)


def degree_centrality(g: Graph, direction: str = "out") -> torch.Tensor:
    return _degrees(g, direction).to(_F32) / max(g.n_nodes - 1, 1)


def _eigen_body(ex, v):
    nv = ex.pull(v, "sum")
    nv = nv + 0.01 * v   # regularizer: convergence on DAG-like graphs
    return nv / torch.clamp_min(torch.linalg.vector_norm(nv), 1e-30)


def eigenvector_centrality(g: Graph, n_iter: int = 50, *,
                           backend: Optional[str] = None) -> torch.Tensor:
    """Power-iteration eigenvector centrality over in-edges (one pull a
    round: kernel K1 on "bsr", K2 on "pallas")."""
    _, ex = _exec_for(g, backend)
    x0 = 1.0 / torch.full((g.n_nodes,), float(g.n_nodes), dtype=_F32,
                          device=g.device).sqrt()
    return engine.fixpoint(ex, _eigen_body, x0, n_iter=n_iter)


def _lp_body(ex, lab):
    """Hash-min label propagation step (the deterministic tie-break
    variant of synchronous LP: exact CC on disconnected graphs)."""
    return torch.minimum(lab, ex.pull(lab, "min"))


def label_propagation(g: Graph, n_iter: int = 20, *,
                      backend: Optional[str] = None) -> torch.Tensor:
    """Community labels by min-label propagation on the undirected view.

    A monotone relaxation, so the ``"frontier"`` path (capped at
    ``n_iter`` rounds) equals the dense iterate round for round.
    """
    u = g.plan().undirected()
    uplan = u.plan()
    be = engine.select_backend(uplan, backend, op="label_propagation")
    labels0 = torch.arange(u.n_nodes, dtype=_I32, device=u.device)
    if be == "frontier" and u.n_nodes > 0:
        lab = engine.frontier_fixpoint(
            uplan, labels0, torch.ones((u.n_nodes,), dtype=torch.bool,
                                       device=u.device), caps=n_iter)
    else:
        lab = engine.fixpoint(engine.get_exec(uplan, be), _lp_body, labels0,
                              n_iter=n_iter)
    return _undirected_ids_to_g(g, u, lab)


def closeness_centrality(g: Graph, sources=None, n_samples: int = 16, *,
                         backend: Optional[str] = None) -> torch.Tensor:
    """Sampled closeness: average reciprocal distance over sampled sources
    (exact when ``sources`` covers every node); a batched :func:`sssp`."""
    n = g.n_nodes
    if sources is None:
        step = max(n // max(n_samples, 1), 1)
        sources = torch.arange(0, n, step, dtype=_I32,
                               device=g.device)[:n_samples]
    dists = sssp(g, sources, backend=backend)                 # (k, n)
    finite = torch.isfinite(dists)
    recip = torch.where(finite & (dists > 0),
                        1.0 / torch.clamp_min(dists, 1e-9), 0.0)
    return recip.sum(0) / torch.clamp_min(finite.sum(0), 1)
