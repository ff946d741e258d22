"""Graph algorithms (Ringo §2.2/§3, paper Table 3) on the shared engine.

Counterpart of ``repro/core/algorithms.py:62-150, 235-285, 325-356,
580-595``: PageRank, HITS, connected components and triangle counting, each
a thin composition over the plan and the engine, so a backend's kernel
serves every algorithm at once.  Every algorithm takes ``backend=`` (None =
``"xla"``) and runs on the device of the graph's tensors; results are
per-node tensors in the graph's dense id space.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import engine
from .graph import Graph
from ..kernels.bsr_tricount import bsr_tricount

__all__ = ["pagerank", "triangle_count", "connected_components", "hits"]

_I32 = torch.int32


def _exec_for(g: Graph, backend: Optional[str]):
    plan = g.plan()
    return plan, engine.get_exec(plan, backend)


def _undirected_ids_to_g(g: Graph, u: Graph,
                         labels: torch.Tensor) -> torch.Tensor:
    """Id-valued results (CC labels are u-dense ids) -> g-dense ids.

    ``to_undirected`` rebuilds the node set from edge endpoints, so vertices
    of ``g`` with no non-loop edges are absent from ``u``; they label
    themselves.  Both dense numberings ascend with original id, so min-id
    semantics survive.
    """
    own = torch.arange(g.n_nodes, dtype=_I32, device=g.device)
    if g.n_nodes == 0 or u.n_nodes == 0:
        return own
    orig = g.node_ids[: g.n_nodes]
    pos = torch.clamp(u.dense_of(orig), 0, u.n_nodes - 1).long()
    present = u.node_ids[pos] == orig
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


# ---------------------------------------------------------------------------
# Triangle counting (paper Table 3)
# ---------------------------------------------------------------------------


def _triangle_hits(plan, lo: int, hi: int):
    """Per-edge sorted-adjacency intersection over one oriented-edge chunk."""
    osrc, odst, nbr, _ = plan.oriented()
    pad_val = plan.n_nodes
    cand = nbr[osrc[lo:hi].long()]                 # (c, w)
    rows = nbr[odst[lo:hi].long()]                 # (c, w), each row sorted
    pos = torch.clamp(torch.searchsorted(rows, cand), 0, rows.shape[1] - 1)
    return (torch.gather(rows, 1, pos) == cand) & (cand != pad_val)


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
        total += int(_triangle_hits(plan, lo, min(lo + edge_chunk, e)).sum())
    return total


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
    """Weakly-connected component labels (min dense node id in component)."""
    u = g.plan().undirected()
    uplan = u.plan()
    ex = engine.get_exec(uplan, backend)
    labels0 = torch.arange(u.n_nodes, dtype=_I32, device=u.device)
    labels = engine.fixpoint(ex, _cc_body, labels0)
    # map back to g's dense id space; isolated vertices label themselves
    return _undirected_ids_to_g(g, u, labels)


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
