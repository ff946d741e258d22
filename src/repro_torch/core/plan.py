"""Layer 1 of the traversal engine: the memoized :class:`GraphPlan`.

Counterpart of ``repro/core/plan.py:203-495``.  The plan hoists everything
the traversals derive from a graph into a per-``Graph`` cache, keyed by
graph identity through :meth:`repro_torch.core.graph.Graph.plan`.

Eagerly built (cheap, needed by every traversal):

    in_src / in_dst    edge arrays sorted by destination (pull order)
    out_src / out_dst  edge arrays sorted by source (push order)
    out_deg / in_deg   degree vectors
    inv_out_deg        1/out-degree (0 for sinks) — PageRank mass split
    dangling           out_deg == 0 mask

Lazily built and cached on first use:

    undirected()       symmetrized simple-graph view (CC / triangles)
    oriented()         degeneracy-oriented padded adjacency (triangles)
    bsr(block)         BSR tiles of M[dst, src] (K1 pull)
    bsr_t(block)       transpose tiles M[src, dst] (K1 push)
    tri_triples(block) BSR tile triples for K3
    chunk_layout_in / chunk_layout_out
                       chunk structure for K2 (pull / push order)

Not in this slice: ``patch``, ``sharded``, the frontier's CSR families and
byte accounting / eviction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from .graph import Graph, _lexsort
from ..kernels.ops import build_block_triples, edges_to_bsr
from ..kernels.segment_sum import DEFAULT_BLOCK, DEFAULT_CHUNK, chunk_layout

__all__ = ["GraphPlan"]


def _host(t: torch.Tensor):
    return t.cpu().numpy()


@dataclass
class GraphPlan:
    """Precomputed traversal arrays for one :class:`Graph` (identity-cached)."""

    graph: Graph
    n_nodes: int
    n_edges: int
    in_src: torch.Tensor
    in_dst: torch.Tensor
    out_src: torch.Tensor
    out_dst: torch.Tensor
    out_deg: torch.Tensor
    in_deg: torch.Tensor
    inv_out_deg: torch.Tensor
    dangling: torch.Tensor
    # lazy caches, filled on first use
    execs: Dict = field(default_factory=dict, repr=False, compare=False)
    _undirected: Optional[Graph] = field(default=None, repr=False,
                                         compare=False)
    _oriented: Optional[Tuple] = field(default=None, repr=False, compare=False)
    _bsr: Dict = field(default_factory=dict, repr=False, compare=False)
    _bsr_t: Dict = field(default_factory=dict, repr=False, compare=False)
    _tri_triples: Dict = field(default_factory=dict, repr=False, compare=False)
    _chunks_in: Dict = field(default_factory=dict, repr=False, compare=False)
    _chunks_out: Dict = field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def build(cls, g: Graph) -> "GraphPlan":
        in_src, in_dst = g.in_edges()
        out_src, out_dst = g.out_edges()
        out_deg = g.out_degrees()
        in_deg = g.in_degrees()
        out_deg_f = out_deg.to(torch.float32)
        inv_out_deg = torch.where(out_deg > 0,
                                  1.0 / torch.clamp_min(out_deg_f, 1.0),
                                  torch.zeros_like(out_deg_f))
        return cls(graph=g, n_nodes=g.n_nodes, n_edges=g.n_edges,
                   in_src=in_src, in_dst=in_dst,
                   out_src=out_src, out_dst=out_dst,
                   out_deg=out_deg, in_deg=in_deg,
                   inv_out_deg=inv_out_deg, dangling=out_deg == 0)

    @property
    def device(self) -> torch.device:
        return self.graph.device

    # -- lazy derived structures -------------------------------------------------
    def undirected(self) -> Graph:
        """Symmetrized simple-graph view, built once per plan."""
        if self._undirected is None:
            self._undirected = self.graph.to_undirected()
        return self._undirected

    def oriented(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
        """Degeneracy-oriented padded adjacency ``(osrc, odst, nbr, odeg)``.

        Each undirected edge points from its lower-(degree, id) endpoint to
        the higher one, so every triangle has exactly one apex.  ``nbr`` is
        the (n, max oriented degree) neighbour matrix, rows sorted, padded
        with ``n`` (which sorts last).
        """
        if self._oriented is None:
            src, dst = self.out_src.long(), self.out_dst.long()
            deg = self.out_deg
            n = self.n_nodes
            keep = (deg[src] < deg[dst]) | ((deg[src] == deg[dst]) & (src < dst))
            osrc, odst = self.out_src[keep], self.out_dst[keep]
            n_keep = int(osrc.shape[0])
            odeg = torch.bincount(osrc.long(), minlength=n)[:n]
            max_deg = int(odeg.max()) if n_keep else 0
            order = _lexsort(odst, osrc)
            s_sorted, d_sorted = osrc[order].long(), odst[order]
            ptr = torch.zeros((n + 1,), dtype=torch.int64, device=self.device)
            ptr[1:] = torch.cumsum(odeg, 0)
            slot = torch.arange(n_keep, device=self.device) - ptr[s_sorted]
            nbr = torch.full((n, max(max_deg, 1)), n, dtype=torch.int32,
                             device=self.device)
            nbr[s_sorted, slot] = d_sorted
            self._oriented = (osrc, odst, nbr, odeg.to(torch.int32))
        return self._oriented

    def bsr(self, block: int = DEFAULT_BLOCK
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
        """Unweighted BSR tiles of M[dst, src] (the pull/SpMV layout)."""
        if block not in self._bsr:
            self._bsr[block] = edges_to_bsr(
                _host(self.in_src), _host(self.in_dst), self.n_nodes,
                block=block, device=self.device)
        return self._bsr[block]

    def bsr_t(self, block: int = DEFAULT_BLOCK
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
        """Transpose BSR tiles: M[src, dst] (the push/SpMV layout)."""
        if block not in self._bsr_t:
            # edges_to_bsr(a, b) builds M[b, a]: pass (dst, src) for M[src, dst]
            self._bsr_t[block] = edges_to_bsr(
                _host(self.out_dst), _host(self.out_src), self.n_nodes,
                block=block, device=self.device)
        return self._bsr_t[block]

    def tri_triples(self, block: int = DEFAULT_BLOCK
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Tile triples (I,J),(I,K),(K,J) for the BSR triangle kernel."""
        if block not in self._tri_triples:
            _, rows, cols, _ = self.bsr(block)
            self._tri_triples[block] = build_block_triples(
                _host(rows), _host(cols), device=self.device)
        return self._tri_triples[block]

    def chunk_layout_in(self, chunk: int = DEFAULT_CHUNK):
        """K2 chunk structure for per-destination (pull) reductions."""
        if chunk not in self._chunks_in:
            self._chunks_in[chunk] = self._device_layout(
                chunk_layout(_host(self.in_dst), self.n_nodes, chunk))
        return self._chunks_in[chunk]

    def chunk_layout_out(self, chunk: int = DEFAULT_CHUNK):
        """K2 chunk structure for per-source (push) reductions."""
        if chunk not in self._chunks_out:
            self._chunks_out[chunk] = self._device_layout(
                chunk_layout(_host(self.out_src), self.n_nodes, chunk))
        return self._chunks_out[chunk]

    def _device_layout(self, layout):
        entry_chunk, entry_slot, local_ids, chunk_block, nb, total = layout
        dev = self.device
        return (torch.from_numpy(entry_chunk).to(dev),
                torch.from_numpy(entry_slot).to(dev),
                torch.from_numpy(local_ids).to(dev),
                torch.from_numpy(chunk_block).to(dev), nb, total)
