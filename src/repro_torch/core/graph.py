"""Graph data structure (Ringo §2.2) — static-shape dual CSR in PyTorch.

Counterpart of ``repro/core/graph.py``, with the same padded layout, so the
arrays equal the reference's element for element:

    node_ids : (node_cap,)   original ids, ascending (padding = INT32_MAX)
    out_ptr  : (node_cap+1,) CSR row pointers (out-adjacency)
    out_idx  : (edge_cap,)   dense dst ids, sorted within each row
    in_ptr   : (node_cap+1,)
    in_idx   : (edge_cap,)   dense src ids, sorted within each row

Storage is int32; indices widen to int64 only where they index.  The
hash-table lookup ``id -> node`` is ``searchsorted(node_ids, id)``; updates
are functional rebuilds by sorting, recorded by the provenance layer
(``core/provenance.py``) under the reference's op names.  Capacities are
power-of-two buckets.  Not in this slice: ``EdgeDelta``/``apply_delta``,
lineage and byte accounting.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve
from .provenance import track, version_of
from .table import next_capacity

__all__ = ["Graph", "INVALID_ID"]

INVALID_ID = int(np.iinfo(np.int32).max)

_I32 = torch.int32


def _as_i32(x, dev: torch.device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=_I32)
    return torch.from_numpy(np.array(x, dtype=np.int32)).to(dev)


def _lexsort(secondary: torch.Tensor, primary: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (primary, secondary): two stable sorts,
    secondary key first (``jnp.lexsort((secondary, primary))``)."""
    p = torch.argsort(secondary, stable=True)
    return p[torch.argsort(primary[p], stable=True)]


@dataclass
class Graph:
    """Directed graph with dense node ids [0, n_nodes) and dual CSR."""

    n_nodes: int
    n_edges: int
    node_ids: torch.Tensor
    out_ptr: torch.Tensor
    out_idx: torch.Tensor
    in_ptr: torch.Tensor
    in_idx: torch.Tensor
    # identity-keyed traversal-plan cache (core/plan.py); the functional
    # update methods return fresh Graph objects, so a stale plan is never seen
    _plan: Optional[object] = field(default=None, repr=False, compare=False)

    # -- constructors ----------------------------------------------------------
    @classmethod
    def from_dense_edges(cls, src, dst, n_nodes: int, node_ids=None,
                         device: DeviceLike = None) -> "Graph":
        """Build from dense-id edge arrays (valid length = full length).

        The paper's **sort-first** algorithm (§2.4): sort the edge columns,
        count neighbours explicitly, bulk-write the adjacency.
        """
        dev = resolve(device)
        src, dst = _as_i32(src, dev), _as_i32(dst, dev)
        e = int(src.shape[0])
        node_cap = next_capacity(max(n_nodes, 1))
        edge_cap = next_capacity(max(e, 1))
        ids = torch.full((node_cap,), INVALID_ID, dtype=_I32, device=dev)
        if node_ids is None:
            ids[:n_nodes] = torch.arange(n_nodes, dtype=_I32, device=dev)
        else:
            given = _as_i32(node_ids, dev)
            ids[: given.shape[0]] = given
        out_ptr, out_idx = _csr_from_pairs(src, dst, node_cap, edge_cap)
        in_ptr, in_idx = _csr_from_pairs(dst, src, node_cap, edge_cap)
        return cls(n_nodes=n_nodes, n_edges=e, node_ids=ids,
                   out_ptr=out_ptr, out_idx=out_idx, in_ptr=in_ptr,
                   in_idx=in_idx)

    @classmethod
    def from_edges(cls, src, dst, dedupe: bool = True,
                   drop_self_loops: bool = False,
                   device: DeviceLike = None) -> "Graph":
        """Build from raw (original-id) edge arrays; renumbers densely.

        Node set = union of endpoint ids (paper §2.4).
        """
        dev = resolve(device)
        src, dst = _as_i32(src, dev), _as_i32(dst, dev)
        if drop_self_loops:
            keep = src != dst
            src, dst = src[keep], dst[keep]
        # dense renumbering: the sort-based dual of Ringo's node hash table
        if src.shape[0] == 0:
            return cls.from_dense_edges(src, dst, 0, device=dev)
        valid_ids = torch.unique(torch.cat([src, dst]), sorted=True)
        n_nodes = int(valid_ids.shape[0])
        src_d = torch.searchsorted(valid_ids, src).to(_I32)
        dst_d = torch.searchsorted(valid_ids, dst).to(_I32)
        if dedupe:
            src_d, dst_d = _dedupe_pairs(src_d, dst_d)
        return cls.from_dense_edges(src_d, dst_d, n_nodes, node_ids=valid_ids,
                                    device=dev)

    @classmethod
    def from_arrays(cls, arrays: Sequence[np.ndarray], n_nodes: int,
                    n_edges: int, device: DeviceLike = None) -> "Graph":
        """Graph from the five CSR arrays ``(node_ids, out_ptr, out_idx,
        in_ptr, in_idx)`` as numpy, e.g. a reference ``Graph``'s."""
        dev = resolve(device)
        if len(arrays) != 5:
            raise ValueError("from_arrays needs (node_ids, out_ptr, out_idx, "
                             "in_ptr, in_idx)")
        return cls(n_nodes, n_edges, *(_as_i32(a, dev) for a in arrays))

    def to_arrays(self) -> Tuple[np.ndarray, ...]:
        """``(node_ids, out_ptr, out_idx, in_ptr, in_idx)`` as numpy."""
        return tuple(a.cpu().numpy() for a in (
            self.node_ids, self.out_ptr, self.out_idx, self.in_ptr,
            self.in_idx))

    # -- accessors ---------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.node_ids.device

    @property
    def node_capacity(self) -> int:
        return int(self.node_ids.shape[0])

    @property
    def edge_capacity(self) -> int:
        return int(self.out_idx.shape[0])

    def out_degrees(self) -> torch.Tensor:
        return (self.out_ptr[1:] - self.out_ptr[:-1])[: self.n_nodes]

    def in_degrees(self) -> torch.Tensor:
        return (self.in_ptr[1:] - self.in_ptr[:-1])[: self.n_nodes]

    def out_edges(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(src, dst) with edges sorted by src (dense ids, valid prefix)."""
        e = self.n_edges
        return _row_of_edge(self.out_ptr, e), self.out_idx[:e]

    def in_edges(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(src, dst) with edges sorted by dst (dense ids, valid prefix)."""
        e = self.n_edges
        return self.in_idx[:e], _row_of_edge(self.in_ptr, e)

    # -- traversal plan ------------------------------------------------------------
    def plan(self):
        """Memoized :class:`repro_torch.core.plan.GraphPlan` for this graph."""
        if self._plan is None:
            from .plan import GraphPlan  # local import: plan imports graph
            self._plan = GraphPlan.build(self)
        return self._plan

    @property
    def version(self) -> str:
        """Provenance version token (Ringo §2.1 object metadata).

        Graphs are immutable and the update methods return fresh objects, so
        the token doubles as a cache key for any result computed against it.
        """
        return version_of(self)

    def dense_of(self, original_ids) -> torch.Tensor:
        """Vectorized id lookup (the hash-probe dual)."""
        q = _as_i32(original_ids, self.device)
        return torch.searchsorted(self.node_ids[: self.n_nodes], q).to(_I32)

    def original_of(self, dense_ids) -> torch.Tensor:
        return self.node_ids[_as_i32(dense_ids, self.device).long()]

    # -- functional updates (the dynamism story) -----------------------------------
    @track("graph.add_edges", "Graph.add_edges")
    def add_edges(self, src, dst, dedupe: bool = True) -> "Graph":
        """Merge new edges (original ids) — functional rebuild by sorting."""
        s, d = self.out_edges()
        src = torch.cat([self.original_of(s), _as_i32(src, self.device)])
        dst = torch.cat([self.original_of(d), _as_i32(dst, self.device)])
        return Graph.from_edges(src, dst, dedupe=dedupe, device=self.device)

    @track("graph.delete_edges", "Graph.delete_edges")
    def delete_edges(self, src, dst) -> "Graph":
        """Remove the given (original-id) edges; sort-based anti-join on
        exact 64-bit pair keys."""
        s, d = self.out_edges()
        os_, od = self.original_of(s).long(), self.original_of(d).long()
        keys = (os_ << 32) | (od & 0xFFFFFFFF)
        ds = _as_i32(src, self.device).long()
        dd = _as_i32(dst, self.device).long()
        keep = ~torch.isin(keys, (ds << 32) | (dd & 0xFFFFFFFF))
        return Graph.from_edges(os_[keep], od[keep], dedupe=False,
                                device=self.device)

    @track("graph.to_undirected", "Graph.to_undirected")
    def to_undirected(self) -> "Graph":
        """Symmetrized simple graph (for triangles / WCC)."""
        s, d = self.out_edges()
        os_, od = self.original_of(s), self.original_of(d)
        return Graph.from_edges(torch.cat([os_, od]), torch.cat([od, os_]),
                                dedupe=True, drop_self_loops=True,
                                device=self.device)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Graph({self.n_nodes} nodes, {self.n_edges} edges)"


# ---------------------------------------------------------------------------
# internals — the sort-first building blocks
# ---------------------------------------------------------------------------


def _csr_from_pairs(row: torch.Tensor, col: torch.Tensor, node_cap: int,
                    edge_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-first CSR: lexsort (row, col) -> counts -> ptr; no hash inserts."""
    e = int(row.shape[0])
    perm = _lexsort(col, row)      # row primary, col secondary
    # row pointers from the sorted rows: ptr[i] = #edges with row < i
    ptr = torch.searchsorted(
        row[perm], torch.arange(node_cap + 1, dtype=_I32, device=row.device))
    idx = torch.zeros((edge_cap,), dtype=_I32, device=row.device)
    idx[:e] = col[perm]
    return ptr.to(_I32), idx


def _row_of_edge(ptr: torch.Tensor, e: int) -> torch.Tensor:
    """Row id of each of the first ``e`` CSR slots: searchsorted(ptr, e,
    'right') - 1."""
    slots = torch.arange(e, dtype=_I32, device=ptr.device)
    return (torch.searchsorted(ptr, slots, right=True) - 1).to(_I32)


def _dedupe_pairs(src: torch.Tensor, dst: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remove duplicate (src, dst) pairs; output sorted by (src, dst).

    Pure 32-bit: the pair is compared componentwise after a lexsort.
    """
    order = _lexsort(dst, src)
    ss, ds = src[order], dst[order]
    firsts = torch.ones_like(ss, dtype=torch.bool)
    firsts[1:] = (ss[1:] != ss[:-1]) | (ds[1:] != ds[:-1])
    return ss[firsts], ds[firsts]
