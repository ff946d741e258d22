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
power-of-two buckets.

Incremental maintenance: :meth:`Graph.apply_delta` merges an
:class:`EdgeDelta` into both CSR orders on the graph's device (sorts,
``unique`` and ``searchsorted`` over int64 pair keys) and leaves a
``_DeltaInfo`` behind, from which :meth:`GraphPlan.patch
<repro_torch.core.plan.GraphPlan.patch>` derives the child's plan without
re-deriving its edges.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..device import DeviceLike, resolve
from .provenance import track, version_of
from .table import next_capacity

__all__ = ["Graph", "EdgeDelta", "INVALID_ID"]

INVALID_ID = int(np.iinfo(np.int32).max)

_I32 = torch.int32
_LOW = 0xFFFFFFFF          # low word of an int64 pair key
_log = obs.get_logger(__name__)
_C_PLAN_HIT = obs.counter("engine.plan_cache.hits")
_C_PLAN_MISS = obs.counter("engine.plan_cache.misses")
_C_PLAN_PATCH = obs.counter("engine.plan_cache.patched")


def _as_i32(x, dev: torch.device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=_I32)
    return torch.from_numpy(np.array(x, dtype=np.int32)).to(dev)


def _lexsort(secondary: torch.Tensor, primary: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (primary, secondary): two stable sorts,
    secondary key first (``jnp.lexsort((secondary, primary))``)."""
    p = torch.argsort(secondary, stable=True)
    return p[torch.argsort(primary[p], stable=True)]


def _delta_ids(x) -> torch.Tensor:
    """A delta's id column as a flat int32 tensor; a tensor keeps its
    device, anything else becomes a CPU tensor."""
    if torch.is_tensor(x):
        return x.to(_I32).reshape(-1)
    return torch.from_numpy(np.array(x, dtype=np.int32).reshape(-1))


@dataclass(frozen=True, eq=False)
class EdgeDelta:
    """Batch of edge inserts/deletes in **original** node ids.

    The unit of incremental maintenance: :meth:`Graph.apply_delta` turns it
    into a child graph whose plan is patched from the parent's and whose
    analytics can warm-start from the parent's results.  Deleting an edge
    that does not exist is a no-op; inserted duplicates are deduped.  The
    four columns are numpy arrays or tensors, stored as int32 tensors.
    """

    add_src: torch.Tensor
    add_dst: torch.Tensor
    del_src: torch.Tensor
    del_dst: torch.Tensor

    def __post_init__(self):
        for name in ("add_src", "add_dst", "del_src", "del_dst"):
            object.__setattr__(self, name, _delta_ids(getattr(self, name)))
        if self.add_src.shape != self.add_dst.shape:
            raise ValueError("EdgeDelta add_src/add_dst length mismatch")
        if self.del_src.shape != self.del_dst.shape:
            raise ValueError("EdgeDelta del_src/del_dst length mismatch")

    @classmethod
    def inserts(cls, src, dst) -> "EdgeDelta":
        empty = np.empty((0,), np.int32)
        return cls(src, dst, empty, empty)

    @classmethod
    def deletes(cls, src, dst) -> "EdgeDelta":
        empty = np.empty((0,), np.int32)
        return cls(empty, empty, src, dst)

    @property
    def n_adds(self) -> int:
        return int(self.add_src.shape[0])

    @property
    def n_dels(self) -> int:
        return int(self.del_src.shape[0])

    @property
    def insert_only(self) -> bool:
        return self.n_dels == 0

    def __repr__(self) -> str:  # pragma: no cover
        return f"EdgeDelta(+{self.n_adds} edges, -{self.n_dels} edges)"


@dataclass
class _DeltaInfo:
    """How a Graph was derived from its parent: the fuel of plan patching.

    Dense-id int32 tensors on the graph's device, in the child numbering
    (the parent's, on the fast path, the only one that records this).  The
    merged edge lists in both CSR orders become the patched plan's eager
    fields as they are; ``out_dst`` and ``in_src`` are views of the child's
    ``out_idx`` / ``in_idx``, so the lineage holds no second copy of them.
    """

    parent: "Graph"
    add_src: torch.Tensor    # applied (deduped) inserts, out-order sorted
    add_dst: torch.Tensor
    del_src: torch.Tensor    # distinct deleted pairs
    del_dst: torch.Tensor
    insert_only: bool        # no edge was actually removed
    dirty: torch.Tensor      # dense vertex ids touched by the delta
    out_src: torch.Tensor    # merged edges sorted by (src, dst)
    out_dst: torch.Tensor
    in_src: torch.Tensor     # merged edges sorted by (dst, src)
    in_dst: torch.Tensor


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
    # delta lineage, set by apply_delta's fast path
    _delta: Optional[_DeltaInfo] = field(default=None, repr=False,
                                         compare=False)

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
        return torch.diff(self.out_ptr[: self.n_nodes + 1])

    def in_degrees(self) -> torch.Tensor:
        return torch.diff(self.in_ptr[: self.n_nodes + 1])

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
        """Memoized :class:`repro_torch.core.plan.GraphPlan` for this graph;
        a child of :meth:`apply_delta`'s fast path gets its parent's plan
        patched (``GraphPlan.patch``) instead of one built cold."""
        if self._plan is None:
            from .plan import GraphPlan  # local import: plan imports graph
            _C_PLAN_MISS.inc()
            if self._delta is not None:
                _C_PLAN_PATCH.inc()
                self._plan = GraphPlan.patch(self, self._delta)
            else:
                self._plan = GraphPlan.build(self)
        else:
            _C_PLAN_HIT.inc()
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

    @track("graph.apply_delta", "Graph.apply_delta")
    def apply_delta(self, delta: EdgeDelta) -> "Graph":
        """Batch edge inserts/deletes (original ids) -> new Graph.

        Fast path, when every insert endpoint is already a node: both CSR
        orders are merged on the graph's device over int64 ``(src << 32) |
        dst`` keys of dense ids, and a ``_DeltaInfo`` is recorded so that
        :meth:`plan` patches the parent's plan instead of re-deriving it.
        Inserts are deduped against the kept edges and themselves; deleting
        an absent edge is a no-op (all copies of a matched pair go, as in
        :meth:`delete_edges`).  The child shares the parent's ``node_ids``.
        The host reads a fixed number of sizes (the endpoint test, the
        lengths of ``unique`` and of the masked selections), none growing
        with |E|.

        A brand-new insert endpoint shifts the dense numbering: the child
        is then rebuilt from scratch, with a logged reason, and carries no
        lineage.
        """
        dev = self.device
        n = self.n_nodes
        valid = self.node_ids[:n]
        add_s, add_d = delta.add_src.to(dev), delta.add_dst.to(dev)
        new_eps = torch.cat([add_s, add_d])
        _, known = _dense_lookup(valid, new_eps)
        if new_eps.numel() and not bool(known.all()):
            _log.info("apply_delta.full_rebuild",
                      new_nodes=int(torch.unique(new_eps[~known]).numel()),
                      reason="dense numbering shifts")
            return self._apply_delta_rebuild(delta)

        s, d = self.out_edges()
        keys = (s.long() << 32) | d.long()   # dense ids >= 0: sorted, exact
        empty = keys[:0]

        # -- deletes: anti-join on dense pair keys (absent endpoints no-op) --
        dropped = empty
        if delta.n_dels:
            dp, ok_s = _dense_lookup(valid, delta.del_src.to(dev))
            dq, ok_d = _dense_lookup(valid, delta.del_dst.to(dev))
            ok = ok_s & ok_d
            dkeys = torch.unique((dp[ok] << 32) | dq[ok])
            hit = _in_sorted(dkeys, keys)
            dropped = torch.unique(keys[hit])
            keys = keys[~hit]
        n_deleted = self.n_edges - int(keys.numel())

        # -- inserts: dedupe, then merge into the sorted out-order list --
        akeys = empty
        if delta.n_adds:
            ai, _ = _dense_lookup(valid, add_s)
            aj, _ = _dense_lookup(valid, add_d)
            akeys = torch.unique((ai << 32) | aj)
            akeys = akeys[~_in_sorted(keys, akeys)]
        # inserts are absent from the kept list, so sorting the two
        # together is the sorted insertion of the reference's np.insert
        merged = torch.sort(torch.cat([keys, akeys])).values \
            if akeys.numel() else keys
        # in order: the same pairs keyed (dst, src)
        merged_in = torch.sort(_swap(merged)).values

        # -- the padded CSR arrays; the merged lists view their storage --
        e2 = int(merged.numel())
        node_cap = self.node_capacity
        edge_cap = next_capacity(max(e2, 1))
        m_src, m_dst = (merged >> 32).to(_I32), (merged & _LOW).to(_I32)
        mi_dst, mi_src = (merged_in >> 32).to(_I32), (merged_in & _LOW).to(_I32)
        out_idx = torch.zeros((edge_cap,), dtype=_I32, device=dev)
        out_idx[:e2] = m_dst
        in_idx = torch.zeros((edge_cap,), dtype=_I32, device=dev)
        in_idx[:e2] = mi_src
        child = Graph(n_nodes=n, n_edges=e2, node_ids=self.node_ids,
                      out_ptr=_ptr_of_sorted(m_src, node_cap),
                      out_idx=out_idx,
                      in_ptr=_ptr_of_sorted(mi_dst, node_cap),
                      in_idx=in_idx)
        dirty = torch.unique(torch.cat([
            akeys >> 32, akeys & _LOW, dropped >> 32, dropped & _LOW]))
        child._delta = _DeltaInfo(
            parent=self,
            add_src=(akeys >> 32).to(_I32), add_dst=(akeys & _LOW).to(_I32),
            del_src=(dropped >> 32).to(_I32),
            del_dst=(dropped & _LOW).to(_I32),
            insert_only=n_deleted == 0, dirty=dirty.to(_I32),
            out_src=m_src, out_dst=out_idx[:e2],
            in_src=in_idx[:e2], in_dst=mi_dst)
        return child

    def _apply_delta_rebuild(self, delta: EdgeDelta) -> "Graph":
        """Slow path: the node set grows, so renumber and rebuild.

        Node set = the parent's nodes (isolated ones included) + the new
        insert endpoints; delete and dedupe semantics match the fast path.
        """
        dev = self.device
        s, d = self.out_edges()
        os_, od = self.original_of(s).long(), self.original_of(d).long()
        # original ids may be any int32, so mask the low word (injective on
        # int32 pairs; only used for set membership, never for ordering)
        keys = ((os_ & _LOW) << 32) | (od & _LOW)
        if delta.n_dels:
            ds_, dd = delta.del_src.to(dev).long(), delta.del_dst.to(dev).long()
            keep = ~torch.isin(keys, ((ds_ & _LOW) << 32) | (dd & _LOW))
            os_, od = os_[keep], od[keep]
        add_s, add_d = delta.add_src.to(dev), delta.add_dst.to(dev)
        new_ids = torch.unique(torch.cat([self.node_ids[: self.n_nodes],
                                          add_s, add_d]))
        # orig -> dense is monotone, so the kept out-order list stays sorted
        ks = torch.searchsorted(new_ids, os_.to(_I32)).long()
        kd = torch.searchsorted(new_ids, od.to(_I32)).long()
        ai = torch.searchsorted(new_ids, add_s).long()
        aj = torch.searchsorted(new_ids, add_d).long()
        akeys = torch.unique((ai << 32) | aj)
        akeys = akeys[~_in_sorted((ks << 32) | kd, akeys)]
        return Graph.from_dense_edges(
            torch.cat([ks, akeys >> 32]), torch.cat([kd, akeys & _LOW]),
            int(new_ids.numel()), node_ids=new_ids, device=dev)

    @track("graph.to_undirected", "Graph.to_undirected")
    def to_undirected(self) -> "Graph":
        """Symmetrized simple graph (for triangles / WCC)."""
        s, d = self.out_edges()
        os_, od = self.original_of(s), self.original_of(d)
        return Graph.from_edges(torch.cat([os_, od]), torch.cat([od, os_]),
                                dedupe=True, drop_self_loops=True,
                                device=self.device)

    # -- memory accounting and lineage ------------------------------------------
    def nbytes(self) -> int:
        """Bytes of the five CSR arrays."""
        return sum(a.numel() * a.element_size() for a in (
            self.node_ids, self.out_ptr, self.out_idx, self.in_ptr,
            self.in_idx))

    def plan_nbytes(self) -> int:
        """Derived bytes held by this graph's plan (0 when the plan is cold)."""
        return 0 if self._plan is None else int(self._plan.nbytes())

    def lineage_depth(self) -> int:
        """Length of the ``apply_delta`` ancestry chain hanging off this graph."""
        depth, g = 0, self
        while g._delta is not None:
            depth += 1
            g = g._delta.parent
        return depth

    def prune_lineage(self, max_depth: int) -> int:
        """Cut the delta-ancestry chain ``max_depth`` links up; returns cuts.

        Every ``apply_delta`` child holds its parent graph (and, once its
        plan is built, the parent's plan) through ``_delta``: on the card a
        long delta stream would pin every ancestor's arrays.  Cutting
        clears the ancestor's ``_delta`` and its plan's ``_parent`` /
        ``_info``, releasing everything deeper; the cut ancestor only loses
        warm starts for later deltas, never a result.
        """
        depth, g = 0, self
        while g._delta is not None and depth < max_depth:
            depth += 1
            g = g._delta.parent
        cuts = 0
        if g._delta is not None:
            g._delta = None
            cuts += 1
        if g._plan is not None and getattr(g._plan, "_parent", None) is not None:
            g._plan._parent = None
            g._plan._info = None
            cuts += 1
        return cuts

    def __repr__(self) -> str:  # pragma: no cover
        return f"Graph({self.n_nodes} nodes, {self.n_edges} edges)"


# ---------------------------------------------------------------------------
# internals — the sort-first building blocks
# ---------------------------------------------------------------------------


def _dense_lookup(valid: torch.Tensor, q: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 dense position, present?) of original ids in the sorted id
    table; the position is clamped to ``size - 1`` so the gather that tests
    presence never reads out of range."""
    if valid.numel() == 0 or q.numel() == 0:
        return (torch.zeros(q.shape, dtype=torch.int64, device=q.device),
                torch.zeros(q.shape, dtype=torch.bool, device=q.device))
    pos = torch.clamp(torch.searchsorted(valid, q), max=valid.numel() - 1)
    return pos, valid[pos] == q


def _in_sorted(haystack: torch.Tensor, needles: torch.Tensor) -> torch.Tensor:
    """Membership of needles in an ascending (possibly duplicated) tensor."""
    if haystack.numel() == 0 or needles.numel() == 0:
        return torch.zeros(needles.shape, dtype=torch.bool,
                           device=needles.device)
    pos = torch.clamp(torch.searchsorted(haystack, needles),
                      max=haystack.numel() - 1)
    return haystack[pos] == needles


def _swap(keys: torch.Tensor) -> torch.Tensor:
    """``(a << 32) | b`` -> ``(b << 32) | a`` for non-negative words."""
    return ((keys & _LOW) << 32) | (keys >> 32)


def _ptr_of_sorted(rows: torch.Tensor, node_cap: int) -> torch.Tensor:
    """CSR row pointers of ascending row ids: ptr[i] = #rows < i."""
    return torch.searchsorted(
        rows, torch.arange(node_cap + 1, dtype=_I32, device=rows.device)
    ).to(_I32)


def _csr_from_pairs(row: torch.Tensor, col: torch.Tensor, node_cap: int,
                    edge_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-first CSR: lexsort (row, col) -> counts -> ptr; no hash inserts."""
    e = int(row.shape[0])
    perm = _lexsort(col, row)      # row primary, col secondary
    idx = torch.zeros((edge_cap,), dtype=_I32, device=row.device)
    idx[:e] = col[perm]
    return _ptr_of_sorted(row[perm], node_cap), idx


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
