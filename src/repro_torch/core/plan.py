"""Layer 1 of the traversal engine: the memoized :class:`GraphPlan`.

Counterpart of ``repro/core/plan.py``.  The plan hoists everything the
traversals derive from a graph into a per-``Graph`` cache, keyed by graph
identity through :meth:`repro_torch.core.graph.Graph.plan`.

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
    csr_out / csr_in   trimmed CSR with a degree-0 sentinel row (frontier)
    in_perm_out        in-order -> out-order edge permutation (frontier
                       weights)
    sharded(d)         per-shard arrays of the "sharded" backend: the
                       contiguous vertex-range partition of both edge
                       orders over d shards, their halo (boundary) index
                       sets and the padded degree vectors; one ShardPlan
                       per shard count, built on the plan's device and
                       needing no process group

A child of ``Graph.apply_delta`` gets its plan from :meth:`GraphPlan.patch`:
the eager fields are the delta's merged edge lists, and the undirected view,
the BSR tiles, the tile triples and the weight permutation are patched from
the parent's where that is sound.

Byte accounting (``nbytes_by_family``) counts each buffer once by its
storage (``untyped_storage().data_ptr()``): a view shares its base's
storage, so a family that holds a view of the graph's CSR arrays (``base``'s
``in_src`` / ``out_dst``, ``csr``'s trimmed row pointers) or of another
family's buffers is not charged for it.  The reference dedupes by object
identity, and a JAX slice is a copy, so it charges those; its counts are
higher there.  ``evict`` drops a family, which re-derives bit for bit on
its next use.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .graph import EdgeDelta, Graph, _lexsort
from ..kernels.ops import build_block_triples, edges_to_bsr
from ..kernels.segment_sum import DEFAULT_BLOCK, DEFAULT_CHUNK, chunk_layout

__all__ = ["GraphPlan", "ShardPlan", "EVICTABLE_FAMILIES"]

# Derived-array families a plan can drop and rebuild on next touch.  "base"
# (the eager sorted-edge/degree arrays) and "lineage" are the plan, not a
# cache over it.
EVICTABLE_FAMILIES: Tuple[str, ...] = (
    "undirected", "oriented", "csr", "perm", "bsr", "tri", "chunks",
    "sharded", "execs")


class _ShardDir(NamedTuple):
    """One direction (pull or push) of a vertex-range partition.

    The per-shard arrays use the reference's flat ``(d * per_shard,)``
    layout (array-equal to ``repro/core/plan.py``'s ``_build_shard_dir``);
    shard ``i``'s block is ``[i * per_shard, (i + 1) * per_shard)``.
    ``gather_idx`` addresses the concatenation ``[local x (ns values), halo
    (d * halo values)]`` of each round's boundary exchange; ``seg_local``
    maps each edge slot to its shard-local segment, padding slots to the
    overflow segment ``ns``.  ``bounds`` is the port's addition: shard
    ``i`` owns edges ``[bounds[i], bounds[i + 1])`` of this edge order.
    """

    es: int                    # padded edge slots per shard
    halo: int                  # boundary slots per shard (max cut fan-in)
    gather_idx: torch.Tensor   # (d*es,) int32 into [local(ns) | halo]
    seg_local: torch.Tensor    # (d*es,) int32 local segment id, pad -> ns
    edge_slot: torch.Tensor    # (E,) int32: edge order -> flat slot
    boundary: torch.Tensor     # (d*halo,) int32 local ids each shard exports
    bounds: Tuple[int, ...]    # (d+1,) edge offsets of the shards


class ShardPlan(NamedTuple):
    """Per-shard-count arrays of the "sharded" engine backend.

    ``pull`` partitions the dst-sorted in-edges by destination range (each
    vertex's whole in-segment stays on its owner, in order: that is what
    makes the shard-local segment reduction bit-identical to the global
    one); ``push`` partitions the src-sorted out-edges by source range.
    ``out_deg`` / ``in_deg`` are the degree vectors padded to ``d * ns``.
    Everything is on the plan's device; an Exec keeps its own rank's block.
    """

    d: int                     # shard count
    ns: int                    # vertices per shard (ceil(n / d), >= 1)
    pull: _ShardDir
    push: _ShardDir
    out_deg: torch.Tensor      # (d*ns,) padded
    in_deg: torch.Tensor       # (d*ns,) padded

    def halo_bytes_per_round(self, itemsize: int = 4) -> int:
        """Bytes each shard receives from one pull-side halo all-gather."""
        return self.d * self.pull.halo * itemsize


def _build_shard_dir(key: torch.Tensor, other: torch.Tensor, d: int,
                     ns: int) -> _ShardDir:
    """Partition one edge order by contiguous ``key`` ranges.

    ``key`` is the sorted segment endpoint (dst for pull, src for push),
    ``other`` the gathered endpoint.  Shard ``i`` owns vertices
    ``[i*ns, (i+1)*ns)`` and the contiguous edge slice whose keys fall in
    that range.  A cut edge (``other`` owned elsewhere) reads the halo:
    owner ``o`` exports its sorted unique referenced vertices, and the edge
    reads flat halo position ``ns + o*halo + rank``.

    The arrays are the reference's (``repro/core/plan.py``'s
    ``_build_shard_dir``, NumPy on the host with a ``np.unique`` per owner)
    element for element; here integer tensor ops on the plan's device build
    them: one mark array over the vertices gives every owner's sorted set
    and each vertex's rank in it.  The host reads the ``2 (d + 1)`` shard
    and halo offsets that size the arrays.
    """
    dev = key.device
    e = int(key.shape[0])
    key, other = key.long(), other.long()
    cuts = torch.arange(d + 1, device=dev) * ns
    shard_of = key // ns
    owner_of = other // ns
    remote = owner_of != shard_of
    mark = torch.zeros((d * ns,), dtype=torch.bool, device=dev)
    mark[other[remote]] = True
    counts = torch.cat([torch.searchsorted(key, cuts),
                        torch.cumsum(mark.view(d, ns).sum(1), 0)])
    offsets = counts.tolist()                  # the one host read
    bounds, first = offsets[: d + 1], [0] + offsets[d + 1:]
    es = max(max(b - a for a, b in zip(bounds, bounds[1:])), 1)
    halo = max(max(b - a for a, b in zip(first, first[1:])), 1)
    bounds_t = counts[: d + 1]
    first_t = torch.tensor(first, device=dev)
    bnd_all = torch.nonzero(mark)[:, 0]        # every owner's set, in order
    bnd_owner = bnd_all // ns
    boundary = torch.zeros((d * halo,), dtype=torch.int32, device=dev)
    boundary[bnd_owner * halo + torch.arange(bnd_all.shape[0], device=dev)
             - first_t[bnd_owner]] = (bnd_all - bnd_owner * ns).int()
    rank_of = torch.cumsum(mark, 0) - 1        # rank among all marked ids
    gidx_e = torch.where(remote,
                         ns + owner_of * halo + rank_of[other]
                         - first_t[owner_of],
                         other - shard_of * ns)
    flat = shard_of * es + torch.arange(e, device=dev) - bounds_t[shard_of]
    gidx = torch.zeros((d * es,), dtype=torch.int32, device=dev)
    seg = torch.full((d * es,), ns, dtype=torch.int32, device=dev)
    gidx[flat] = gidx_e.int()
    seg[flat] = (key - shard_of * ns).int()
    return _ShardDir(es=es, halo=halo, gather_idx=gidx, seg_local=seg,
                     edge_slot=flat.int(), boundary=boundary,
                     bounds=tuple(bounds))


def _host(t: torch.Tensor):
    return t.cpu().numpy()


def _storage_key(t: torch.Tensor) -> Tuple[str, int]:
    st = t.untyped_storage()
    return (str(t.device), st.data_ptr())


def _tree_bytes(obj, seen: set) -> int:
    """Bytes of the tensors in a nested structure, each storage once.

    ``seen`` holds the storages already charged elsewhere (the graph's CSR
    arrays, a parent plan's families), so a view, an alias or an Exec's
    reference to a plan array is never charged twice.  A tensor is charged
    its whole storage: what the card holds for it.
    """
    if obj is None:
        return 0
    if isinstance(obj, (tuple, list)):
        return sum(_tree_bytes(x, seen) for x in obj)
    if isinstance(obj, dict):
        return sum(_tree_bytes(x, seen) for x in obj.values())
    if isinstance(obj, Graph):
        total = _tree_bytes(_csr_arrays(obj), seen)
        if obj._plan is not None:
            total += sum(obj._plan.nbytes_by_family().values())
        return total
    if torch.is_tensor(obj):
        key = _storage_key(obj)
        if key in seen:
            return 0
        seen.add(key)
        return int(obj.untyped_storage().nbytes())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_tree_bytes(getattr(obj, f.name), seen)
                   for f in dataclasses.fields(obj))       # Exec objects
    return 0


def _csr_arrays(g: Graph) -> Tuple[torch.Tensor, ...]:
    return (g.node_ids, g.out_ptr, g.out_idx, g.in_ptr, g.in_idx)


def _degree_fields(g: Graph):
    """(out_deg, in_deg, inv_out_deg, dangling) from the graph's pointers."""
    out_deg = g.out_degrees()
    out_deg_f = out_deg.to(torch.float32)
    inv_out_deg = torch.where(out_deg > 0,
                              1.0 / torch.clamp_min(out_deg_f, 1.0),
                              torch.zeros_like(out_deg_f))
    return out_deg, g.in_degrees(), inv_out_deg, out_deg == 0


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
    _csr_out: Optional[Tuple] = field(default=None, repr=False, compare=False)
    _csr_in: Optional[Tuple] = field(default=None, repr=False, compare=False)
    _in_perm_out: Optional[torch.Tensor] = field(default=None, repr=False,
                                                 compare=False)
    _sharded: Dict = field(default_factory=dict, repr=False, compare=False)
    # delta lineage (set by :meth:`patch` only): dense ids of the vertices
    # the delta touched, the parent's plan, and the _DeltaInfo it came from
    dirty_vertices: Optional[torch.Tensor] = field(default=None, repr=False,
                                                   compare=False)
    _parent: Optional["GraphPlan"] = field(default=None, repr=False,
                                           compare=False)
    _info: Optional[object] = field(default=None, repr=False, compare=False)

    @classmethod
    def build(cls, g: Graph) -> "GraphPlan":
        in_src, in_dst = g.in_edges()
        out_src, out_dst = g.out_edges()
        out_deg, in_deg, inv_out_deg, dangling = _degree_fields(g)
        return cls(graph=g, n_nodes=g.n_nodes, n_edges=g.n_edges,
                   in_src=in_src, in_dst=in_dst,
                   out_src=out_src, out_dst=out_dst,
                   out_deg=out_deg, in_deg=in_deg,
                   inv_out_deg=inv_out_deg, dangling=dangling)

    @classmethod
    def patch(cls, g: Graph, info) -> "GraphPlan":
        """Derive the plan from the parent's instead of re-deriving edges.

        ``info`` is the ``_DeltaInfo`` of ``Graph.apply_delta``'s fast
        path: its merged edge lists in both CSR orders are the eager fields
        as they are (no sort, no ``_row_of_edge``, no copy), and degrees
        are differences of the child's row pointers.  The lazy families
        patch the parent's where that is sound and rebuild otherwise;
        ``dirty_vertices`` marks the vertices the delta touched.
        """
        parent = info.parent.plan()
        out_deg, in_deg, inv_out_deg, dangling = _degree_fields(g)
        return cls(graph=g, n_nodes=g.n_nodes, n_edges=g.n_edges,
                   in_src=info.in_src, in_dst=info.in_dst,
                   out_src=info.out_src, out_dst=info.out_dst,
                   out_deg=out_deg, in_deg=in_deg,
                   inv_out_deg=inv_out_deg, dangling=dangling,
                   dirty_vertices=info.dirty, _parent=parent, _info=info)

    @property
    def device(self) -> torch.device:
        return self.graph.device

    # -- lazy derived structures -------------------------------------------------
    def undirected(self) -> Graph:
        """Symmetrized simple-graph view, built once per plan.

        For an insert-only delta child this patches the parent's view with
        ``apply_delta`` (the inserted non-loop edges, both ways, in
        original ids) instead of re-symmetrizing the whole graph; the
        patched view carries lineage of its own, which is what lets
        incremental connected components warm-start.  A delta with deletes
        rebuilds.
        """
        if self._undirected is None:
            info = self._info
            if info is not None and info.insert_only:
                osrc = self.graph.original_of(info.add_src)
                odst = self.graph.original_of(info.add_dst)
                keep = osrc != odst
                osrc, odst = osrc[keep], odst[keep]
                self._undirected = self._parent.undirected().apply_delta(
                    EdgeDelta.inserts(torch.cat([osrc, odst]),
                                      torch.cat([odst, osrc])))
            else:
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

    def csr_out(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Out-CSR for frontier gathers: ``(ptr, idx, deg_pad)``.

        ``ptr`` is the trimmed ``(n+1,)`` row-pointer prefix, ``idx`` the
        capacity-padded neighbour array, and ``deg_pad`` an ``(n+1,)``
        degree vector whose sentinel row ``n`` (the frontier's pad vertex)
        has degree 0, so padded frontier slots own no edges.
        """
        if self._csr_out is None:
            self._csr_out = self._csr(self.graph.out_ptr,
                                      self.graph.out_idx, self.out_deg)
        return self._csr_out

    def csr_in(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """In-CSR ``(ptr, idx, deg_pad)``, the pull-side dual of
        :meth:`csr_out`; the dense pull reduces over the sorted edge arrays,
        so nothing in the engine reads it yet."""
        if self._csr_in is None:
            self._csr_in = self._csr(self.graph.in_ptr, self.graph.in_idx,
                                     self.in_deg)
        return self._csr_in

    def _csr(self, ptr, idx, deg):
        deg_pad = torch.cat([deg, torch.zeros((1,), dtype=deg.dtype,
                                              device=deg.device)])
        return ptr[: self.n_nodes + 1], idx, deg_pad

    def in_perm_out(self) -> torch.Tensor:
        """Permutation ``p`` with ``w_out = w_in[p]`` (int32).

        Per-edge values follow the sssp convention (in-edge order); the
        frontier push walks out-edge CSR order.  ``p[j]`` is the in-order
        position of the j-th out-order edge: sorting the in-order edges by
        (src, dst) gives out order.  A patched plan without duplicate edges
        finds it by one ``searchsorted`` over pair keys instead.
        """
        if self._in_perm_out is None:
            p = None if self._info is None else _delta_in_perm_out(self._info)
            if p is None:
                p = _lexsort(self.in_dst, self.in_src).to(torch.int32)
            self._in_perm_out = p
        return self._in_perm_out

    def bsr(self, block: int = DEFAULT_BLOCK
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
        """Unweighted BSR tiles of M[dst, src] (the pull/SpMV layout)."""
        if block not in self._bsr:
            self._bsr[block] = self._patched_bsr(block, transpose=False) \
                or edges_to_bsr(_host(self.in_src), _host(self.in_dst),
                                self.n_nodes, block=block, device=self.device)
        return self._bsr[block]

    def bsr_t(self, block: int = DEFAULT_BLOCK
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
        """Transpose BSR tiles: M[src, dst] (the push/SpMV layout)."""
        if block not in self._bsr_t:
            # edges_to_bsr(a, b) builds M[b, a]: pass (dst, src) for M[src, dst]
            self._bsr_t[block] = self._patched_bsr(block, transpose=True) \
                or edges_to_bsr(_host(self.out_dst), _host(self.out_src),
                                self.n_nodes, block=block, device=self.device)
        return self._bsr_t[block]

    def _patched_bsr(self, block: int, transpose: bool):
        """The parent's tiles plus the inserted edges, when that is sound.

        Sound iff the delta is insert-only (a deleted pair's tile decrement
        would need its multiplicity in the parent) and every insert lands
        in a tile the parent already holds: the tile structure is then
        unchanged, so ``rows`` / ``cols`` (and the triples built on them)
        are the parent's own tensors.  The scatter-add goes into a clone,
        leaving the parent's tiles as they were; inserts are deduped by
        ``apply_delta``, so each adds exactly 1.0.
        """
        info = self._info
        if info is None or not info.insert_only:
            return None
        cache = self._parent._bsr_t if transpose else self._parent._bsr
        if block not in cache:
            return None
        tiles, rows, cols, nb = cache[block]
        if info.add_src.numel() == 0:
            return (tiles, rows, cols, nb)
        if transpose:
            rv, cv = info.add_src.long(), info.add_dst.long()   # M[src, dst]
        else:
            rv, cv = info.add_dst.long(), info.add_src.long()   # M[dst, src]
        pkeys = rows.long() * nb + cols.long()
        if pkeys.numel() == 0:
            return None
        order = torch.argsort(pkeys, stable=True)
        sorted_keys = pkeys[order]
        want = (rv // block) * nb + cv // block
        pos = torch.clamp(torch.searchsorted(sorted_keys, want),
                          max=pkeys.numel() - 1)
        if not bool((sorted_keys[pos] == want).all()):
            return None   # an insert opens a brand-new tile -> rebuild
        new_tiles = tiles.clone()
        new_tiles.index_put_((order[pos], rv % block, cv % block),
                             torch.ones_like(rv, dtype=tiles.dtype),
                             accumulate=True)
        return (new_tiles, rows, cols, nb)

    def tri_triples(self, block: int = DEFAULT_BLOCK
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Tile triples (I,J),(I,K),(K,J) for the BSR triangle kernel; a
        patched plan whose tiles kept the parent's structure (the same
        ``rows`` tensor) reuses the parent's triples."""
        if block not in self._tri_triples:
            _, rows, cols, _ = self.bsr(block)
            parent = self._parent
            if parent is not None and block in parent._tri_triples \
                    and block in parent._bsr and parent._bsr[block][1] is rows:
                self._tri_triples[block] = parent._tri_triples[block]
            else:
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

    def sharded(self, n_shards: int) -> ShardPlan:
        """Vertex-range partition over ``n_shards`` shards, memoized per
        count.

        Built once on the plan's device from the already-sorted edge
        arrays (the range split is one ``searchsorted`` per direction); it
        needs no process group.  A delta child starts
        with an empty cache, so ``apply_delta`` invalidation follows from
        plan identity like every other family, and :meth:`evict` can drop
        the whole dict: the next touch rebuilds bit for bit.
        """
        d = int(n_shards)
        if d < 1:
            raise ValueError(f"sharded() needs >= 1 shard, got {d}")
        if d not in self._sharded:
            n = self.n_nodes
            ns = max(-(-n // d), 1)
            pull = _build_shard_dir(self.in_dst, self.in_src, d, ns)
            push = _build_shard_dir(self.out_src, self.out_dst, d, ns)
            pad = (0, d * ns - n)
            self._sharded[d] = ShardPlan(
                d=d, ns=ns, pull=pull, push=push,
                out_deg=torch.nn.functional.pad(self.out_deg, pad),
                in_deg=torch.nn.functional.pad(self.in_deg, pad))
        return self._sharded[d]

    def _device_layout(self, layout):
        entry_chunk, entry_slot, local_ids, chunk_block, nb, total = layout
        dev = self.device
        return (torch.from_numpy(entry_chunk).to(dev),
                torch.from_numpy(entry_slot).to(dev),
                torch.from_numpy(local_ids).to(dev),
                torch.from_numpy(chunk_block).to(dev), nb, total)

    # -- byte accounting and eviction -------------------------------------------
    def _families(self) -> Dict[str, object]:
        """Family name -> the cached member(s) it covers (None/{} = cold)."""
        info = self._info
        return {
            "base": (self.in_src, self.in_dst, self.out_src, self.out_dst,
                     self.out_deg, self.in_deg, self.inv_out_deg,
                     self.dangling),
            "undirected": self._undirected,
            "oriented": self._oriented,
            "csr": (self._csr_out, self._csr_in),
            "perm": self._in_perm_out,
            "bsr": (self._bsr, self._bsr_t),
            "tri": self._tri_triples,
            "chunks": (self._chunks_in, self._chunks_out),
            "sharded": self._sharded,
            "execs": self.execs,
            "lineage": None if info is None else (
                info.add_src, info.add_dst, info.del_src, info.del_dst,
                info.dirty, info.out_src, info.out_dst, info.in_src,
                info.in_dst),
        }

    def _shared_storages(self) -> set:
        """Storages charged to someone else: the graph's CSR arrays and, for
        a patched plan, everything the parent plan and graph hold."""
        seen = {_storage_key(a) for a in _csr_arrays(self.graph)}
        parent = self._parent
        if parent is not None:
            for member in parent._families().values():
                _tree_bytes(member, seen)
            seen |= {_storage_key(a) for a in _csr_arrays(parent.graph)}
        return seen

    def nbytes_by_family(self) -> Dict[str, int]:
        """Bytes this plan holds on its device, per family, each storage
        once.  ``base`` is the eager arrays (never evictable); ``lineage``
        the ``_DeltaInfo`` arrays a patched plan keeps that ``base`` does
        not already hold.  Families in :data:`EVICTABLE_FAMILIES` can be
        dropped with :meth:`evict` and re-derive bit for bit."""
        seen = self._shared_storages()
        return {name: _tree_bytes(member, seen)
                for name, member in self._families().items()}

    def nbytes(self) -> int:
        """Total bytes held by this plan (shared storage excluded)."""
        return sum(self.nbytes_by_family().values())

    def evictable_bytes(self) -> int:
        fams = self.nbytes_by_family()
        return sum(fams[f] for f in EVICTABLE_FAMILIES)

    def evict(self, family: str) -> int:
        """Drop one re-derivable family; returns the bytes it held.

        Every lazy getter rebuilds deterministically, so results stay
        bit-identical.  Evicting any family also drops the cached Execs,
        which hold references to family tensors and would keep them alive.
        """
        if family not in EVICTABLE_FAMILIES:
            raise ValueError(f"family {family!r} is not evictable; "
                             f"have {EVICTABLE_FAMILIES}")
        fams = self.nbytes_by_family()
        freed = fams[family]
        if family == "undirected":
            self._undirected = None
        elif family == "oriented":
            self._oriented = None
        elif family == "csr":
            self._csr_out = self._csr_in = None
        elif family == "perm":
            self._in_perm_out = None
        elif family == "bsr":
            self._bsr, self._bsr_t = {}, {}
        elif family == "tri":
            self._tri_triples = {}
        elif family == "chunks":
            self._chunks_in, self._chunks_out = {}, {}
        elif family == "sharded":
            self._sharded = {}
        if family != "execs":
            freed += fams["execs"]
        self.execs = {}
        return freed

    def evict_all(self) -> int:
        """Drop every re-derivable family; returns the bytes freed."""
        return sum(self.evict(f) for f in EVICTABLE_FAMILIES)


def _delta_in_perm_out(info) -> Optional[torch.Tensor]:
    """The weight permutation from a delta's merged edge lists, on their
    device (the reference's ``_host_in_perm_out``).

    The in-order list ascends in ``(dst, src)``, so the in-order slot of
    each out-order edge is one ``searchsorted`` over int64 pair keys.
    Duplicate edges make the key -> slot map ambiguous: None, and the
    caller takes the stable lexsort.
    """
    ki = (info.in_dst.long() << 32) | info.in_src.long()
    if ki.numel() and bool((ki[1:] == ki[:-1]).any()):
        return None
    ko = (info.out_dst.long() << 32) | info.out_src.long()
    return torch.searchsorted(ki, ko).to(torch.int32)
