"""Distributed graph engine over the ranks of a ``torch.distributed`` world.

Counterpart of ``repro/core/distributed.py``.  The reference maps Ringo's
per-thread partitions onto ``shard_map`` over a JAX mesh; here each shard is
one rank (``repro_torch.launch.mesh.graph_group``), which holds its own
block of every per-shard array:

* **node space** is range-partitioned into ``d`` contiguous shards of
  ``ns = ceil(n / d)`` ids;
* **edges live with their destination's owner**, so the PageRank scatter is
  shard-local and the only collective of a round is the rank-vector
  all-gather (plus the one-scalar dangling sum);
* **conversion** is the distributed sort-first: a local bucket sort by
  owner, one ``all_to_all`` to ship the edges home, a local sort-first
  build.

Float sums across ranks are all-gathers of the partials, added in rank
order, so every rank holds the same bits whatever the backend (NCCL or
gloo) would have summed in; integer sums are ``all_reduce`` (exact).  The
2-D PageRank runs on a ``side x side`` world (``graph_grid``) with a row and
a column group per rank; the reference's grid transpose (``ppermute``) is a
paired exchange.

Every function here is collective: each rank of the group calls it with the
same arguments (the same graph, built from the same seed), in the same
order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from . import engine
from .graph import Graph, _lexsort
from ..device import DeviceLike, resolve
from ..launch.mesh import GridGroups, ShardGroup, graph_grid, graph_group

__all__ = [
    "DistGraph",
    "shard_graph",
    "pagerank_distributed",
    "distributed_to_graph",
    "triangle_count_distributed",
    "degrees_distributed",
    "DistGraph2D",
    "shard_graph_2d",
    "pagerank_distributed_2d",
]

_I32 = torch.int32


def _group(group: Optional[ShardGroup]) -> ShardGroup:
    return graph_group(engine.shard_count()) if group is None else group


def _seg_lengths(seg: torch.Tensor, valid: torch.Tensor,
                 n_seg: int) -> torch.Tensor:
    """Run lengths of sorted segment ids with the invalid slots (which
    trail the valid ones) as one last segment ``n_seg``."""
    return torch.bincount(torch.where(valid, seg.long(), n_seg),
                          minlength=n_seg + 1)


def _sorted_sum(vals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Segment sums in slot order (``lengths`` covers every slot); the same
    bits on every run, unlike atomics."""
    return torch.segment_reduce(vals, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def _ordered_sum(group: ShardGroup, x: torch.Tensor) -> torch.Tensor:
    """Sum of a scalar over the group, added in rank order."""
    return group.all_gather_cat(x.reshape(1)).sum()


# ---------------------------------------------------------------------------
# sharded graph container
# ---------------------------------------------------------------------------


@dataclass
class DistGraph:
    """This rank's destination-partitioned edges and node range.

    Rank ``k`` owns nodes ``[k*ns, (k+1)*ns)`` and every in-edge pointing to
    them, valid edges first, sorted by destination:

      src:       (es,)  global src id per edge slot
      dst_local: (es,)  dst id within the owned range (0 in padding)
      evalid:    (es,)  edge validity (padding is False)
      seg_len:   (ns+1,) run lengths of the owned destinations, then the
                 padding's (the port's addition: the sorted float sum)
      out_deg:   (ns,)  out-degree of each owned node (float32)
      nvalid:    (ns,)  node validity
    """

    n_nodes: int
    n_edges: int
    ns: int            # nodes per shard
    es: int            # edge slots per shard
    group: ShardGroup
    src: torch.Tensor
    dst_local: torch.Tensor
    evalid: torch.Tensor
    seg_len: torch.Tensor
    out_deg: torch.Tensor
    nvalid: torch.Tensor


def _node_range(group: ShardGroup, ns: int, n: int, dev) -> torch.Tensor:
    k = group.rank
    return torch.arange(k * ns, (k + 1) * ns, device=dev) < n


def shard_graph(g: Graph, group: Optional[ShardGroup] = None) -> DistGraph:
    """This rank's shard of ``g`` (every rank holds the whole ``g``)."""
    group = _group(group)
    d, k = group.d, group.rank
    n, dev = g.n_nodes, g.device
    ns = -(-max(n, 1) // d)
    src, dst = g.in_edges()                       # sorted by dst
    cuts = torch.clamp(torch.arange(d + 1, device=dev) * ns, max=n)
    bounds = torch.searchsorted(dst, cuts.to(dst.dtype)).tolist()
    es = max(max(b - a for a, b in zip(bounds, bounds[1:])), 1)
    lo, hi = bounds[k], bounds[k + 1]
    c = hi - lo
    src_l = torch.zeros((es,), dtype=_I32, device=dev)
    dst_l = torch.zeros((es,), dtype=_I32, device=dev)
    valid = torch.zeros((es,), dtype=torch.bool, device=dev)
    src_l[:c] = src[lo:hi]
    dst_l[:c] = dst[lo:hi] - k * ns
    valid[:c] = True
    deg = torch.zeros((d * ns,), dtype=torch.float32, device=dev)
    deg[:n] = g.out_degrees().to(torch.float32)
    return DistGraph(n_nodes=n, n_edges=g.n_edges, ns=ns, es=es, group=group,
                     src=src_l, dst_local=dst_l, evalid=valid,
                     seg_len=_seg_lengths(dst_l, valid, ns),
                     out_deg=deg[k * ns:(k + 1) * ns],
                     nvalid=_node_range(group, ns, n, dev))


# ---------------------------------------------------------------------------
# distributed PageRank
# ---------------------------------------------------------------------------


def _inv(deg: torch.Tensor) -> torch.Tensor:
    return torch.where(deg > 0, 1.0 / torch.clamp_min(deg, 1.0),
                       torch.zeros_like(deg))


def _pagerank_round(group: ShardGroup, src: torch.Tensor,
                    evalid: torch.Tensor, seg_len: torch.Tensor,
                    inv_src: torch.Tensor, pr: torch.Tensor,
                    dangling: torch.Tensor, n: int, ns: int, damping: float,
                    compress_bf16: bool) -> torch.Tensor:
    """One PageRank round on this rank's shard: gather the ranks (as
    bfloat16 with ``compress_bf16``), sum each valid edge's ``pr[src] /
    deg[src]`` into its destination in slot order, add the dangling mass
    summed over the group in rank order.  ``inv_src`` is 1/deg of each
    edge slot's source; returns the ``ns`` new ranks."""
    msg = pr.to(torch.bfloat16) if compress_bf16 else pr
    pr_full = group.all_gather_cat(msg).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=src.device)
    contrib = torch.where(evalid, pr_full[src] * inv_src, zero)
    local = _sorted_sum(contrib, seg_len)[:ns]
    dang = _ordered_sum(group, torch.where(dangling, pr, zero).sum())
    return (1.0 - damping) / n + damping * (local + dang / n)


def pagerank_distributed(dg: DistGraph, n_iter: int = 10,
                         damping: float = 0.85,
                         compress_bf16: bool = False) -> torch.Tensor:
    """Edge-partitioned PageRank; returns the whole rank vector on every
    rank.

    Per round: all-gather the rank shards, gather each local edge's source
    contribution, sum it into the owned destination range.
    ``compress_bf16`` sends the rank shards as bfloat16 (half the bytes).
    """
    group, n = dg.group, dg.n_nodes
    src = dg.src.long()
    inv_src = group.all_gather_cat(_inv(dg.out_deg))[src]
    dangling = (dg.out_deg == 0.0) & dg.nvalid
    zero = torch.zeros_like(dg.out_deg)
    pr = torch.where(dg.nvalid, torch.full_like(zero, 1.0 / n), zero)
    for _ in range(int(n_iter)):
        new = _pagerank_round(group, src, dg.evalid, dg.seg_len, inv_src, pr,
                              dangling, n, dg.ns, damping, compress_bf16)
        pr = torch.where(dg.nvalid, new, zero)
    return group.all_gather_cat(pr)[:n]


# ---------------------------------------------------------------------------
# distributed sort-first conversion (edge table -> DistGraph)
# ---------------------------------------------------------------------------


def distributed_to_graph(src, dst, n_nodes: int,
                         group: Optional[ShardGroup] = None, *,
                         device: DeviceLike = None) -> DistGraph:
    """The paper's sort-first conversion, distributed.

    Every rank is given the whole ``(src, dst)`` dense-id edge list and
    takes its row block ``k`` of ``ceil(E / d)``; it (1) bucket-sorts its
    rows by destination owner, (2) ships each bucket to its owner with one
    ``all_to_all``, (3) sorts what it received by (destination, source)
    and counts out-degrees, summed over the ranks.  ``device`` defaults to
    ``src``'s when it is a tensor, else to the card.
    """
    group = _group(group)
    d, k = group.d, group.rank
    dev = src.device if torch.is_tensor(src) and device is None \
        else resolve(device)
    src = torch.as_tensor(src, device=dev).to(_I32)
    dst = torch.as_tensor(dst, device=dev).to(_I32)
    ns = -(-max(n_nodes, 1) // d)
    e = int(src.shape[0])
    per = max(-(-e // d), 1)
    pad = per * d - e
    src = torch.cat([src, torch.zeros((pad,), dtype=_I32, device=dev)])
    dst = torch.cat([dst, torch.full((pad,), -1, dtype=_I32, device=dev)])
    valid = torch.arange(per * d, device=dev) < e
    owner = torch.where(valid, dst.long() // ns, d)    # invalid -> bucket d
    # bucket capacity: the most rows one block sends to one owner
    rows = torch.arange(per * d, device=dev) // per
    counts = torch.bincount(rows * (d + 1) + owner, minlength=d * (d + 1))
    cap = max(int(counts.view(d, d + 1)[:, :d].max()), 1)

    mine = slice(k * per, (k + 1) * per)
    s, t, own = src[mine], dst[mine], owner[mine]
    order = torch.argsort(own, stable=True)            # local bucket sort
    s, t, own = s[order], t[order], own[order]
    buckets = torch.arange(d, device=dev)
    starts = torch.searchsorted(own, buckets)
    ends = torch.searchsorted(own, buckets, right=True)
    idx = starts[:, None] + torch.arange(cap, device=dev)[None, :]
    in_bucket = idx < ends[:, None]
    idx = torch.clamp(idx, max=per - 1)
    zero = torch.zeros((), dtype=_I32, device=dev)
    payload = torch.stack([torch.where(in_bucket, s[idx], zero),
                           torch.where(in_bucket, t[idx], zero),
                           in_bucket.to(_I32)], dim=1)   # (d, 3, cap)
    got = group.all_to_all(payload).view(d, 3, cap)    # bucket k of each
    s, t, v = (got[:, j].reshape(-1) for j in range(3))
    v = v.bool()

    tl = torch.where(v, t - k * ns, ns)                # local dst; pad -> ns
    order = _lexsort(s, tl)
    s, tl, v = s[order], tl[order], v[order]
    src_counts = torch.bincount(torch.where(v, s.long(), ns * d),
                                minlength=ns * d + 1)[: ns * d]
    out_deg = group.all_reduce_sum(src_counts)[k * ns:(k + 1) * ns]
    dst_local = torch.where(v, tl, zero)
    return DistGraph(n_nodes=n_nodes, n_edges=e, ns=ns, es=d * cap,
                     group=group, src=s, dst_local=dst_local, evalid=v,
                     seg_len=_seg_lengths(dst_local, v, ns),
                     out_deg=out_deg.to(torch.float32),
                     nvalid=_node_range(group, ns, n_nodes, dev))


# ---------------------------------------------------------------------------
# distributed triangle counting and degrees
# ---------------------------------------------------------------------------


def triangle_count_distributed(g: Graph, group: Optional[ShardGroup] = None,
                               edge_chunk: int = 1 << 14) -> int:
    """Oriented-edge-partitioned triangle counting.

    Rank ``k`` intersects the neighbourhoods of its block of the
    degeneracy-oriented edges (the same sorted-adjacency core as
    ``algorithms.triangle_count``) against the adjacency every rank holds;
    an int64 ``all_reduce`` sums the counts.
    """
    from .algorithms import _triangle_hits
    group = _group(group)
    if g.n_edges == 0 or g.n_nodes == 0:
        return 0
    plan = g.plan()
    e = int(plan.oriented()[0].shape[0])
    per = -(-e // group.d)
    lo = min(group.rank * per, e)
    hi = min(lo + per, e)
    total = torch.zeros((1,), dtype=torch.int64, device=g.device)
    for c0 in range(lo, hi, edge_chunk):
        total += _triangle_hits(plan, c0, min(c0 + edge_chunk, hi))[3].sum()
    return int(group.all_reduce_sum(total))


def degrees_distributed(dg: DistGraph) -> torch.Tensor:
    """In-degrees (int32) from the sharded structure, on every rank."""
    deg = torch.zeros((dg.ns,), dtype=_I32, device=dg.src.device)
    deg.index_add_(0, dg.dst_local.long(), dg.evalid.to(_I32))
    return dg.group.all_gather_cat(deg)[: dg.n_nodes]


# ---------------------------------------------------------------------------
# 2-D (SUMMA-style) PageRank
# ---------------------------------------------------------------------------
#
# The 1-D engine all-gathers the whole rank vector every round (N floats per
# rank).  A square 2-D partition gives rank (r, c) the edges with dst in
# block r and src in block c; the rank vector lives in N/d²-sized "shuffle
# layout" slices.  Per round each rank gathers only its column block (N/d
# values, over its column group) and reduce-scatters its partial sums (N/d
# values, over its row group): Θ(N/d) traffic instead of Θ(N).


@dataclass
class DistGraph2D:
    """Rank ``(r, c)``'s edges of a square 2-D partition: dst in block
    ``r``, src in block ``c``, sorted by dst (valid edges first)."""

    n_nodes: int
    n_edges: int
    nb: int                  # nodes per block (N padded to d * nb)
    es: int                  # edge slots per rank
    d: int                   # grid side
    grid: GridGroups
    src_local: torch.Tensor  # (es,) src offset within column block c
    dst_local: torch.Tensor  # (es,) dst offset within row block r
    evalid: torch.Tensor     # (es,)
    seg_len: torch.Tensor    # (nb+1,) run lengths of dst_local, then pad
    inv_deg_col: torch.Tensor  # (nb,) 1/out-degree over column block c


def _grid(grid: Optional[GridGroups]) -> GridGroups:
    if grid is not None:
        return grid
    world = engine.shard_count()
    side = math.isqrt(world)
    if side * side != world:
        raise ValueError(f"2-D PageRank needs a square world, got {world} "
                         f"rank(s)")
    return graph_grid(side)


def shard_graph_2d(g: Graph, grid: Optional[GridGroups] = None
                   ) -> DistGraph2D:
    """Rank ``(r, c)``'s block of the 2-D partition of ``g``."""
    grid = _grid(grid)
    d, r, c = grid.side, grid.r, grid.c
    n, dev = g.n_nodes, g.device
    nb = -(-max(n, 1) // d)
    src, dst = (x.long() for x in g.in_edges())       # sorted by dst
    mine = (dst // nb == r) & (src // nb == c)         # keeps dst order
    s, t = src[mine], dst[mine]
    cnt = int(torch.bincount((dst // nb) * d + src // nb,
                             minlength=d * d).max()) if g.n_edges else 0
    es = max(cnt, 1)
    m = int(s.shape[0])
    src_l = torch.zeros((es,), dtype=_I32, device=dev)
    dst_l = torch.zeros((es,), dtype=_I32, device=dev)
    valid = torch.zeros((es,), dtype=torch.bool, device=dev)
    src_l[:m] = (s % nb).to(_I32)
    dst_l[:m] = (t % nb).to(_I32)
    valid[:m] = True
    inv = torch.zeros((d * nb,), dtype=torch.float32, device=dev)
    inv[:n] = _inv(g.out_degrees().to(torch.float32))
    return DistGraph2D(n_nodes=n, n_edges=g.n_edges, nb=nb, es=es, d=d,
                       grid=grid, src_local=src_l, dst_local=dst_l,
                       evalid=valid, seg_len=_seg_lengths(dst_l, valid, nb),
                       inv_deg_col=inv[c * nb:(c + 1) * nb])


def pagerank_distributed_2d(dg: DistGraph2D, n_iter: int = 10,
                            damping: float = 0.85,
                            compress_bf16: bool = False,
                            unshuffle: bool = True) -> torch.Tensor:
    """2-D PageRank; returns the rank vector in natural node order on every
    rank.

    ``unshuffle=False`` returns the shuffle-layout vector (rank ``(r, c)``'s
    slice holds nodes ``[c*nb + r*sl, +sl)``), in which rounds compose.
    """
    grid = dg.grid
    n, nb, d, r, c = dg.n_nodes, dg.nb, dg.d, grid.r, grid.c
    sl = -(-nb // d)
    nb_pad = sl * d                 # a block splits evenly into d slices
    dev = dg.src_local.device
    inv_pad = torch.zeros((nb_pad,), dtype=torch.float32, device=dev)
    inv_pad[:nb] = dg.inv_deg_col
    src = dg.src_local.long()
    inv_src = inv_pad[src]
    # the partial sums' segments are the block's nb_pad rows, then padding
    lengths = torch.cat([dg.seg_len[:nb],
                         dg.seg_len.new_zeros((nb_pad - nb,)),
                         dg.seg_len[nb:]])
    valid = (torch.arange(sl, device=dev) + c * nb + r * sl) < n
    dangling = (inv_pad[:nb] == 0.0) & \
        ((torch.arange(nb, device=dev) + c * nb) < n)
    zero = torch.zeros((sl,), dtype=torch.float32, device=dev)
    x = torch.where(valid, torch.full_like(zero, 1.0 / n), zero)
    wire = torch.bfloat16 if compress_bf16 else torch.float32
    for _ in range(int(n_iter)):
        x_c = grid.col.all_gather_cat(x.to(wire)).to(torch.float32)
        contrib = torch.where(dg.evalid, x_c[src] * inv_src,
                              torch.zeros((), dtype=torch.float32,
                                          device=dev))
        partial = _sorted_sum(contrib, lengths)[:nb_pad]
        dang_local = torch.where(dangling, x_c[:nb],
                                 torch.zeros_like(x_c[:nb])).sum()
        # column block c is gathered by every row: scale by 1/d once
        dang = _ordered_sum(grid.col, _ordered_sum(grid.row, dang_local)) / d
        # reduce-scatter over the row: slice j of the partial goes to
        # column j, which adds the d slices it receives in column order
        y = grid.row.all_to_all(partial.to(wire)).view(d, sl) \
            .to(torch.float32).sum(0)
        # y is slice c of block r: the x-slot of rank (c, r)
        y_t = grid.transpose(y)
        x = torch.where(valid,
                        (1.0 - damping) / n + damping * (y_t + dang / n),
                        zero)
    out = grid.world.all_gather_cat(x)
    if not unshuffle:
        return out
    slices = out.view(d, d, sl)      # [r, c] = block c, sub-slice r
    return torch.cat([slices[:, cc, :].reshape(-1)[:nb]
                      for cc in range(d)])[:n]
