"""Cost cells for the paper's own workload: distributed PageRank at
Twitter2010/LiveJournal scale on the production mesh (counterpart of
``repro/launch/ringo_cells.py``).

The graph engine treats the pod as one big-memory machine: edges live with
their destination's owner across all 256 (or 512) ranks, the mesh axes
flattened into one graph axis, as ``core/distributed.py`` shards them.
Where the reference lowers one step of a ``shard_map`` over 256 host
devices, the port builds rank 0's shard on the meta device and runs one
step over counting groups (``launch/mesh.counting_group``,
``counting_graph_grid``) under ``launch/hlo_cost.CostCounter``.  The same
step runs on real tensors of the shard's shape on a card or the CPU
(``ringo_shard`` with ``device=``), which ``chip_smoke.py`` holds against
the CPU.

Each rank holds, in 1-D, ``ns = ceil(n / d)`` nodes and ``es = ceil(e /
d)`` edge slots (sorted by destination, with the port's ``seg_len`` run
lengths for its ordered segment sum); in 2-D, on the ``side x side``
single-pod grid, ``nb = ceil(n / side)`` nodes of its row and column
blocks and ``es = ceil(e / d)`` slots (``core/distributed.DistGraph2D``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from ..core.distributed import (DistGraph2D, _pagerank_round,
                                pagerank_distributed_2d)
from .hlo_cost import CostCounter, tree_bytes
from .mesh import (CollectiveLedger, ShardGroup, counting_graph_grid,
                   counting_group, make_production_mesh)

__all__ = ["GRAPHS", "pagerank_step_fn", "ringo_shard", "run_ringo_cell"]

META = torch.device("meta")

GRAPHS = {
    # paper Table 2
    "pagerank_twitter": dict(n_nodes=41_700_000, n_edges=1_470_000_000),
    "pagerank_livejournal": dict(n_nodes=4_850_000, n_edges=69_000_000),
    # §Perf variants: 2D SUMMA partition (Θ(N/d) collectives) ± bf16 wire
    "pagerank_twitter_2d": dict(n_nodes=41_700_000, n_edges=1_470_000_000,
                                partition="2d"),
    "pagerank_twitter_2d_bf16": dict(n_nodes=41_700_000,
                                     n_edges=1_470_000_000,
                                     partition="2d", compress=True),
    "pagerank_twitter_bf16": dict(n_nodes=41_700_000, n_edges=1_470_000_000,
                                  compress=True),
}


def pagerank_step_fn(group: ShardGroup, n_nodes: int, ns: int,
                     damping: float = 0.85, compress_bf16: bool = False
                     ) -> Callable[..., torch.Tensor]:
    """One distributed PageRank iteration over dst-partitioned edge shards:
    ``step(src, dst_local, evalid, seg_len, inv_deg_shard, pr_shard)`` ->
    this rank's new ``ns`` ranks.

    Gathers 1/deg, then runs the engine's own round
    (``core/distributed._pagerank_round``, which ``pagerank_distributed``
    loops over): the ranks gathered (as bfloat16 with ``compress_bf16``),
    each edge's contribution summed into its destination in slot order
    (the port's ``seg_len``: the run lengths of ``dst_local``, then the
    padding's) and the dangling mass summed over the group in rank order.
    ``dst_local`` is kept for the reference's signature; ``seg_len``
    carries the destinations.
    """

    def step(src, dst_local, evalid, seg_len, inv_deg_shard, pr_shard):
        s = src.long()
        inv_src = group.all_gather_cat(inv_deg_shard)[s]
        return _pagerank_round(group, s, evalid, seg_len, inv_src, pr_shard,
                               inv_deg_shard == 0.0, n_nodes, ns, damping,
                               compress_bf16)

    return step


def _sizes(g: Dict, d: int, side: int) -> Dict[str, int]:
    if g.get("partition") == "2d":
        return dict(nb=-(-g["n_nodes"] // side), es=-(-g["n_edges"] // d))
    return dict(ns=-(-g["n_nodes"] // d), es=-(-g["n_edges"] // d))


def ringo_shard(shape_name: str, multi_pod: bool = False, device=META,
                seed: Optional[int] = None,
                ledger: Optional[CollectiveLedger] = None):
    """(step, args, sizes, d) for rank 0 of the cell: ``step(*args)`` runs
    one PageRank iteration over counting groups noting in ``ledger``.

    On the meta device (the default) the arguments have the shard's shapes
    and no values.  With ``seed`` they hold random edges of those shapes:
    sorted destinations, every slot valid, sources over all ``n`` nodes,
    out-degrees in [0, 32) (a zero is a dangling node), ranks around 1/n.
    """
    g = GRAPHS[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    d, side = mesh.size, mesh.shape["data"]
    sz = _sizes(g, d, side)
    n, es = g["n_nodes"], sz["es"]
    two_d = g.get("partition") == "2d"
    nodes = sz["nb"] if two_d else sz["ns"]
    ledger = ledger or CollectiveLedger()
    if seed is None:
        def new(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=device)
        src = new((es,), torch.int32)
        dst = new((es,), torch.int32)
        valid = new((es,), torch.bool)
        seg_len = new((nodes + 1,), torch.int64)
        inv_deg = new((nodes,), torch.float32)
        pr = new((nodes,), torch.float32)
    else:
        gen = torch.Generator().manual_seed(seed)
        src = torch.randint(0, nodes if two_d else n, (es,), generator=gen,
                            dtype=torch.int32)
        dst = torch.sort(torch.randint(0, nodes, (es,), generator=gen,
                                       dtype=torch.int32)).values
        valid = torch.ones((es,), dtype=torch.bool)
        seg_len = torch.bincount(dst.long(), minlength=nodes + 1)
        out_deg = torch.randint(0, 32, (nodes,), generator=gen)
        inv_deg = torch.where(out_deg > 0, 1.0 / out_deg.clamp_min(1),
                              torch.zeros(())).float()
        pr = (torch.rand((nodes,), generator=gen) * 2.0 / n).float()
        src, dst, valid, seg_len, inv_deg, pr = (
            t.to(device) for t in (src, dst, valid, seg_len, inv_deg, pr))
    if two_d:
        dg = DistGraph2D(n_nodes=n, n_edges=g["n_edges"], nb=nodes, es=es,
                         d=side, grid=counting_graph_grid(side, ledger),
                         src_local=src, dst_local=dst, evalid=valid,
                         seg_len=seg_len, inv_deg_col=inv_deg)

        def step(dgx):
            return pagerank_distributed_2d(
                dgx, n_iter=1, compress_bf16=bool(g.get("compress")),
                unshuffle=False)
        return step, (dg,), sz, d
    fn = pagerank_step_fn(counting_group(d, 0, ledger), n, nodes,
                          compress_bf16=bool(g.get("compress")))
    return fn, (src, dst, valid, seg_len, inv_deg, pr), sz, d


def _arg_tensors(args) -> list:
    out = []
    for a in args:
        if isinstance(a, DistGraph2D):
            out += [a.src_local, a.dst_local, a.evalid, a.seg_len,
                    a.inv_deg_col]
        else:
            out.append(a)
    return out


def run_ringo_cell(shape_name: str, multi_pod: bool) -> Dict:
    """The cell's per-rank counts, keyed as the reference's result, less
    its ``xla_*`` keys, plus ``wire_bytes_per_device`` (the bytes the
    port's collectives make rank 0 receive) and ``shard`` (``ns`` / ``nb``
    and ``es``).  ``flops_per_device`` counts matrix products only (as the
    reference's walker counts ``dot`` ops), so a PageRank step counts 0;
    ``compile_s`` is the seconds the count took."""
    if shape_name not in GRAPHS:
        return {"arch": "ringo-graph", "shape": shape_name,
                "multi_pod": multi_pod, "status": "skipped",
                "reason": f"graph cells are {sorted(GRAPHS)}"}
    g = GRAPHS[shape_name]
    if g.get("partition") == "2d" and multi_pod:
        return {"arch": "ringo-graph", "shape": shape_name,
                "multi_pod": multi_pod, "status": "skipped",
                "reason": "2D partition defined on the square "
                          "single-pod grid; pods run independent rows"}
    t0 = time.time()
    ledger = CollectiveLedger()
    step, args, sz, d = ringo_shard(shape_name, multi_pod, ledger=ledger)
    with CostCounter(ledger) as c:
        out = step(*args)
    t1 = time.time()
    return {
        "arch": "ringo-graph", "shape": shape_name, "kind": "graph",
        "multi_pod": multi_pod, "status": "ok",
        "n_chips": int(d), "compile_s": round(t1 - t0, 1),
        **c.per_device(tree_bytes(_arg_tensors(args)), out),
        "graph": g,
        "shard": sz,
    }
