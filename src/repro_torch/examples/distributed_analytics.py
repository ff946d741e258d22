"""Distributed graph analytics on ``d`` ranks (the port's counterpart of
``examples/distributed_analytics.py``).

Spawns ``d`` processes that join one gloo process group (one rank a shard;
on the card every rank uses card ``rank % device_count``) and runs the
reference's steps through ``core/distributed.py``: 1-D PageRank, the
distributed sort-first conversion, triangles and, when ``d`` is a square,
2-D PageRank on a ``sqrt(d) x sqrt(d)`` grid; then one request to a
d-rank ``GraphService(engine_backend="sharded")`` (rank 0 serves, the
others follow).  Rank 0 prints each result's distance from the one-process
answer and the run fails unless the 1-D and 2-D PageRanks are within 1e-6
of it, the triangles equal and the service's PageRank equal bit for bit.

    PYTHONPATH=src python -m repro_torch.examples.distributed_analytics \\
        [--device cpu] [--ranks 4]
"""

from __future__ import annotations

import argparse
import datetime
import math
import multiprocessing as mp
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import algorithms as A
from repro_torch.core import distributed as D
from repro_torch.core.graph import Graph
from repro_torch.data.rmat import rmat_edges
from repro_torch.device import resolve
from repro_torch.launch.mesh import graph_grid, graph_group
from repro_torch.serve.graph_service import GraphService, serve_follower

JOIN_SECONDS = 600.0
TOL = 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(rank: int, d: int, port: int, device: str) -> None:
    """One rank: join the group, run every step, leave the group."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=d,
                            timeout=datetime.timedelta(seconds=120))
    try:
        run(dev)
        dist.barrier()          # no rank tears down while a peer is busy
    finally:
        dist.destroy_process_group()


def run(dev: torch.device) -> None:
    group = graph_group(dist.get_world_size())
    lead = group.rank == 0

    def say(*a):
        if lead:
            print(*a, flush=True)

    s, d = rmat_edges(scale=11, edge_factor=8, seed=2)
    keep = s != d
    g = Graph.from_edges(s[keep], d[keep], dedupe=True, device=dev)
    say(f"ranks: {group.d}; graph: {g.n_nodes} nodes, {g.n_edges} edges")
    pr_ref = A.pagerank(g, n_iter=10, backend="xla")
    errs = {}

    # 1-D: the ranks as one big-memory machine
    dg = D.shard_graph(g, group)
    pr = D.pagerank_distributed(dg, n_iter=10)
    errs["1d"] = float((pr - pr_ref).abs().max())
    say(f"1D pagerank max err vs local: {errs['1d']:.2e}")

    # distributed sort-first conversion (paper §2.4 across the ranks)
    sd, dd = g.out_edges()
    dg2 = D.distributed_to_graph(sd, dd, g.n_nodes, group)
    pr2 = D.pagerank_distributed(dg2, n_iter=10)
    errs["conversion"] = float((pr2 - pr_ref).abs().max())
    say(f"distributed-conversion pagerank err: {errs['conversion']:.2e}")

    # distributed triangles
    u = g.to_undirected()
    t_d = D.triangle_count_distributed(u, group, edge_chunk=2048)
    t_l = A.triangle_count(u, backend="xla")
    say(f"triangles: distributed={t_d} local={t_l}")

    # 2-D partition on a square grid of the ranks
    side = math.isqrt(group.d)
    if side * side == group.d and side > 1:
        dg3 = D.shard_graph_2d(g, graph_grid(side))
        pr3 = D.pagerank_distributed_2d(dg3, n_iter=10)
        errs["2d"] = float((pr3 - pr_ref).abs().max())
        say(f"2D pagerank err: {errs['2d']:.2e} ({side}x{side} grid)")
    else:
        say(f"2D pagerank: skipped ({group.d} ranks are not a square)")

    # one request to a d-rank "sharded" service
    if lead:
        svc = GraphService(engine_backend="sharded", device=dev)
        try:
            svc.workspace.put("g", g)
            got = svc.session("analyst").execute(
                {"op": "pagerank", "graph": "g", "params": {"n_iter": 10}})
        finally:
            svc.close()
        same = bool(torch.equal(got, pr_ref))
        say(f"service pagerank on {group.d} ranks equal to local: {same}")
        bad = {k: v for k, v in errs.items() if v > TOL}
        if bad or t_d != t_l or not same:
            raise RuntimeError(f"distributed results differ: errors {bad}, "
                               f"triangles {t_d} vs {t_l}, service {same}")
    else:
        serve_follower(device=dev)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args(argv)
    device = str(resolve(args.device))
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, args.ranks, port, device))
             for r in range(args.ranks)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_SECONDS
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10.0)
    codes = [p.exitcode for p in procs]
    if codes != [0] * args.ranks:
        print(f"ranks exited with {codes}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
