"""Spawned gloo worlds for the port's multi-rank tests (CPU).

``run_world(job, d, workdir)`` starts ``d`` processes with the ``spawn``
method; each joins a gloo process group over a ``FileStore`` in ``workdir``
(60 s timeout), runs ``job(*args)`` with one intra-op thread (the suite
already runs several pytest workers), and pickles what it returns.  The
parent joins the ranks against a deadline, kills any that outlive it, and
fails with every rank's traceback when a rank raised or hung: nothing a
rank raises is swallowed.  It returns the ranks' results in rank order.

Jobs live in this module (and import only torch, numpy and ``repro_torch``)
so a rank never imports jax or the reference.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import sys
import time
import traceback
from pathlib import Path

JOIN_SECONDS = 180.0


def _rank_main(rank: int, d: int, workdir: str, job, args) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = Path(workdir)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{out / 'store'}", rank=rank,
            world_size=d, timeout=datetime.timedelta(seconds=60))
        try:
            result = job(*args)
            dist.barrier()      # no rank tears down while a peer is busy
        finally:
            dist.destroy_process_group()
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_world(job, d: int, workdir, *args, timeout: float = JOIN_SECONDS):
    """Run ``job(*args)`` on each rank of a ``d``-rank gloo world."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, d, str(workdir), job, args), daemon=True)
             for r in range(d)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join(10.0)
    codes = [p.exitcode for p in procs]
    errs = {r: (workdir / f"rank{r}.err").read_text()
            for r in range(d) if (workdir / f"rank{r}.err").exists()}
    assert not hung and all(c == 0 for c in codes), (
        f"world of {d}: exit codes {codes}, hung ranks {hung} "
        f"(killed after {timeout} s)\n" + "\n".join(
            f"--- rank {r} ---\n{t}" for r, t in sorted(errs.items())))
    out = []
    for r in range(d):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# jobs (run on every rank)
# ---------------------------------------------------------------------------


def _np(x):
    import torch
    if isinstance(x, tuple):
        return tuple(_np(y) for y in x)
    return x.numpy() if torch.is_tensor(x) else x


SWEEP = ("cc", "bfs", "pagerank", "lp", "sssp")


def sssp_weights(n_edges: int):
    """The reference sweep's weights (``tests/test_oracle.py``)."""
    import numpy as np
    return np.round(np.random.default_rng(7).uniform(0.5, 4.0, n_edges),
                    1).astype(np.float32)


def analytics(g, backend: str) -> dict:
    """Every engine analytic of the port on ``g`` through ``backend``:
    the reference sweep's five (``SWEEP``), then the rest."""
    import torch
    from repro_torch.core import algorithms as A
    out = {"cc": A.connected_components(g, backend=backend),
           "pagerank": A.pagerank(g, n_iter=8, backend=backend),
           "lp": A.label_propagation(g, n_iter=6, backend=backend)}
    if g.n_nodes:
        w = torch.from_numpy(sssp_weights(g.n_edges))
        out["bfs"] = A.bfs(g, 0, backend=backend)
        out["sssp"] = A.sssp(g, 0, weights=w, backend=backend)
        src = torch.tensor([0, g.n_nodes - 1])
        out["bfs_batch"] = A.bfs(g, src, backend=backend)
        out["sssp_capped"] = A.sssp(g, 0, n_iter=2, backend=backend)
        out["ppr"] = A.personalized_pagerank(g, src, n_iter=5,
                                             backend=backend)
        out["ppr_tol"] = A.personalized_pagerank(g, 0, tol=1e-6,
                                                 backend=backend)
        out["closeness"] = A.closeness_centrality(g, n_samples=4,
                                                  backend=backend)
    out["pagerank_tol"] = A.pagerank(g, tol=1e-6, backend=backend)
    out["hits"] = A.hits(g, n_iter=6, backend=backend)
    out["eigenvector"] = A.eigenvector_centrality(g, n_iter=10,
                                                  backend=backend)
    out["k_core"] = A.k_core(g, 2, backend=backend)
    out["core_numbers"] = A.core_numbers(g, backend=backend)
    out["scc"] = A.strongly_connected_components(g, backend=backend)
    out["triangles"] = A.triangle_count(g.to_undirected(), backend=backend)
    return {k: _np(v) for k, v in out.items()}


def corpus_job() -> dict:
    """The corpus on "sharded" and "xla", the ShardedExec edge cases, and
    (on a world of 2) the exec cache keyed by shard count."""
    import os as _os

    import torch
    from _torch_oracles import build, corpus
    from repro_torch.core import engine
    from repro_torch.core.graph import Graph
    from repro_torch.launch.mesh import graph_group
    d = engine.shard_count()
    res = {"d": d, "rank": graph_group(d).rank, "corpus": {}}
    for entry in corpus():
        g = build(Graph, entry, device="cpu")
        res["corpus"][entry[0]] = {be: analytics(g, be)
                                   for be in ("sharded", "xla")}
    res["edge_cases"] = exec_edge_cases()
    if d == 2:
        g = build(Graph, corpus()[3], device="cpu")        # disconnected
        plan = g.plan()
        _os.environ["REPRO_SHARD_COUNT"] = "1"
        ex1 = engine.get_exec(plan, "sharded")
        _os.environ["REPRO_SHARD_COUNT"] = "2"
        ex2 = engine.get_exec(plan, "sharded")
        _os.environ["REPRO_SHARD_COUNT"] = "1"
        again = engine.get_exec(plan, "sharded")
        del _os.environ["REPRO_SHARD_COUNT"]
        res["exec_cache"] = {
            "distinct": ex1 is not ex2, "d": (ex1.d, ex2.d),
            "counts": sorted(plan._sharded), "memoized": again is ex1,
            "default_is_world": engine.get_exec(plan, "sharded") is ex2,
            "pull_d1": torch.equal(ex1.pull(torch.arange(g.n_nodes) * 1.0),
                                   ex2.pull(torch.arange(g.n_nodes) * 1.0))}
    return res


def exec_edge_cases() -> dict:
    """``ShardedExec`` against ``XlaExec`` off the analytics' beaten path:
    2-D inputs and 2-D edge values (the global fallbacks), a scalar edge
    value, every combine and dtype, a zero-edge graph and a one-node
    graph.  Returns ``{case: bits equal}``."""
    import numpy as np
    import torch
    from _torch_oracles import build, corpus
    from repro_torch.core import engine
    from repro_torch.core.graph import Graph
    out = {}
    graphs = {"rmat": build(Graph, corpus()[0], device="cpu"),
              "zero_edge": build(Graph, corpus()[5], device="cpu"),
              "one_node": Graph.from_edges(np.asarray([7], np.int32),
                                           np.asarray([7], np.int32),
                                           device="cpu")}
    for name, g in graphs.items():
        sh = engine.get_exec(g.plan(), "sharded")
        xl = engine.get_exec(g.plan(), "xla")
        n, e = g.n_nodes, g.n_edges
        gen = torch.Generator().manual_seed(3)
        xf = torch.rand((n,), generator=gen)
        xi = torch.randint(-50, 50, (n,), generator=gen, dtype=torch.int32)
        x2 = torch.rand((n, 3), generator=gen)     # batched: (n, k)
        ev = torch.rand((e,), generator=gen)
        ev2 = torch.rand((e, 3), generator=gen)
        cases = {}
        for comb in ("sum", "min", "max"):
            for tag, x in (("f32", xf), ("i32", xi)):
                cases[f"pull_{comb}_{tag}"] = lambda ex, x=x, c=comb: \
                    ex.pull(x, c)
                cases[f"push_{comb}_{tag}"] = lambda ex, x=x, c=comb: \
                    ex.push(x, c)
            cases[f"reduce_in_{comb}"] = lambda ex, c=comb: \
                ex.reduce_in(ev, c)
            cases[f"reduce_out_{comb}"] = lambda ex, c=comb: \
                ex.reduce_out(ev, c)
        cases.update({
            "pull_2d": lambda ex: ex.pull(x2),
            "push_2d_min": lambda ex: ex.push(x2, "min"),
            "pull_edge_values": lambda ex: ex.pull(xf, "sum", ev),
            "push_edge_add_min": lambda ex: ex.push(xf, "min", ev, "add"),
            "pull_scalar_edge": lambda ex: ex.pull(
                xf, "min", torch.tensor(1.5), "add"),
            "pull_float_edge": lambda ex: ex.pull(xf, "sum", 0.25),
            "pull_2d_edge_values": lambda ex: ex.pull(x2, "sum", ev2),
            "push_2d_edge_add_max": lambda ex: ex.push(x2, "max", ev2,
                                                       "add"),
            "reduce_in_2d": lambda ex: ex.reduce_in(ev2),
            "reduce_out_2d_max": lambda ex: ex.reduce_out(ev2, "max"),
        })
        for case, fn in cases.items():
            a, b = fn(sh), fn(xl)
            out[f"{name}/{case}"] = (a.dtype == b.dtype and
                                     a.shape == b.shape and
                                     a.numpy().tobytes() == b.numpy().tobytes())
        out[f"{name}/type"] = type(sh).__name__ if n else "xla-degenerate"
    return out


def distributed_job() -> dict:
    """The reference's ``tests/test_distributed.py`` graph through every
    public function of ``core/distributed.py``."""
    import numpy as np
    from repro_torch.core import distributed as D
    from repro_torch.core.engine import shard_count
    from repro_torch.core.graph import Graph
    from repro_torch.launch.mesh import graph_group
    g, _ = distributed_graph(Graph, device="cpu")
    group = graph_group(shard_count())
    dg = D.shard_graph(g, group)
    sd, dd = g.out_edges()
    dg2 = D.distributed_to_graph(sd, dd, g.n_nodes, group)
    u = g.to_undirected()
    return {"pagerank": D.pagerank_distributed(dg, n_iter=8).numpy(),
            "pagerank_bf16": D.pagerank_distributed(
                dg, n_iter=8, compress_bf16=True).numpy(),
            "pagerank_conv": D.pagerank_distributed(dg2, n_iter=8).numpy(),
            "degrees": D.degrees_distributed(dg).numpy(),
            "triangles": D.triangle_count_distributed(u, group,
                                                      edge_chunk=256),
            "triangles_default": D.triangle_count_distributed(u),
            "es": (dg.es, dg2.es), "local_edges": int(dg.evalid.sum()),
            "conv_local_edges": int(dg2.evalid.sum()),
            "n": g.n_nodes, "ranks": np.int64(group.rank)}


def grid_job() -> dict:
    """2-D PageRank on a square world, both layouts and bf16."""
    from repro_torch.core import distributed as D
    from repro_torch.core.engine import shard_count
    from repro_torch.core.graph import Graph
    from repro_torch.launch.mesh import graph_grid
    g, _ = distributed_graph(Graph, device="cpu")
    side = {1: 1, 4: 2, 9: 3}[shard_count()]
    dg = D.shard_graph_2d(g, graph_grid(side))
    return {"pagerank": D.pagerank_distributed_2d(dg, n_iter=8).numpy(),
            "pagerank_default_grid": D.pagerank_distributed_2d(
                D.shard_graph_2d(g), n_iter=8).numpy(),
            "shuffled": D.pagerank_distributed_2d(
                dg, n_iter=8, unshuffle=False).numpy(),
            "pagerank_bf16": D.pagerank_distributed_2d(
                dg, n_iter=8, compress_bf16=True).numpy(),
            "cell": (dg.grid.r, dg.grid.c), "es": dg.es}


def group_size_job(ask: int) -> str:
    """The message ``graph_group(ask)`` raises, or "no error"."""
    from repro_torch.launch.mesh import graph_group
    try:
        graph_group(ask)
    except ValueError as exc:
        return str(exc)
    return "no error"


def shard_local_pulls(g, d: int, seed: int = 0):
    """Each rank's shard-local sum pull at ``d`` shards, computed in this
    process (every rank's halo export assembled by hand, no collective),
    beside "xla"'s pull over the same vertex range: ``[(got, want)]`` per
    rank.  On the card this is where a segment's alignment would show."""
    import torch
    from repro_torch.core import engine
    plan = g.plan()
    sp = plan.sharded(d)
    ns, n = sp.ns, g.n_nodes
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((n,), generator=gen).to(g.device)
    want = engine.get_exec(plan, "xla").pull(x)
    xp = torch.cat([x, x.new_zeros((d * ns - n,))])
    blocks = [engine._shard_block(sp.pull, k, ns) for k in range(d)]
    halo = torch.cat([xp[o * ns:(o + 1) * ns].index_select(0, b.bnd)
                      for o, b in enumerate(blocks)])
    wpad = torch.cat([want, want.new_zeros((d * ns - n,))])
    out = []
    for k, b in enumerate(blocks):
        ev = torch.cat([xp[k * ns:(k + 1) * ns], halo]).index_select(0,
                                                                     b.gidx)
        got = engine._segment_reduce(ev, b.seg, b.lengths, ns + 2,
                                     "sum")[1: ns + 1]
        out.append((got, wpad[k * ns:(k + 1) * ns]))
    return out


def service_script(workers: int = 0) -> dict:
    """A scripted session mix through ``GraphService(engine_backend=
    "sharded")`` on this rank (rank 0 of the world, or a lone process):
    two sessions, PageRank, a fused BFS group of mixed depths, CC, a cache
    hit, an insert-only delta with warm re-runs, then a second service
    under a zero-byte memory budget.  Returns every result (numpy), each
    service's ``stats`` and the budget service's eviction log."""
    import numpy as np
    from repro_torch.core.graph import EdgeDelta, Graph
    from repro_torch.serve.graph_service import GraphService, MemoryPolicy
    g, _ = distributed_graph(Graph, device="cpu")
    out, stats = {}, {}
    svc = GraphService(engine_backend="sharded", device="cpu",
                       workers=workers)
    try:
        svc.workspace.put("g", g)
        a, b = svc.session("a"), svc.session("b")
        out["pr"] = a.execute({"op": "pagerank", "graph": "g",
                               "params": {"n_iter": 10}})
        out["pr_tol"] = b.execute({"op": "pagerank", "graph": "g",
                                   "params": {"tol": 1e-6}})
        fused = [a.submit({"op": "bfs", "graph": "g",
                           "params": {"source": 0}}),
                 b.submit({"op": "bfs", "graph": "g",
                           "params": {"source": 5, "n_iter": 3}}),
                 b.submit({"op": "bfs", "graph": "g",
                           "params": {"source": 9}})]
        svc.flush()
        for i, p in enumerate(fused):
            out[f"bfs{i}"] = p.result()
        out["cc"] = b.execute({"op": "connected_components", "graph": "g"})
        again = a.submit({"op": "pagerank", "graph": "g",
                          "params": {"n_iter": 10}})
        out["pr_again"] = again.result()
        out["hit"] = again.cached
        ids = g.node_ids[:g.n_nodes].numpy()
        svc.workspace.apply_delta("g", EdgeDelta.inserts(ids[:12], ids[20:32]))
        out["pr_tol_warm"] = b.execute({"op": "pagerank", "graph": "g",
                                        "params": {"tol": 1e-6}})
        out["cc_warm"] = a.execute({"op": "connected_components",
                                    "graph": "g"})
        out["bfs_warm"] = a.execute({"op": "bfs", "graph": "g",
                                     "params": {"source": 0}})
        out["triangles"] = b.execute({"op": "triangle_count", "graph": "u"}) \
            if "u" in svc.workspace else None
        stats["main"] = dict(svc.stats)
    finally:
        svc.close()
    tight = GraphService(engine_backend="sharded", device="cpu",
                         memory=MemoryPolicy(budget_bytes=0))
    try:
        tight.workspace.put("g", g)
        s = tight.session("s")
        out["budget_pr"] = s.execute({"op": "pagerank", "graph": "g",
                                      "params": {"n_iter": 10}})
        out["budget_cc"] = s.execute({"op": "connected_components",
                                      "graph": "g"})
        out["budget_pr_again"] = s.execute({"op": "pagerank", "graph": "g",
                                            "params": {"n_iter": 10}})
        stats["budget"] = dict(tight.stats)
        evlog = list(tight._mem.evlog)
    finally:
        tight.close()
    return {"results": {k: _np(v) for k, v in out.items() if v is not None},
            "stats": stats,
            "evicted_results": [b for kind, b in evlog if kind == "result"],
            "evicted_plan_families": sum(kind == "plan" for kind, _ in evlog)}


def service_threads_script() -> dict:
    """Two sessions submitting at once from two threads into a
    ``GraphService(engine_backend="sharded", workers=2)``: PageRank, BFS
    from eight sources, CC; returns the results (numpy), in request
    order."""
    import threading
    from repro_torch.core.graph import Graph
    from repro_torch.serve.graph_service import GraphService
    g, _ = distributed_graph(Graph, device="cpu")
    svc = GraphService(engine_backend="sharded", device="cpu", workers=2)
    reqs = {"a": [{"op": "pagerank", "graph": "g", "params": {"n_iter": 8}}]
            + [{"op": "bfs", "graph": "g", "params": {"source": s}}
               for s in range(0, 8, 2)],
            "b": [{"op": "connected_components", "graph": "g"}]
            + [{"op": "bfs", "graph": "g", "params": {"source": s}}
               for s in range(1, 8, 2)]}
    got = {}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)          # interleave the threads finely
    try:
        svc.workspace.put("g", g)

        def run(name):
            sess = svc.session(name)
            pend = [sess.submit(r) for r in reqs[name]]
            got[name] = [_np(p.result(timeout=120)) for p in pend]
        ts = [threading.Thread(target=run, args=(n,)) for n in reqs]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts), "a session hung"
    finally:
        sys.setswitchinterval(switch)
        svc.close()
    return got


def service_job() -> dict:
    """A d-rank "sharded" service: rank 0 runs ``service_script`` (two
    services) and ``service_threads_script``, every other rank follows
    each service until its ``close``."""
    from repro_torch.core.engine import shard_count
    from repro_torch.launch.mesh import graph_group
    from repro_torch.serve.graph_service import serve_follower
    group = graph_group(shard_count())
    if group.rank == 0:
        res = service_script()
        res["threads"] = service_threads_script()
        return res
    return {"followed": [serve_follower(device="cpu") for _ in range(3)]}


def ddp_job(arrays, batch) -> dict:
    """One ``make_ddp_step`` of reduced qwen2.5-3b from ``arrays`` on the
    global ``batch``, plain and int8-compressed, from fresh AdamW state;
    also this rank's own gradients of its rows (numpy)."""
    import torch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.engine import shard_count
    from repro_torch.launch.mesh import graph_group
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.compress import init_error_feedback
    from repro_torch.train.optimizer import OptHyper, get_optimizer
    from repro_torch.train.step import make_ddp_step
    cfg = reduced(get_config("qwen2.5-3b"))
    group = graph_group(shard_count())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    per = tb["tokens"].shape[0] // group.d
    model = Transformer.from_arrays(cfg, arrays, device="cpu")
    loss, _ = model.loss_fn({k: v[group.rank * per:(group.rank + 1) * per]
                             for k, v in tb.items()})
    loss.backward()
    out = {"grads": {k: p.grad.numpy().copy()
                     for k, p in model.named_parameters()}}
    for tag, comp in (("plain", False), ("compressed", True)):
        model = Transformer.from_arrays(cfg, arrays, device="cpu")
        params = dict(model.named_parameters())
        state = get_optimizer("adamw").init(params)
        step = make_ddp_step(cfg, group, OptHyper(), compress=comp)
        res = init_error_feedback(params) if comp else None
        model, state, loss, res = step(model, state, tb, 0, res)
        out[tag] = {"params": {k: p.detach().numpy().copy()
                               for k, p in model.named_parameters()},
                    "loss": float(loss),
                    "residuals": None if res is None else
                    {k: v.numpy() for k, v in res.items()}}
    return out


def distributed_graph(graph_cls, **kw):
    """The graph of the reference's ``tests/test_distributed.py``."""
    import numpy as np
    rng = np.random.default_rng(3)
    n, m = 400, 2400
    s = rng.integers(0, n, m)
    d = rng.integers(0, n, m)
    keep = s != d
    s, d = s[keep], d[keep]
    return graph_cls.from_edges(s, d, dedupe=True, **kw), (s, d)


if __name__ == "__main__":         # by hand: cd tests && python _torch_worlds.py [d]
    import sys
    import tempfile
    d = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = run_world(corpus_job, d, os.path.join(tmp, f"w{d}"))
        print(len(res), time.perf_counter() - t0)
