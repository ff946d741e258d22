"""Spawned gloo worlds for the port's multi-rank tests (CPU).

``run_world(job, d, workdir)`` starts ``d`` processes with the ``spawn``
method; each joins a gloo process group over a ``FileStore`` in ``workdir``
(60 s timeout), runs ``job(*args)`` with one intra-op thread (the suite
already runs several pytest workers), and pickles what it returns.  The
parent joins the ranks against a deadline, kills any that outlive it, and
fails with every rank's traceback when a rank raised or hung: nothing a
rank raises is swallowed.  A rank that dies on a signal (an abort inside
torch) or is still running 15 s before the deadline also leaves the
Python stacks of all its threads (``faulthandler``), and the failure
shows them.  It returns the ranks' results in rank order.

Jobs live in this module (and import only torch, numpy and ``repro_torch``)
so a rank never imports jax or the reference.
"""

from __future__ import annotations

import datetime
import faulthandler
import multiprocessing as mp
import os
import pickle
import sys
import time
import traceback
from pathlib import Path

JOIN_SECONDS = 180.0
_FAULTS = []        # each rank's faulthandler file, open until it exits


def _rank_main(rank: int, d: int, workdir: str, timeout: float, job,
               args) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = Path(workdir)
    _FAULTS.append(open(out / f"rank{rank}.stacks", "w"))
    faulthandler.enable(_FAULTS[-1], all_threads=True)
    faulthandler.dump_traceback_later(max(timeout - 15.0, 1.0),
                                      file=_FAULTS[-1])
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
                         args=(r, d, str(workdir), timeout, job, args),
                         daemon=True)
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
    errs = {}
    for r in range(d):
        for kind in ("err", "stacks"):
            f = workdir / f"rank{r}.{kind}"
            if f.exists() and f.read_text().strip():
                errs[r] = errs.get(r, "") + f"[{kind}]\n{f.read_text()}"
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
    each service until its ``close``.  Rank 0 also returns the names of
    the threads still alive after the three services' ``close``."""
    import threading
    from repro_torch.core.engine import shard_count
    from repro_torch.launch.mesh import graph_group
    from repro_torch.serve.graph_service import serve_follower
    group = graph_group(shard_count())
    if group.rank == 0:
        res = service_script()
        res["threads"] = service_threads_script()
        res["threads_after_close"] = sorted(t.name
                                            for t in threading.enumerate())
        return res
    return {"followed": [serve_follower(device="cpu") for _ in range(3)]}


def group_lifetime_job(workdir: str) -> dict:
    """Whether anything of the port keeps this rank's process group alive
    past ``destroy_process_group`` (a group freed only at interpreter
    shutdown aborts a gloo rank now and then): take ``graph_group``, run
    a "sharded" PageRank (its exec caches the group), destroy the default
    group and report whether it was freed and what the old ``ShardGroup``
    says now; then join a second world (a new store in ``workdir``) and
    report whether ``graph_group`` gives a new group."""
    import datetime
    import gc
    import weakref

    import torch.distributed as dist
    from repro_torch.core import algorithms as A
    from repro_torch.core.graph import Graph
    from repro_torch.launch.mesh import graph_group
    d, rank = dist.get_world_size(), dist.get_rank()
    old = graph_group(d)
    g, _ = distributed_graph(Graph, device="cpu")
    pr = A.pagerank(g, n_iter=3, backend="sharded")
    ref = weakref.ref(dist.group.WORLD)
    dist.barrier()
    dist.destroy_process_group()
    gc.collect()
    out = {"freed": ref() is None, "pagerank": pr.numpy()}
    try:
        out["old_group"] = repr(old.group)
    except RuntimeError as exc:
        out["old_group"] = str(exc)
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/store2", rank=rank,
        world_size=d, timeout=datetime.timedelta(seconds=60))
    out["new_group"] = graph_group(d) is not old
    return out


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


def sharded_lm_job(data: int, model: int, cases, layers, prompts,
                   new_tokens: int) -> dict:
    """Each of ``cases`` ((tag, config overrides, arrays, tokens)) served
    sharded over a (``data``, ``model``) grid: ``forward`` of this data
    shard's rows, ``loss_fn`` of them (next-token targets) with the
    gradient of the final norm's scale, ``prefill`` of their first S - 4
    tokens and 4 teacher-forced ``decode_step``s; the meta shapes ``launch.specs.input_specs``
    gives this grid beside the tensors the rank holds; ``Engine.generate``
    of this data shard's ``prompts``.  ``layers``: (tag, overrides,
    layer arrays, x) through ``moe_apply`` of an MoE layer sharded as the
    model's.  Returns numpy."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeSpec, get_config, reduced
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import model_grid
    from repro_torch.models import moe
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, ServeConfig
    grid = model_grid(data, model)
    di = grid.data.rank

    def rows(a):
        n = a.shape[0] // data
        return a[di * n:(di + 1) * n]

    out = {"coords": grid.coords, "lm": {}, "layers": {}}
    for tag, over, arrays, tokens in cases:
        cfg = reduced(get_config(over["arch"]),
                      **{k: v for k, v in over.items() if k != "arch"})
        m = Transformer.from_arrays(cfg, arrays, device="cpu", group=grid)
        toks = torch.from_numpy(rows(tokens))
        b, s = toks.shape
        logits, aux = m({"tokens": toks})
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        loss, _ = m.loss_fn(batch)
        loss.backward()
        train = {"loss": float(loss),
                 "norm_f_grad": m.norm_f.scale.grad.numpy().copy()}
        m.zero_grad(set_to_none=True)
        pre, cache = m.prefill({"tokens": toks[:, :s - 4]}, s + 4)
        steps = []
        for i in range(s - 4, s):
            dec, cache = m.decode_step(cache, toks[:, i:i + 1], i)
            steps.append(dec.numpy())
        shape = ShapeSpec("t", s + 4, b * data, "decode")
        _, structs, _ = specs.input_specs(cfg, shape, grid)
        held = dict(m.named_parameters())
        p_meta = structs[0]
        eng = Engine(cfg, m, ServeConfig(batch=len(prompts) // data,
                                         max_seq=64), device="cpu")
        out["lm"][tag] = {
            "forward": logits.numpy(), "aux": float(aux), "train": train,
            "prefill": pre.numpy(), "decode": np.stack(steps, 1)[:, :, 0],
            "params_match_meta": sorted(held) == sorted(p_meta) and all(
                tuple(held[k].shape) == tuple(p_meta[k].shape) and
                held[k].dtype == p_meta[k].dtype for k in held),
            "cache_shapes": {k: tuple(t.shape)
                             for k, t in cache["attn"].items()},
            "cache_meta": {k: tuple(t.shape)
                           for k, t in structs[1]["attn"].items()},
            "kv_heads": m.kv_heads,
            "tokens_meta": tuple(structs[2].shape),
            "generate": eng.generate(rows(np.asarray(prompts, dtype=object))
                                     .tolist(), new_tokens)}
    for tag, over, arrays, x in layers:
        cfg = reduced(get_config(over["arch"]),
                      **{k: v for k, v in over.items() if k != "arch"})
        m = Transformer.from_arrays(cfg, arrays, device="cpu", group=grid)
        with torch.no_grad():
            y, aux = moe.moe_apply(m.layers[0].moe,
                                   torch.from_numpy(rows(x)), cfg)
        out["layers"][tag] = {"out": y.numpy(), "aux": float(aux)}
    return out


def _train_cfg(over):
    from repro_torch.configs.base import get_config, reduced
    return reduced(get_config(over["arch"]),
                   **{k: v for k, v in over.items() if k != "arch"})


def _shared_blocks(model) -> dict:
    """This rank's blocks of what ranks share: the norms, the routers and
    the ``wk`` / ``wv`` leaves (numpy)."""
    import re
    return {k: p.detach().numpy().copy() for k, p in model.named_parameters()
            if re.search(r"(norm|ln)[^.]*\.(scale|bias)$|router\.w$|"
                         r"attn\.w[kv]\.[wb]$", k)}


def sharded_train_job(cases, ckpt=None) -> dict:
    """Each of ``cases`` ((tag, data, model, config overrides, arrays,
    batches, grads)) trained from ``arrays`` over a (data, model) grid of
    this world, one ``make_train_step`` per batch on this data shard's
    rows: per step its metrics, after the last this rank's blocks of what
    ranks share, and its ZeRO state's shapes beside its blocks'.  Then,
    from ``arrays`` and fresh state again, one ``zero.apply_gradients`` of
    the whole gradients ``grads`` (each rank's block of them, a block that
    ``members`` ranks sum divided among them) and the whole parameters
    after it, gathered as a checkpoint gathers them.

    ``ckpt``: (tag, directory, n): after ``n`` steps of that case the
    checkpoint is saved (rank 0 writes), then a model loaded from it takes
    step ``n`` again on the same grid.  Returns numpy."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import model_grid
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import zero
    from repro_torch.train.optimizer import OptHyper
    from repro_torch.train.step import make_train_step
    out = {}
    for tag, data, model, over, arrays, batches, grads in cases:
        grid = model_grid(data, model)
        di = grid.data.rank
        cfg = _train_cfg(over)
        m = Transformer.from_arrays(cfg, arrays, device="cpu", group=grid)
        state = zero.init_state(cfg.optimizer, m)
        step = make_train_step(cfg, OptHyper(), attn_chunk=16)

        def rows(a):
            n = a.shape[0] // data
            return torch.from_numpy(np.ascontiguousarray(
                a[di * n:(di + 1) * n]))

        res = {"coords": grid.coords, "metrics": [],
               "holders": {k: leaf.holders
                           for k, leaf in zero.layout(m).items()},
               "state_shapes": {}, "block_shapes": {}}
        for i, b in enumerate(batches):
            if ckpt is not None and ckpt[0] == tag and i == ckpt[2]:
                tree = zero.full_tree(m, state)
                if grid.data.rank == 0 and grid.model.rank == 0:
                    store.save_checkpoint(ckpt[1], i, tree,
                                          meta={"config":
                                                store.config_hash(cfg)})
                else:
                    store.gather_leaves(tree)
                torch.distributed.barrier()
                again = Transformer.from_arrays(cfg, arrays, device="cpu",
                                                group=grid)
                again_state = zero.init_state(cfg.optimizer, again)
                launch_train.load_train_state(ckpt[1], again, again_state,
                                              cfg)
                _, _, mr = step(again, again_state,
                                {k: rows(v) for k, v in b.items()}, i)
                res["resumed"] = {k: float(v) for k, v in mr.items()}
            m, state, met = step(m, state, {k: rows(v) for k, v in b.items()},
                                 i)
            res["metrics"].append({k: float(v) for k, v in met.items()})
        res["shared"] = _shared_blocks(m)
        lay = zero.layout(m)
        res["model_shapes"] = {}
        for k, p in m.named_parameters():
            res["block_shapes"][k] = tuple(lay[k].zblock(p).shape)
            res["model_shapes"][k] = tuple(p.shape)
        for path, name, sub, t in zero._state_leaves(state):
            res["state_shapes"][path] = tuple(t.shape)
        given = Transformer.from_arrays(cfg, arrays, device="cpu",
                                        group=grid)
        given_state = zero.init_state(cfg.optimizer, given)
        for k, p in given.named_parameters():
            g = p.keep(torch.from_numpy(grads[k]))
            p.grad = g / len(lay[k].members)
        zero.apply_gradients(given, given_state, 0, OptHyper())
        whole = zero.full_tree(given, given_state)["params"]
        res["params_1"] = {k: f().numpy() for k, f in whole.items()}
        out[tag] = res
    return out


def heads_job(data: int, model: int, cases) -> dict:
    """Each of ``cases`` ((tag, config overrides, arrays, batch, prompt,
    teacher, grads)) over a (``data``, ``model``) grid whose model ranks
    need not split the heads evenly: on this data shard's rows, ``forward``
    of ``batch``; ``loss_fn`` of it and the whole gradient (each block
    summed over the model ranks that hold it, reduced over "data" and
    gathered as a checkpoint gathers state); ``prefill`` of ``prompt`` and
    a teacher-forced ``decode_step`` per column of ``teacher`` (whisper:
    against ``encode``'s output); the calls that found no head on this
    rank (``models/attention.NO_HEAD``); the parameters and cache beside
    ``launch.specs.input_specs``' meta shapes (rank 0's); then, from
    ``arrays``, one ``zero.apply_gradients`` of the whole gradients
    ``grads`` (a position several model ranks hold given to the first of
    them) and the whole parameters after it.  Returns numpy."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import model_grid
    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import zero
    from repro_torch.train.optimizer import OptHyper
    grid = model_grid(data, model)
    di = grid.data.rank

    def rows(a):
        n = a.shape[0] // data
        return torch.from_numpy(np.ascontiguousarray(a[di * n:(di + 1) * n]))

    def whole(m, grads):
        lay = zero.layout(m)
        out = {}
        for k, g in grads.items():
            dims = tuple(range(len(lay[k].full)))
            out[k] = zero._gather_full(zero._reduce(g, lay[k], grid), lay[k],
                                       dims, grid, zsplit=True).numpy()
        return out

    out = {"coords": grid.coords}
    for tag, over, arrays, batch, prompt, teacher, grads in cases:
        cfg = _train_cfg(over)
        m = Transformer.from_arrays(cfg, arrays, device="cpu", group=grid)
        mine = {k: rows(v) for k, v in batch.items()}
        attn.NO_HEAD["calls"] = 0
        logits, _ = m({k: v for k, v in mine.items() if k != "targets"})
        res = {"forward": logits.numpy(), "heads": m.layers[0].attn.n_heads,
               "kv_heads": m.kv_heads}
        loss, _ = m.loss_fn(mine)
        loss.backward()
        lay = zero.layout(m)
        taken = {k: zero._taken_grad(p, lay[k])
                 for k, p in m.named_parameters()}
        with torch.no_grad():
            res["loss"] = float(grid.data._sum(loss.detach()) / data
                                if data > 1 else loss)
            res["grads"] = whole(m, taken)
            p_mine = {k: rows(v) for k, v in prompt.items()}
            n_prompt = p_mine["tokens"].shape[1] + cfg.n_patches
            max_seq = n_prompt + teacher.shape[1] + 2
            pre, cache = m.prefill(p_mine, max_seq)
            enc = m.encode(p_mine["enc_embeds"]) \
                if cfg.is_encoder_decoder else None
            steps = [pre.numpy()[:, -1]]
            t = rows(teacher)
            for j in range(t.shape[1]):
                dec, cache = m.decode_step(cache, t[:, j:j + 1],
                                           n_prompt + j, enc_out=enc)
                steps.append(dec.numpy()[:, 0])
        res["steps"] = np.stack(steps, 1)
        res["no_head_calls"] = attn.NO_HEAD["calls"]
        b = batch["tokens"].shape[0]
        shape = ShapeSpec("t", max_seq, b, "decode")
        _, structs, _ = specs.input_specs(cfg, shape, grid)
        res["param_shapes"] = {k: tuple(p.shape)
                               for k, p in m.named_parameters()}
        res["param_meta"] = {k: tuple(t.shape) for k, t in structs[0].items()}
        res["cache_shapes"] = {k: tuple(t.shape)
                               for k, t in cache["attn"].items()}
        res["cache_meta"] = {k: tuple(t.shape)
                             for k, t in structs[1]["attn"].items()}
        given = Transformer.from_arrays(cfg, arrays, device="cpu", group=grid)
        state = zero.init_state(cfg.optimizer, given)
        lay = zero.layout(given)
        for k, p in given.named_parameters():
            g = p.keep(torch.from_numpy(grads[k])).clone()
            if lay[k].msum and lay[k].mdim is not None:
                lo, n = lay[k].owned(lay[k].m_rank)
                keep = torch.zeros_like(g)
                keep.narrow(lay[k].mdim, lo - lay[k].mrange[0], n).fill_(1)
                g = g * keep
            p.grad = g
        res["grad_norm"] = float(zero.apply_gradients(given, state, 0,
                                                      OptHyper()))
        tree = zero.full_tree(given, state)["params"]
        res["params_1"] = {k: f().numpy() for k, f in tree.items()}
        out[tag] = res
    return out


def recurrent_job(data: int, model: int, cases) -> dict:
    """Each of ``cases`` ((tag, config overrides, arrays, batch, prompt,
    teacher, grads)) of the ssm or hybrid family over a (``data``,
    ``model``) grid: on this data shard's rows, ``forward`` of ``batch``;
    ``loss_fn`` of it and the whole gradient (each block summed over the
    model ranks that hold it, reduced over "data", gathered as a
    checkpoint gathers state); ``prefill`` of ``prompt`` and a
    teacher-forced ``decode_step`` per column of ``teacher``, with the
    model group's collective calls in the prefill and in each step; the
    mLSTM calls that found no head on this rank
    (``models/xlstm.NO_HEAD``); the parameters and cache beside
    ``launch.specs.input_specs``' meta shapes (rank 0's); from ``arrays``,
    one ``zero.apply_gradients`` of the whole gradients ``grads`` (a
    position several model ranks hold given to the first of them), and
    one ``make_train_step`` on ``batch``: the whole parameters after
    each; ``init_params`` from seed 0 over the grid, gathered whole; and
    the serving and the gradient again with every weight's d_model dim
    split over "data" too (``default_rules(two_d_weights=True)``: each use
    gathers it over the data ranks).  Returns numpy."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import sharding, specs
    from repro_torch.launch.mesh import model_grid
    from repro_torch.models import xlstm
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import zero
    from repro_torch.train.optimizer import OptHyper
    from repro_torch.train.step import make_train_step
    grid = model_grid(data, model)
    di = grid.data.rank

    def rows(a):
        n = a.shape[0] // data
        return torch.from_numpy(np.ascontiguousarray(a[di * n:(di + 1) * n]))

    def given_grads(m, grads):
        """Each rank's part of the whole gradients, which the model-axis
        sums add up to them: a shared position on its first holder, a
        router's gradient divided among the ranks."""
        lay = zero.layout(m)
        for k, p in m.named_parameters():
            g = p.keep(torch.from_numpy(grads[k])).clone()
            if lay[k].msum and lay[k].mdim is None:
                g = g / len(lay[k].members)
            elif lay[k].msum:
                lo, n = lay[k].owned(lay[k].m_rank)
                keep = torch.zeros_like(g)
                keep.narrow(lay[k].mdim, lo - lay[k].mrange[0], n).fill_(1)
                g = g * keep
            p.grad = g

    def whole_params(m, state):
        tree = zero.full_tree(m, state)["params"]
        return {k: f().numpy() for k, f in tree.items()}

    def run(m, mine, prompt, teacher):
        """``forward``, ``loss_fn`` and the whole gradient, ``prefill`` and
        the teacher-forced steps of ``m``, with the model group's calls;
        the cache."""
        logits, _ = m({k: v for k, v in mine.items() if k != "targets"})
        res = {"forward": logits.numpy()}
        loss, _ = m.loss_fn(mine)
        loss.backward()
        lay = zero.layout(m)
        taken = {k: zero._taken_grad(p, lay[k])
                 for k, p in m.named_parameters()}
        with torch.no_grad():
            res["loss"] = float(grid.data._sum(loss.detach()) / data
                                if data > 1 else loss)
            res["grads"] = {
                k: zero._gather_full(zero._reduce(g, lay[k], grid), lay[k],
                                     tuple(range(len(lay[k].full))), grid,
                                     zsplit=True).numpy()
                for k, g in taken.items()}
            p_mine = rows(prompt)
            max_seq = p_mine.shape[1] + teacher.shape[1] + 2
            calls = grid.model.stats["calls"]
            pre, cache = m.prefill({"tokens": p_mine}, max_seq)
            res["prefill_calls"] = grid.model.stats["calls"] - calls
            steps = [pre.numpy()[:, -1]]
            t = rows(teacher)
            res["decode_calls"] = []
            for j in range(t.shape[1]):
                calls = grid.model.stats["calls"]
                dec, cache = m.decode_step(cache, t[:, j:j + 1],
                                           p_mine.shape[1] + j)
                res["decode_calls"].append(grid.model.stats["calls"]
                                           - calls)
                steps.append(dec.numpy()[:, 0])
        res["steps"] = np.stack(steps, 1)
        return res, cache, max_seq

    out = {"coords": grid.coords}
    for tag, over, arrays, batch, prompt, teacher, grads in cases:
        cfg = _train_cfg(over)
        m = Transformer.from_arrays(cfg, arrays, device="cpu", group=grid)
        mine = {k: rows(v) for k, v in batch.items()}
        xlstm.NO_HEAD["calls"] = 0
        res, cache, max_seq = run(m, mine, prompt, teacher)
        res["no_head_calls"] = xlstm.NO_HEAD["calls"]
        b = batch["tokens"].shape[0]
        shape = ShapeSpec("t", max_seq, b, "decode")
        _, structs, _ = specs.input_specs(cfg, shape, grid)
        res["param_shapes"] = {k: tuple(p.shape)
                               for k, p in m.named_parameters()}
        res["param_meta"] = {k: tuple(t.shape) for k, t in structs[0].items()}
        res["cache_shapes"] = {(g, k): tuple(t.shape)
                               for g, leaves in cache.items()
                               for k, t in leaves.items()}
        res["cache_meta"] = {(g, k): tuple(t.shape)
                             for g, leaves in structs[1].items()
                             for k, t in leaves.items()}
        given = Transformer.from_arrays(cfg, arrays, device="cpu", group=grid)
        state = zero.init_state(cfg.optimizer, given)
        given_grads(given, grads)
        res["grad_norm"] = float(zero.apply_gradients(given, state, 0,
                                                      OptHyper()))
        res["params_1"] = whole_params(given, state)
        stepped = Transformer.from_arrays(cfg, arrays, device="cpu",
                                          group=grid)
        state = zero.init_state(cfg.optimizer, stepped)
        step = make_train_step(cfg, OptHyper(), attn_chunk=16)
        _, state, met = step(stepped, state, mine, 0)
        res["step_metrics"] = {k: float(v) for k, v in met.items()}
        res["params_step"] = whole_params(stepped, state)
        drawn = Transformer.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu", group=grid)
        lay = zero.layout(drawn)
        res["init_params"] = {
            k: zero._gather_full(p, lay[k], tuple(range(len(lay[k].full))),
                                 grid, zsplit=False).numpy()
            for k, p in drawn.named_parameters()}
        # every weight's d_model dim split over "data" too
        res["two_d"] = run(Transformer.from_arrays(
            cfg, arrays, device="cpu", group=grid,
            rules=sharding.default_rules(
                two_d_weights=True,
                expert_axis_parallel=cfg.n_experts % model == 0)),
            mine, prompt, teacher)[0]
        out[tag] = res
    return out


def two_d_job(cases, ckpt=None, memory=None, prompts=()) -> dict:
    """Each of ``cases`` ((tag, data, model, config overrides, expert axis
    parallel, arrays, tokens, batches, grads)) with its weights 2-D
    (``default_rules(two_d_weights=True)``) over a (data, model) grid of
    this world: ``forward`` of this data shard's rows of ``tokens``,
    ``prefill`` of their first S - 4 tokens and 4 teacher-forced decode
    steps; ``Engine.generate`` of this data shard's ``prompts``, 4 new
    tokens; each parameter's block beside its spec's; three train steps of
    ``batches`` (metrics, then this rank's blocks of what ranks share);
    then, from ``arrays`` and fresh state, three ``zero.apply_gradients``
    of the whole gradients ``grads`` (a 2-D block's as its
    ``reduced_grad``): the whole parameters after each and the optimizer
    state after the third, gathered as a checkpoint gathers them.

    ``ckpt``: (tag, directory, n): after ``n`` steps of that case its
    checkpoint is saved, then a model loaded from it takes step ``n``
    again on the same grid.  ``memory``: (overrides, arrays, batch) at
    this world's (data, 1): the peak live bytes of ``loss_fn`` and of its
    backward (``launch/hlo_cost.CostCounter``) and the bytes of the
    reduced gradients it leaves, with the weights 2-D and replicated, and
    with the 2-D weights kept for the backward (no ``regather_saved``).
    Returns numpy."""
    import contextlib
    import numpy as np
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.launch import mesh, sharding
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.hlo_cost import CostCounter
    from repro_torch.launch.mesh import model_grid
    from repro_torch.models.transformer import Transformer, param_blocks
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train import zero
    from repro_torch.train.optimizer import OptHyper
    from repro_torch.train.step import make_train_step
    out = {"cases": {}}
    for tag, data, model, over, eap, arrays, tokens, batches, grads in cases:
        grid = model_grid(data, model)
        di = grid.data.rank
        rules = sharding.default_rules(two_d_weights=True,
                                       expert_axis_parallel=eap)
        cfg = _train_cfg(over)

        def rows(a):
            n = a.shape[0] // data
            return torch.from_numpy(np.ascontiguousarray(
                a[di * n:(di + 1) * n]))

        def build():
            return Transformer.from_arrays(cfg, arrays, device="cpu",
                                           group=grid, rules=rules)
        m = build()
        blocks = param_blocks(cfg, grid.coords, rules)
        res = {"coords": grid.coords, "metrics": [],
               "blocks": {k: (tuple(p.shape),
                              tuple(blocks[k][2](blocks[k][0]).shape),
                              getattr(p, "data_dim", None))
                          for k, p in m.named_parameters()}}
        toks = rows(tokens)
        s = toks.shape[1]
        logits, _ = m({"tokens": toks})
        pre, cache = m.prefill({"tokens": toks[:, :s - 4]}, s + 4)
        steps = []
        for i in range(s - 4, s):
            dec, cache = m.decode_step(cache, toks[:, i:i + 1], i)
            steps.append(dec.numpy())
        res.update(forward=logits.numpy(), prefill=pre.numpy(),
                   decode=np.stack(steps, 1)[:, :, 0])
        if prompts:
            n = len(prompts) // data
            eng = Engine(cfg, m, ServeConfig(batch=n, max_seq=32),
                         device="cpu")
            res["generate"] = eng.generate(
                list(prompts[di * n:(di + 1) * n]), 4)
        state = zero.init_state(cfg.optimizer, m)
        step = make_train_step(cfg, OptHyper(), attn_chunk=16)
        for i, b in enumerate(batches):
            if ckpt is not None and ckpt[0] == tag and i == ckpt[2]:
                tree = zero.full_tree(m, state)
                if grid.data.rank == 0 and grid.model.rank == 0:
                    store.save_checkpoint(ckpt[1], i, tree,
                                          meta={"config":
                                                store.config_hash(cfg)})
                else:
                    store.gather_leaves(tree)
                torch.distributed.barrier()
                again = build()
                again_state = zero.init_state(cfg.optimizer, again)
                launch_train.load_train_state(ckpt[1], again, again_state,
                                              cfg)
                _, _, mr = step(again, again_state,
                                {k: rows(v) for k, v in b.items()}, i)
                res["resumed"] = {k: float(v) for k, v in mr.items()}
            m, state, met = step(m, state, {k: rows(v) for k, v in b.items()},
                                 i)
            res["metrics"].append({k: float(v) for k, v in met.items()})
        lay = zero.layout(m)
        res["shared"] = _shared_blocks(m)
        res["holders"] = {k: leaf.holders for k, leaf in lay.items()}
        given = build()
        given_state = zero.init_state(cfg.optimizer, given)
        for i in range(3):
            for k, p in given.named_parameters():
                g = p.keep(torch.from_numpy(grads[k])) / len(lay[k].members)
                if lay[k].ddim is None:
                    p.grad = g
                else:
                    p.reduced_grad = g.float()
            zero.apply_gradients(given, given_state, i, OptHyper())
            whole = zero.full_tree(given, given_state)
            res[f"params_{i + 1}"] = {k: f().numpy().copy()
                                      for k, f in whole["params"].items()}
        res["state_3"] = {(part, k, leaf): f().numpy().copy()
                          for part, tree in whole["opt"].items()
                          for k, sub in tree.items()
                          for leaf, f in (sub.items() if isinstance(sub, dict)
                                          else [(None, sub)])}
        out["cases"][tag] = res
    if memory is not None:
        over, arrays, batch = memory
        cfg = _train_cfg(over)
        grid = model_grid(torch.distributed.get_world_size(), 1)
        n = batch["tokens"].shape[0] // grid.data.d
        mine = {k: torch.from_numpy(np.ascontiguousarray(
            v[grid.data.rank * n:(grid.data.rank + 1) * n]))
            for k, v in batch.items()}
        peaks = {}
        for name, two_d, keep in (("two_d", True, False),
                                  ("replicated", False, False),
                                  ("two_d_kept", True, True)):
            m = Transformer.from_arrays(
                cfg, arrays, device="cpu", group=grid,
                rules=sharding.default_rules(two_d_weights=two_d))
            hooks = mesh.regather_saved
            if keep:
                mesh.regather_saved = contextlib.nullcontext
            try:
                with CostCounter() as fwd:
                    loss, _ = m.loss_fn(mine, chunk=16)
            finally:
                mesh.regather_saved = hooks
            with CostCounter() as bwd:
                loss.backward()
            reduced = sum(4 * p.numel() for p in m.parameters()
                          if getattr(p, "reduced_grad", None) is not None)
            peaks[name] = (fwd.peak_live_bytes, bwd.peak_live_bytes, reduced)
            del loss, m
        out["memory"] = peaks
    return out


def launch_train_job(argv, giant_bytes=None) -> str:
    """``launch/train.py``'s ``main(argv)`` on this rank; its output.  With
    ``giant_bytes``, ``launch.specs.GIANT_PARAM_BYTES`` is set to it first
    (0: every config is giant, so ``rules_for`` gives 2-D weights)."""
    import contextlib
    import io
    from repro_torch.launch import specs
    from repro_torch.launch import train as launch_train
    if giant_bytes is not None:
        specs.GIANT_PARAM_BYTES = giant_bytes
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_train.main(list(argv))
    return buf.getvalue()


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


def family_train_job(workdir: str, jobs) -> list:
    """Phase 4l's rank function on the CPU: ``chip_smoke.py``'s
    ``family_train_world`` (it imports only torch, numpy and
    ``repro_torch``), each job over (1, m) on ranks 0..m-1 -> this rank's
    records."""
    import gc
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.append(root)
    import chip_smoke
    # the automatic collector off: a reference cycle then lives until a
    # collection is asked for, as one promoted to the oldest generation
    # does on the card (phase 4l's ranks collect after each run)
    gc.disable()
    return chip_smoke.family_train_world(workdir, jobs, "cpu")


def family_train_unsummed_job(workdir: str, jobs) -> list:
    """:func:`family_train_job` with a fault planted in the sharded step:
    the model-axis sum of the leaves whose gradient ranks hold in part
    (``train/zero._reduce``'s ``msum``: a dense model's shared KV heads)
    skipped, so each rank keeps its own part of a KV head's gradient."""
    import dataclasses
    from repro_torch.train import zero
    real = zero._reduce

    def unsummed(g, leaf, grid):
        return real(g, dataclasses.replace(leaf, msum=False), grid)

    zero._reduce = unsummed
    return family_train_job(workdir, jobs)


def two_d_grads_job(over, batch, plant) -> list:
    """Phase 4i's step 0 on this rank of a (2, 2) world, weights 2-D
    (``default_rules(two_d_weights=True)``: a reduced config is not
    giant), from seed 0, this data shard's row of ``batch``: the metrics
    and ``chip_smoke.py``'s record of each 2-D block's reduced gradient
    (``pre_clip_grads`` in bf16, ``grad_block``) and of its routings
    (``moe_choices``), as the phase's ranks write them.  Twice: as it is,
    then with the fault ``plant`` planted, the 2-D gradient of that leaf
    left undivided by d."""
    import torch
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import model_grid
    from repro_torch.train import zero
    from repro_torch.train.optimizer import OptHyper
    from repro_torch.train.step import init_train_state, make_train_step
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.append(root)
    import chip_smoke
    grid = model_grid(2, 2)
    rows = {k: v[grid.data.rank:grid.data.rank + 1] for k, v in batch.items()}
    cfg = _train_cfg(over)
    real = zero._taken_grad
    out = []
    for fault in (None, plant):
        gen = torch.Generator().manual_seed(0)
        m, state = init_train_state(
            cfg, gen, device="cpu", grid=grid,
            rules=sharding.default_rules(two_d_weights=True))
        lay = zero.layout(m)
        target = dict(m.named_parameters()).get(fault)

        def taken(p, leaf):
            g = real(p, leaf)
            return g * grid.data.d if p is target else g

        zero._taken_grad = taken
        two_d = {k for k, leaf in lay.items() if leaf.ddim is not None}
        try:
            with chip_smoke.pre_clip_grads(two_d.__contains__,
                                           torch.bfloat16) as got, \
                    chip_smoke.moe_choices() as chosen:
                _, _, met = make_train_step(cfg, OptHyper())(m, state, rows,
                                                             0)
        finally:
            zero._taken_grad = real
        out.append({"metrics": {k: float(v) for k, v in met.items()},
                    "grads": {k: {"grad": g, "block": chip_smoke.grad_block(
                        lay[k])} for k, g in got.items()},
                    "routes": chosen})
    return out
