#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check its kernels.

Run from the root of a checkout, on a machine with a card, ``nvcc`` and
PyTorch built for CUDA:

    python3 chip_smoke.py [--profile]

Phases (each prints one JSON line with its seconds):

1. card and build: ``nvidia-smi``'s name and power limit; the ``nvcc``
   build of ``src/repro_torch/kernels/csrc/*.cu`` into ``build/``.
2. PageRank scale, ``backend="pallas"`` (kernel K2): ``rmat_edges(22, 16)``,
   the stand-in for LiveJournal (Ringo Table 3).  ``pagerank(n_iter=10)``,
   ``pagerank(tol=1e-6)`` and ``hits(n_iter=20)`` on "pallas" and "xla"
   must agree within 1e-5 of the largest value, PageRank must sum to 1, and
   K2 must launch once per PageRank round and twice per HITS round.
3. BSR path, ``backend="bsr"`` (kernels K1, K3): ``rmat_edges(14, 16)``,
   the reference's ceiling for the BSR layout.  PageRank and HITS on "bsr"
   against "xla" as in phase 2, PageRank against a float64 numpy power
   iteration, ``triangle_count(u, backend="bsr")`` equal to the oriented
   intersection exactly, with its one K3 launch through ``"sm90_wgmma"``,
   and ``connected_components`` against scipy.  K1 must launch 69 times
   (``K1_PATH_LAUNCHES``).  With ``--profile``, one more 10-round "bsr"
   PageRank runs under ``torch.profiler``: its device-busy share and K1's
   part of it.
3b. traversals and the rest of the analytics, in a launch window of its
   own.  Scale 22: ``bfs`` from the vertex of largest out-degree must
   auto-route to "frontier", equal "xla" bit for bit and equal a numpy
   level-synchronous BFS over the host CSR; ``frontier_fixpoint`` alone
   must read the host once a round (``torch.cuda.set_sync_debug_mode``);
   weighted ``sssp`` (uniform in [0.5, 4), numpy seed 7),
   ``connected_components`` and ``label_propagation(n_iter=20)`` on
   "frontier" must equal "xla"; a batched ``bfs`` of 4 sources with caps
   (1, 3, 8, none) must equal its rows' standalone runs;
   ``eigenvector_centrality(n_iter=50)`` and a 4-source 10-round
   ``personalized_pagerank`` on "pallas" must agree with "xla" and launch
   K2 exactly 50 and 40 times.  Scale 14: the same two on "bsr" and
   "pallas", ``k_core(k=8)`` and ``core_numbers`` equal to "xla" and to a
   numpy peel; each checked eigenvector and PPR call must launch its
   kernel 50 and 40 times, and the window K1 and K2 each (1 + WARM_REPS) x
   (50 + 40) + the peels' rounds;
   ``strongly_connected_components`` on "xla" and "bsr" equal to scipy's;
   ``per_node_triangles`` summing to 3x the triangle count; 16-source
   ``closeness_centrality`` on "frontier" equal to "xla".  Each comparison
   of two backends times both on their first call and then ``WARM_REPS``
   times more, the order alternating.  Its two lines print each analytic's
   seconds (under ``"frontier"`` and ``"analytics"``), the frontier's
   rounds and dense rounds, and the launches.
4. serving, kernel K4: ``qwen2.5-3b`` at full width and depth (36
   layers, d_model 2048) with random weights from a seeded generator,
   behind ``Engine`` with ``ServeConfig(batch=4, max_seq=2080)``: 4 prompts
   of 2048, 1536, 1024 and 512 token ids (numpy seed 0), 32 new tokens
   each.  K4 must launch once per layer in the prefill (36 times in the
   ``generate``), every output must hold its prompt plus 32 ids in
   ``[0, vocab)`` with finite logits, all 36 K4 launches must take the
   ``"sm90_wgmma"`` variant, a second ``generate`` must give the
   same tokens, and ``decode_step`` after ``prefill`` must agree with
   ``forward``'s last position (batch 2, S = 256) within 5e-2 of the
   largest logit.  With ``--profile``, one more prefill and one decode
   step run under ``torch.profiler``: their device-busy share and K4's
   part of it.
5. every kernel against its plain PyTorch version at the shapes phases 2-4
   gave it, with its time, the plain version's, a library call's where one
   computes the same function, and the card's lower bound.  Printed as one
   ``{"kernels": [...]}`` line.  K4's wgmma variant at the prefill shape
   must pass ``attention_error_ratios`` (max and mean error against the
   float32 plain version within twice those of the plain version that
   rounds p to bf16) and give the same bits twice; the CUDA-core variant at
   the same shape (the "before" time) must match its plain version within
   one bf16 ulp per element (``|got - want| <= 2^-7·|want| + 1e-6``), and
   in float32 within 2e-5.  K2 must give the same bits twice; its row
   also times other piece sizes.  K1 must give the same bits twice, beat
   ``torch.sparse_bsr_tensor @ x`` and equal its device-built tables'
   plain versions; its row times piece sizes 2-32 and its C entry point
   alone.
   K3 must equal its plain version exactly on the sorted and on a shuffled
   triple order, build the plain ``run_table`` on the device, and be at
   least 8x faster than its ``"wmma"`` variant timed at the same shape;
   its row also times, as a yardstick only, ``torch.mm`` of the dense
   fp16 adjacency.  The
   ptxas report of K1's and K3's sources must show no spill.

The launch counts of phases 2-3 and of phase 4's ``generate`` are the main
path's, and phase 3b's are its own: each window's counts are zeroed just
before it and read just after it.  Any failed check raises, and
the script exits non-zero without its last line, which on success is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it fails before any phase.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,     # CUDA cores
              torch.bfloat16: 989e12,   # tensor cores
              torch.float16: 989e12}

TOL = 1e-5   # relative to the largest value, as the reference's parity tests

# file:line of each Pallas TPU kernel the port replaces
REPLACES = {
    "bsr_spmv": "src/repro/kernels/bsr_spmv.py:53",
    "segment_sum_chunked": "src/repro/kernels/segment_sum.py:97",
    "bsr_tricount": "src/repro/kernels/bsr_tricount.py:46",
    "flash_attention_fwd": "src/repro/kernels/flash_attention.py:84",
}
SOURCES = {
    "bsr_spmv": "src/repro_torch/kernels/csrc/bsr_spmv.cu",
    "segment_sum_chunked": "src/repro_torch/kernels/csrc/segment_sum.cu",
    "bsr_tricount": "src/repro_torch/kernels/csrc/bsr_tricount.cu",
    "flash_attention_fwd": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
}
# K1 on phase 3's path: PageRank 10 rounds, 9 rounds to tol, HITS 20
# rounds (a pull and a push each), the float64 check's 10 rounds
K1_PATH_LAUNCHES = 69
WARM_REPS = 3   # phase 3b: timed calls of each backend after the checked one
SERVE_PROMPTS = (2048, 1536, 1024, 512)   # prompt lengths of phase 4
SERVE_NEW = 32
DECODE_TOL = 5e-2   # decode vs forward, relative to the largest logit
BF16_ULP = 2.0 ** -7   # one bf16 ulp relative to the value (8 significant bits)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median CUDA-event time of one call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: int, flops: int, dtype) -> tuple:
    """Least time the card could take: max of bytes/bandwidth, ops/peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def compare_runs(g, backend, counter, runs):
    """Run each (name, fn, min launches) on ``backend`` and "xla"; check
    agreement and the kernel's launches; return one record per run."""
    out = {}
    for name, fn, want_launches in runs:
        ref, t_ref = timed(lambda: fn("xla"))
        before = counter.launches
        got, t_got = timed(lambda: fn(backend))
        launches = counter.launches - before
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        err = max(max_abs(a, b) for a, b in zip(got, ref))
        scale = max(float(r.abs().max()) for r in ref)
        check(all(torch.isfinite(x).all() for x in got) and
              all(x.shape == (g.n_nodes,) for x in got),
              f"{name}: finite ({g.n_nodes},) output")
        check(err <= TOL * scale, f"{name} {backend} vs xla: max|d| {err} > "
              f"{TOL} * {scale}")
        check(launches >= want_launches,
              f"{name}: {launches} launches < {want_launches}")
        rec = {"seconds_xla": t_ref, f"seconds_{backend}": t_got,
               "max_abs_diff": err, "max_abs_xla": scale,
               "launches": launches}
        if name.startswith("pagerank"):
            total = float(got[0].double().sum())
            check(abs(total - 1.0) <= 1e-4, f"{name}: sum {total} != 1")
            rec["sum"] = total
        out[name] = rec
    return out


def np_pagerank(src, dst, n, n_iter=10, damping=0.85):
    """Float64 power iteration over an edge list (the oracle of the
    reference's tests, vectorized)."""
    outdeg = np.bincount(src, minlength=n).astype(np.float64)
    pr = np.full(n, 1.0 / n)
    for _ in range(n_iter):
        new = np.full(n, (1.0 - damping) / n)
        new += damping * pr[outdeg == 0].sum() / n
        np.add.at(new, dst, damping * pr[src] / outdeg[src])
        pr = new
    return pr


def phase_pagerank_scale(dev, scale):
    from repro_torch.core import algorithms as A
    from repro_torch.core.graph import Graph
    from repro_torch.data.rmat import rmat_edges
    from repro_torch.kernels.segment_sum import segment_sum_chunked
    t0 = time.perf_counter()
    (src, dst), t_gen = timed(lambda: rmat_edges(scale, 16, seed=0))
    g, t_build = timed(lambda: Graph.from_edges(src, dst, device=dev))
    runs = [("pagerank_n10", lambda be: A.pagerank(g, n_iter=10, backend=be), 10),
            ("pagerank_tol", lambda be: A.pagerank(g, tol=1e-6, backend=be), 1),
            ("hits_n20", lambda be: A.hits(g, n_iter=20, backend=be), 40)]
    res = compare_runs(g, "pallas", segment_sum_chunked, runs)
    emit({"phase": "pagerank_scale", "backend": "pallas", "scale": scale,
          "edges_generated": int(src.shape[0]), "nodes": g.n_nodes,
          "edges": g.n_edges, "seconds_rmat": t_gen,
          "seconds_graph": t_build, "runs": res,
          "seconds": time.perf_counter() - t0})
    return g


def phase_bsr(dev, scale):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components as sp_cc
    from repro_torch.core import algorithms as A
    from repro_torch.core.graph import Graph
    from repro_torch.data.rmat import rmat_edges
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    from repro_torch.kernels.bsr_tricount import bsr_tricount
    t0 = time.perf_counter()
    src, dst = rmat_edges(scale, 16, seed=0)
    g = Graph.from_edges(src, dst, device=dev)
    # HITS pulls and pushes once a round: 40 launches in 20 rounds show K1
    # ran on both the pull (M) and the push (M^T) tile streams
    runs = [("pagerank_n10", lambda be: A.pagerank(g, n_iter=10, backend=be), 10),
            ("pagerank_tol", lambda be: A.pagerank(g, tol=1e-6, backend=be), 1),
            ("hits_n20", lambda be: A.hits(g, n_iter=20, backend=be), 40)]
    res = compare_runs(g, "bsr", bsr_spmv, runs)

    # PageRank against an independent float64 power iteration
    s, d = (t.cpu().numpy() for t in g.out_edges())
    want = np_pagerank(s, d, g.n_nodes)
    got = A.pagerank(g, n_iter=10, backend="bsr").cpu().numpy()
    err_np = float(np.abs(got - want).max())
    check(err_np <= 2e-5, f"pagerank bsr vs float64 oracle: {err_np}")

    u = g.to_undirected()
    tri_xla, t_xla = timed(lambda: A.triangle_count(u))
    before = bsr_tricount.launches
    by_variant = bsr_tricount.launches_by_variant
    variants_before = dict(by_variant)
    tri_bsr, t_bsr = timed(lambda: A.triangle_count(u, backend="bsr"))
    k3 = bsr_tricount.launches - before
    k3_variants = {k: by_variant[k] - variants_before[k] for k in by_variant}
    check(tri_bsr == tri_xla, f"triangles bsr {tri_bsr} != xla {tri_xla}")
    check(k3 == 1, f"K3 launched {k3} times for one triangle count")
    check(k3_variants["sm90_wgmma"] == 1,
          f"K3's launch on the path took {k3_variants}, not sm90_wgmma")

    labels, t_cc = timed(lambda: A.connected_components(g))
    n = g.n_nodes
    adj = sp.coo_matrix((np.ones(len(s)), (s, d)), shape=(n, n))
    _, comp = sp_cc(adj, directed=True, connection="weak")
    min_id = np.full(comp.max() + 1, n)
    np.minimum.at(min_id, comp, np.arange(n))
    check(np.array_equal(labels.cpu().numpy(), min_id[comp]),
          "connected components vs scipy")

    tiles, rows, _, nb = u.plan().bsr()
    t_ij, _, _ = u.plan().tri_triples()
    emit({"phase": "bsr", "backend": "bsr", "scale": scale,
          "nodes": g.n_nodes, "edges": g.n_edges, "row_blocks": nb,
          "tiles_undirected": int(tiles.shape[0]),
          "triples": int(t_ij.shape[0]), "runs": res,
          "pagerank_vs_float64_max_abs": err_np,
          "triangles": tri_xla, "seconds_triangles_xla": t_xla,
          "seconds_triangles_bsr": t_bsr, "k3_launches": k3,
          "k3_launches_by_variant": k3_variants,
          "components": int(len(np.unique(comp))), "seconds_cc": t_cc,
          "seconds": time.perf_counter() - t0})
    return g, u, k3_variants


def device_busy(fn, parts) -> dict:
    """Run ``fn`` once under ``torch.profiler``: its synchronised wall
    seconds, the summed device time of the kernels it ran, and for each
    ``parts`` key the device seconds of the kernels whose names contain
    one of its strings."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in ev) / 1e6
    out = {"wall_seconds": wall, "kernels": len(ev), "device_seconds": busy,
           "busy_share": busy / wall}
    for key, names in parts.items():
        part = sum(e.device_time for e in ev
                   if any(n in e.name for n in names)) / 1e6
        out[f"{key}_device_seconds"] = part
        out[f"{key}_share_of_busy"] = part / busy if busy else 0.0
    return out


def profile_bsr(g14):
    """Where the time of one 10-round "bsr" PageRank goes: device-busy
    share and K1's part of the busy time (its kernels and its tables')."""
    from repro_torch.core import algorithms as A
    emit({"phase": "profile_bsr", "pagerank_n10": device_busy(
        lambda: A.pagerank(g14, n_iter=10, backend="bsr"),
        {"k1": ("bsr_spmv", "piece_")})})


def np_bfs_levels(ptr, idx, n, source):
    """Level-synchronous BFS over a host CSR (numpy): int32 levels, -1
    where unreachable.  Independent of the port's code."""
    level = np.full(n, -1, np.int32)
    level[source] = 0
    front, depth = np.asarray([source]), 0
    while front.size:
        starts, lens = ptr[front], ptr[front + 1] - ptr[front]
        lane = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                      lens)
        nbr = idx[np.repeat(starts, lens) + lane]
        depth += 1
        level[nbr[level[nbr] < 0]] = depth
        front = np.flatnonzero(level == depth)
    return level


def np_peel(row, col, n, k):
    """k-core peel over an undirected edge list (numpy): the alive mask and
    the number of rounds an until-unchanged fixpoint runs (the last one sees
    no change)."""
    alive, rounds = np.ones(n, bool), 0
    while True:
        rounds += 1
        deg = np.bincount(row, weights=alive[col], minlength=n)
        new = alive & (deg >= k)
        if np.array_equal(new, alive):
            return alive, rounds
        alive = new


def np_core_numbers(row, col, n, k_max):
    """``core_numbers``'s sweep in numpy: core numbers and total rounds."""
    core, total = np.zeros(n, np.int32), 0
    for k in range(1, k_max + 1):
        alive, rounds = np_peel(row, col, n, k)
        total += rounds
        if not alive.any():
            break
        core[alive] = k
    return core, total


def count_syncs(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result and the synchronizing CUDA calls it made, counted by the
    ``file:line`` of the Python call that made them."""
    import collections
    import warnings
    sync()
    # switching the monitor on syncs once itself: not part of ``fn``
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    return out, dict(collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message)))


def phase_traversal(dev, g22, g14, u14, scales=(22, 14)):
    """Phase 3b: the frontier backend and the rest of the analytics, on the
    graphs of phases 2 (``g22``) and 3 (``g14`` and its undirected ``u14``),
    whose R-MAT ``scales`` the lines print."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components as sp_cc
    from repro_torch.core import algorithms as A
    from repro_torch.core import engine
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    from repro_torch.kernels.segment_sum import segment_sum_chunked
    ff = engine.frontier_fixpoint
    t0 = time.perf_counter()

    def warm(fns, reps=WARM_REPS):
        """Seconds of ``reps`` further calls of each ``fns[backend]``, the
        backends' order alternating from call to call."""
        order, out = list(fns), {be: [] for be in fns}
        for i in range(reps):
            for be in (order if i % 2 == 0 else order[::-1]):
                out[be].append(timed(fns[be])[1])
        return out

    def frontier_vs_xla(name, fn, rec):
        """``fn(backend)`` on "frontier" and "xla": equal bits, the first
        call's rounds, each backend's first and warm seconds."""
        r0, d0 = ff.rounds, ff.dense_rounds
        got, t_f = timed(lambda: fn("frontier"))
        rounds, dense = ff.rounds - r0, ff.dense_rounds - d0
        want, t_x = timed(lambda: fn("xla"))
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"{name}: frontier != xla")
        check(rounds > 0, f"{name}: no frontier round ran")
        w = warm({be: (lambda b=be: fn(b)) for be in ("frontier", "xla")})
        rec[name] = {"seconds_first_frontier": t_f, "seconds_first_xla": t_x,
                     "seconds_frontier": w["frontier"],
                     "seconds_xla": w["xla"], "rounds": rounds,
                     "dense_rounds": dense}
        return got

    def float_vs_xla(name, fn, backend, rec):
        """``fn(backend)`` within ``TOL`` of ``fn("xla")``; returns the K1/K2
        launches of that one checked call, then times both warm."""
        want, t_x = timed(lambda: fn("xla"))
        before = [k.launches for k in kernels]
        got, t_b = timed(lambda: fn(backend))
        used = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
        err, scale = max_abs(got, want), float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
              f"{name} {backend}: finite, shaped as xla")
        check(err <= TOL * scale, f"{name} {backend} vs xla: max|d| {err} > "
              f"{TOL} * {scale}")
        w = warm({be: (lambda b=be: fn(b)) for be in (backend, "xla")})
        rec.setdefault(name, {})[backend] = {
            "seconds_first": t_b, "seconds_first_xla": t_x,
            "seconds": w[backend], "seconds_xla": w["xla"],
            "max_abs_diff": err, "launches": used}
        return used

    kernels = (bsr_spmv, segment_sum_chunked)
    for k in kernels:
        k.launches = 0

    # -- scale 22: the frontier against "xla"; K2 under two more analytics
    plan = g22.plan()
    n = g22.n_nodes
    src = int(torch.argmax(plan.out_deg))
    check(engine.select_backend(plan, None, op="bfs") == "frontier",
          "bfs at scale 22 does not auto-route to frontier")
    _, t_exec = timed(lambda: engine.get_exec(plan, "frontier"))
    r22 = {}
    lv = frontier_vs_xla("bfs", lambda be: A.bfs(
        g22, src, backend=None if be == "frontier" else be), r22)
    ptr = g22.out_ptr[: n + 1].cpu().numpy().astype(np.int64)
    idx = g22.out_idx[: g22.n_edges].cpu().numpy()
    want_lv, t_np = timed(lambda: np_bfs_levels(ptr, idx, n, src))
    check(np.array_equal(lv.cpu().numpy(), want_lv),
          "bfs at scale 22 vs the numpy level-synchronous BFS")
    r22["bfs"].update(seconds_numpy=t_np, reached=int((want_lv >= 0).sum()),
                      depth=int(want_lv.max()))
    # one host read per round: the fixpoint alone under the sync monitor
    init = torch.full((n,), float("inf"), device=dev)
    init[src] = 0.0
    seed = torch.zeros((n,), dtype=torch.bool, device=dev)
    seed[src] = True
    hop = torch.ones((), device=dev)
    r0 = ff.rounds
    _, syncs = count_syncs(lambda: ff(plan, init, seed, weights=hop))
    rounds = ff.rounds - r0
    check(sum(syncs.values()) == rounds + 1, f"frontier_fixpoint: host "
          f"syncs {syncs} in {rounds} rounds, not one a round plus the read "
          f"that ends it")
    _, entry_syncs = count_syncs(lambda: A.bfs(g22, src))
    r22["bfs"].update(fixpoint_syncs=syncs, fixpoint_rounds=rounds,
                      entry_syncs=entry_syncs)
    w = torch.from_numpy(np.random.default_rng(7).uniform(
        0.5, 4.0, g22.n_edges).astype(np.float32)).to(dev)
    frontier_vs_xla("sssp_weighted",
                    lambda be: A.sssp(g22, src, w, backend=be), r22)
    def undirected_execs():
        uplan = g22.plan().undirected().plan()
        for be in ("frontier", "xla"):
            engine.get_exec(uplan, be)
        return uplan
    u22, t_u22 = timed(undirected_execs)
    frontier_vs_xla("connected_components",
                    lambda be: A.connected_components(g22, backend=be), r22)
    frontier_vs_xla("label_propagation_n20", lambda be: A.label_propagation(
        g22, n_iter=20, backend=be), r22)
    srcs = torch.tensor([src, 0, n // 2, n - 1], device=dev)
    caps = np.asarray([1, 3, 8, 1 << 30])      # the last row runs uncapped
    batched = A.bfs(g22, srcs, n_iter=caps, backend="frontier")
    for i, c in enumerate(caps):
        one = A.bfs(g22, int(srcs[i]), n_iter=None if i == 3 else int(c),
                    backend="frontier")
        check(torch.equal(batched[i], one), f"batched bfs row {i} != its "
              f"standalone run")

    srcs4 = torch.tensor([src, 1, n // 3, n - 2], device=dev)
    f22 = {}
    k2_eig = float_vs_xla("eigenvector_n50", lambda be: A.eigenvector_centrality(
        g22, n_iter=50, backend=be), "pallas", f22)["segment_sum_chunked"]
    k2_ppr = float_vs_xla("ppr_4x10", lambda be: A.personalized_pagerank(
        g22, srcs4, n_iter=10, backend=be), "pallas", f22)["segment_sum_chunked"]
    check((k2_eig, k2_ppr) == (50, 4 * 10), f"K2 launched {k2_eig} times "
          f"for 50 eigenvector rounds and {k2_ppr} for 4 x 10 PPR rounds")
    emit({"phase": "traversal_scale", "scale": scales[0], "nodes": n,
          "edges": g22.n_edges, "undirected_edges": u22.n_edges,
          "source": src, "seconds_frontier_exec": t_exec,
          "seconds_undirected": t_u22, "frontier": r22, "analytics": f22,
          "k2_launches": {"eigenvector_n50": k2_eig, "ppr_4x10": k2_ppr},
          "seconds": time.perf_counter() - t0})

    # -- scale 14: K1 and K2 under eigenvector, PPR, k-core, core numbers
    n14 = g14.n_nodes
    srcs14 = torch.tensor([0, 1, n14 // 2, n14 - 1], device=dev)
    us, ud = (t.cpu().numpy() for t in u14.out_edges())
    un = u14.n_nodes
    core_np, core_rounds = np_core_numbers(
        us, ud, un, int(u14.plan().out_deg.max()))
    alive8, kcore_rounds = np_peel(us, ud, un, 8)
    f14 = {}
    for k in kernels:
        k.launches = 0
    for be, kname in (("bsr", "bsr_spmv"), ("pallas", "segment_sum_chunked")):
        used = (float_vs_xla("eigenvector_n50", lambda b: A.eigenvector_centrality(
            g14, n_iter=50, backend=b), be, f14)[kname],
            float_vs_xla("ppr_4x10", lambda b: A.personalized_pagerank(
                g14, srcs14, n_iter=10, backend=b), be, f14)[kname])
        check(used == (50, 4 * 10), f"{kname} launched {used} times for 50 "
              f"eigenvector and 4 x 10 PPR rounds at scale 14")
        for name, fn in (("k_core_8", lambda b: A.k_core(g14, 8, backend=b)),
                         ("core_numbers",
                          lambda b: A.core_numbers(g14, backend=b))):
            want, t_x = timed(lambda: fn("xla"))
            got, t_b = timed(lambda: fn(be))
            check(torch.equal(got, want), f"{name} {be} != xla")
            f14.setdefault(name, {"seconds_xla": t_x})[f"seconds_{be}"] = t_b
    launches = {k.__name__: k.launches for k in kernels}
    # each float_vs_xla call: one checked call and WARM_REPS timed ones
    want_launches = (1 + WARM_REPS) * (50 + 4 * 10) + kcore_rounds + core_rounds
    check(launches == {"bsr_spmv": want_launches,
                       "segment_sum_chunked": want_launches},
          f"K1/K2 launches {launches} at scale 14, not {1 + WARM_REPS} x "
          f"(50 + 40) + "
          f"{kcore_rounds} k-core + {core_rounds} core-number rounds")
    # the port's mask and core numbers against the numpy peel, mapped back
    # from the undirected view by original id
    pos = u14.dense_of(g14.node_ids[:n14]).long().clamp(0, un - 1)
    present = (u14.node_ids[pos] == g14.node_ids[:n14]).cpu().numpy()
    pos = pos.cpu().numpy()
    check(np.array_equal(A.k_core(g14, 8).cpu().numpy(),
                         present & alive8[pos]), "k_core(8) vs numpy peel")
    check(np.array_equal(A.core_numbers(g14).cpu().numpy(),
                         np.where(present, core_np[pos], 0)),
          "core_numbers vs numpy peel")

    s, d = (t.cpu().numpy() for t in g14.out_edges())
    _, comp = sp_cc(sp.coo_matrix((np.ones(len(s)), (s, d)),
                                  shape=(n14, n14)),
                    directed=True, connection="strong")
    max_id = np.full(comp.max() + 1, -1)
    np.maximum.at(max_id, comp, np.arange(n14))
    scc = {}
    for be in ("xla", "bsr"):
        lab, scc[f"seconds_{be}"] = timed(
            lambda: A.strongly_connected_components(g14, backend=be))
        check(np.array_equal(lab.cpu().numpy(), max_id[comp]),
              f"scc {be} vs scipy")
    scc["components"] = int(comp.max() + 1)
    tri, t_tri = timed(lambda: A.per_node_triangles(u14))
    check(int(tri.sum()) == 3 * A.triangle_count(u14),
          "per-node triangles do not sum to 3 x triangle_count")
    c14 = {}
    frontier_vs_xla("closeness_16", lambda be: A.closeness_centrality(
        g14, n_samples=16, backend=be), c14)
    emit({"phase": "traversal_bsr", "scale": scales[1], "nodes": n14,
          "analytics": f14, "launches": launches,
          "k_core_8_rounds": kcore_rounds, "core_number_rounds": core_rounds,
          "max_core": int(core_np.max()), "scc": scc,
          "seconds_per_node_triangles": t_tri, "frontier": c14,
          "seconds": time.perf_counter() - t0})


def phase_serve(dev, kernels, profile):
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, ServeConfig
    t0 = time.perf_counter()
    cfg = get_config("qwen2.5-3b")          # full width and depth
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model, t_init = timed(lambda: Transformer.init_params(cfg, gen,
                                                          device=dev))
    check(len(model.layers) == cfg.n_layers == 36 and cfg.d_model == 2048,
          "qwen2.5-3b at full depth and width")
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = nbytes(*model.parameters())
    eng, t_engine = timed(lambda: Engine(cfg, model, ServeConfig(
        batch=4, max_seq=max(SERVE_PROMPTS) + SERVE_NEW), device=dev))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SERVE_PROMPTS]

    for k in kernels:
        k.launches = 0
    by_variant = flash_attention_fwd.launches_by_variant
    for name in by_variant:
        by_variant[name] = 0
    out, t_gen = timed(lambda: eng.generate(prompts, SERVE_NEW))
    launches = {k.__name__: k.launches for k in kernels}
    k4_variants = dict(by_variant)
    stats = dict(eng.stats)
    check(launches["flash_attention_fwd"] == cfg.n_layers,
          f"K4 launched {launches['flash_attention_fwd']} times in one "
          f"generate, not once per layer ({cfg.n_layers})")
    check(k4_variants["sm90_wgmma"] == cfg.n_layers,
          f"K4 launches by variant {k4_variants}: not all {cfg.n_layers} "
          f"through sm90_wgmma")
    check(all(len(o) == len(p) + SERVE_NEW for o, p in zip(out, prompts)),
          "each output holds its prompt plus the new tokens")
    check(all(o[:len(p)] == p for o, p in zip(out, prompts)),
          "each output starts with its prompt")
    check(all(0 <= t < cfg.vocab_size for o in out for t in o),
          "token ids in [0, vocab)")
    check(bool(torch.isfinite(eng.last_logits).all()), "finite logits")
    again, t_again = timed(lambda: eng.generate(prompts, SERVE_NEW))
    check(again == out, "a second generate gives the same tokens")
    peak = torch.cuda.max_memory_allocated()

    # decode agrees with forward (tests/test_models.py's check, on the card)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)
                                         ).astype(np.int32)).to(dev)
    full, _ = model({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :-1]}, 260)
    dec, _ = model.decode_step(cache, toks[:, -1:], 255)
    want, got = full[:, -1].float(), dec[:, 0].float()
    check(bool(torch.isfinite(want).all() and torch.isfinite(got).all()),
          "finite forward and decode logits")
    err = max_abs(got, want)
    scale = float(want.abs().max())
    check(err <= DECODE_TOL * scale, f"decode vs forward: max|d| {err} > "
          f"{DECODE_TOL} * {scale}")

    rec = {}
    if profile:   # where the time goes: one prefill of the batch, one decode
        plen = max(SERVE_PROMPTS)
        padded = np.zeros((4, plen), np.int32)
        for i, p in enumerate(prompts):
            padded[i, plen - len(p):] = p
        batch = {"tokens": torch.from_numpy(padded).to(dev)}
        held = {}
        k4 = {"k4": ("flash_fwd",)}
        rec["profile_prefill"] = device_busy(lambda: held.update(zip(
            ("logits", "cache"), eng.model.prefill(batch, eng.scfg.max_seq))),
            k4)
        cur = torch.argmax(held["logits"][:, -1], dim=-1)[:, None]
        rec["profile_decode_step"] = device_busy(
            lambda: eng.model.decode_step(held["cache"], cur, plen), k4)
    new_tokens = len(prompts) * stats["decode_steps"]
    emit({"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": n_params,
          "param_bytes": param_bytes, "param_dtype": cfg.param_dtype,
          "compute_dtype": cfg.compute_dtype,
          "memory_allocated_before": mem_before,
          "max_memory_allocated": peak, "seconds_init": t_init,
          "seconds_engine": t_engine, "prompt_lens": list(SERVE_PROMPTS),
          "new_tokens": SERVE_NEW, "seconds_generate": t_gen,
          "seconds_generate_again": t_again,
          "prefill_seconds": stats["prefill_seconds"],
          "decode_seconds_per_token": stats["decode_seconds"]
          / stats["decode_steps"],
          "decode_tokens_per_second": new_tokens / stats["decode_seconds"],
          "tokens_per_second": new_tokens / t_gen,
          "launches": launches, "k4_launches_by_variant": k4_variants,
          "decode_vs_forward": {"max_abs_diff": err, "max_abs_logit": scale,
                                "tolerance": DECODE_TOL * scale},
          **rec, "seconds": time.perf_counter() - t0})
    return launches["flash_attention_fwd"], k4_variants


def one_ulp_ratio(got, want) -> float:
    """Largest |got - want| / (2^-7·|want| + 1e-6): <= 1 is one bf16 ulp."""
    limit = BF16_ULP * want.double().abs() + 1e-6
    return float(((got.double() - want.double()).abs() / limit).max())


def kernel_k4(launches, by_variant):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import (
        attention_error_ratios, flash_attention_fwd, flash_attention_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(shape, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for _ in range(3)]

    def common(q, k, v, out, want, reps):
        b, s, h, d = q.shape
        flops = 2 * d * s * (s + 1) * b * h   # causal q·kᵀ and p·v
        bnd, by = bound_ms(nbytes(q, k, v, out), flops, q.dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        return {"ms": cuda_ms(lambda: flash_attention_fwd(q, k, v), reps),
                "plain_ms": cuda_ms(
                    lambda: flash_attention_fwd_plain(q, k, v), 3),
                "bound_ms": bnd, "bound_by": by,
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), reps),
                "library_max_abs_diff": max_abs(lib.transpose(1, 2), want),
                "gflop": flops / 1e9, "shape": list(q.shape),
                "dtype": str(q.dtype)}

    # the prefill's shape (B=4, S=2048, 16 heads after the GQA repeat)
    shape = (4, 2048, 16, 128)
    q, k, v = qkv(shape, torch.bfloat16)
    which = fa.variant(q.dtype, shape[3])
    check(which == "sm90_wgmma", f"the prefill shape takes {which}")
    out = flash_attention_fwd(q, k, v, causal=True)
    again = flash_attention_fwd(q, k, v, causal=True)
    sync()
    check(torch.equal(out, again), "K4 wgmma: two launches differ")
    ref = flash_attention_fwd_plain(q.float(), k.float(), v.float())
    base = flash_attention_fwd_plain(q, k, v, round_p=True)
    rule = attention_error_ratios(out, ref, base)
    check(rule["ok"], f"K4 wgmma {shape}: error ratios {rule}")
    row = common(q, k, v, out, ref, 20)
    row.update(name="flash_attention_fwd", launches=launches,
               launches_by_variant=by_variant, variant=which,
               max_abs_err=rule["max_abs_err"],
               tolerance="max|got-ref| <= 2*max|base-ref| + 1e-6 and "
                         "mean|got-ref| <= 2*mean|base-ref| (ref: plain f32,"
                         " base: plain with p rounded to bf16)",
               error_ratios=rule, target_ms=0.6,
               library="scaled_dot_product_attention(is_causal=True) on "
                       "(B, H, S, D) views")
    row["meets_target"] = row["ms"] <= row["target_ms"]
    # the CUDA-core kernel at the same bf16 shape: the time before this PR
    cc = fa.launch("cuda_core", q, k, v, causal=True)
    want = flash_attention_fwd_plain(q, k, v)
    cc_ratio = one_ulp_ratio(cc, want)
    check(cc_ratio <= 1.0, f"K4 cuda_core bf16 {shape}: max|d|/limit "
          f"{cc_ratio} > 1")
    row["cuda_core_bf16"] = {
        "ms": cuda_ms(lambda: fa.launch("cuda_core", q, k, v), 5),
        "max_abs_err": max_abs(cc, want), "max_err_over_limit": cc_ratio,
        "tolerance": f"{BF16_ULP}*|want| + 1e-6 per element"}
    del q, k, v, out, again, ref, base, cc, want

    f32_shape = (1, 1024, 16, 128)
    q, k, v = qkv(f32_shape, torch.float32)
    out = flash_attention_fwd(q, k, v, causal=True)
    want = flash_attention_fwd_plain(q, k, v)
    err = max_abs(out, want)
    check(err <= 2e-5, f"K4 float32 {f32_shape}: max|d| {err} > 2e-5")
    f32 = common(q, k, v, out, want, 5)
    f32.update(variant=fa.variant(q.dtype, f32_shape[3]), max_abs_err=err,
               tolerance=2e-5)
    row["f32"] = f32
    return row


def kernel_k1(g14, launches, ptxas):
    from repro_torch.kernels import _build
    from repro_torch.kernels import bsr_spmv as k1
    from repro_torch.kernels.bsr_spmv import bsr_spmv, bsr_spmv_plain
    from repro_torch.kernels.pieces import piece_table
    tiles, rows, cols, nb = g14.plan().bsr()
    b, nnzb, dev = tiles.shape[1], tiles.shape[0], tiles.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((nb, b), generator=gen, device=dev)
    y = bsr_spmv(tiles, rows, cols, x, nb)
    y_again = bsr_spmv(tiles, rows, cols, x, nb)
    y_plain = bsr_spmv_plain(tiles, rows, cols, x, nb)
    check(torch.equal(y, y_again), "K1: two launches differ")
    err = max_abs(y, y_plain)
    tol = 1e-5 * max(1.0, float(y_plain.abs().max()))
    check(err <= tol, f"K1 f32: {err} > {tol}")
    tiles_bf = tiles.to(torch.bfloat16)
    err_bf = max_abs(bsr_spmv(tiles_bf, rows, cols, x, nb),
                     bsr_spmv_plain(tiles_bf, rows, cols, x, nb))
    tol_bf = 5e-2 * max(1.0, float(y_plain.abs().max()))
    check(err_bf <= tol_bf, f"K1 bf16: {err_bf} > {tol_bf}")
    # piece size -> ms: how PIECE_TILES was chosen
    sweep = {}
    for piece in (2, 4, 8, 16, 32):
        yp = k1.launch(tiles, rows, cols, x, nb, piece)
        check(max_abs(yp, y_plain) <= tol, f"K1 piece {piece}: differs")
        sweep[piece] = cuda_ms(lambda: k1.launch(
            tiles, rows, cols, x, nb, piece), 10)
    ms = cuda_ms(lambda: bsr_spmv(tiles, rows, cols, x, nb), 20)
    # the C entry point alone (its four kernels), the wrapper's
    # allocations and checks left out
    tables = torch.empty((2 * (nb + 1),), dtype=torch.int32, device=dev)
    max_pieces = nb + -(-nnzb // k1.PIECE_TILES)
    part = torch.empty((max_pieces, b), device=dev)
    y_k = torch.empty_like(y)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernel_ms = cuda_ms(lambda: _build.launch(
        "bsr_spmv_f32", tiles.data_ptr(), rows.data_ptr(), cols.data_ptr(),
        x.data_ptr(), tables.data_ptr(), part.data_ptr(), y_k.data_ptr(),
        nnzb, nb, b, k1.PIECE_TILES, max_pieces, stream), 20)
    check(torch.equal(y_k, y), "K1 kernels alone differ from the wrapper")
    row_start = torch.searchsorted(
        rows, torch.arange(nb + 1, dtype=torch.int32, device=dev)
    ).to(torch.int32)
    check(torch.equal(tables[:nb + 1], row_start) and torch.equal(
        tables[nb + 1:], piece_table(row_start, k1.PIECE_TILES)),
        "K1's device-built tables differ from piece_table")
    plain_ms = cuda_ms(lambda: bsr_spmv_plain(tiles, rows, cols, x, nb), 5)
    lib_ms, lib_note = None, "torch.sparse_bsr_tensor @ x"
    try:
        a = torch.sparse_bsr_tensor(row_start, cols, tiles,
                                    size=(nb * b, nb * b))
        xv = x.reshape(-1, 1)
        lib_err = max_abs((a @ xv).reshape(nb, b), y_plain)
        lib_ms = cuda_ms(lambda: a @ xv, 20)
        lib_note += f" (max|d| vs plain {lib_err})"
    except (RuntimeError, NotImplementedError) as e:   # yardstick only
        lib_note += f" unavailable: {str(e).splitlines()[0][:160]}"
    bnd, by = bound_ms(nbytes(tiles, rows, cols, x, y),
                       2 * nnzb * b * b, torch.float32)
    ms_bf = cuda_ms(lambda: bsr_spmv(tiles_bf, rows, cols, x, nb), 20)
    bnd_bf, _ = bound_ms(nbytes(tiles_bf, rows, cols, x, y),
                         2 * nnzb * b * b, torch.bfloat16)
    if lib_ms is not None:
        check(ms < lib_ms, f"K1 {ms} ms not faster than the library's "
              f"{lib_ms} ms")
    return {"name": "bsr_spmv", "launches": launches, "max_abs_err": err,
            "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
            "library": lib_note, "kernels_only_ms": kernel_ms,
            "bit_equal_twice": True, "piece_tiles": k1.PIECE_TILES,
            "pieces": int(piece_table(row_start, k1.PIECE_TILES)[-1]),
            "piece_sweep_ms": sweep,
            "faster_than_library": None if lib_ms is None else ms < lib_ms,
            "share_of_byte_bound": bnd / ms, "ptxas": ptxas,
            "shape": {"tiles": list(tiles.shape), "n_row_blocks": nb},
            "bf16": {"max_abs_err": err_bf, "tolerance": tol_bf, "ms": ms_bf,
                     "bound_ms": bnd_bf,
                     "share_of_byte_bound": bnd_bf / ms_bf}}


def kernel_k2(g22, launches):
    from repro_torch.core import engine
    from repro_torch.kernels.segment_sum import (segment_sum_chunked,
                                                 segment_sum_chunked_plain)
    from repro_torch.kernels import segment_sum as ss
    ex = engine.get_exec(g22.plan(), "pallas")
    lids, blk, nb = ex.p_lids, ex.p_blk, ex.nb_in
    dev = lids.device
    gen = torch.Generator(device=dev).manual_seed(0)
    ev = torch.rand((g22.n_edges,), generator=gen, device=dev)
    vals = torch.zeros(lids.shape, dtype=torch.float32, device=dev)
    vals.view(-1)[ex.p_pos] = ev
    y = segment_sum_chunked(vals, lids, blk, nb)
    y_again = segment_sum_chunked(vals, lids, blk, nb)
    y_plain = segment_sum_chunked_plain(vals, lids, blk, nb)
    check(torch.equal(y, y_again), "K2: two launches differ")
    err = max_abs(y, y_plain)
    tol = 1e-5 * max(1.0, float(y_plain.abs().max()))
    check(err <= tol, f"K2: {err} > {tol}")
    block_start = torch.searchsorted(
        blk, torch.arange(nb + 1, dtype=torch.int32, device=dev))
    longest = int((block_start[1:] - block_start[:-1]).max())
    pieces = int(ss.piece_table(block_start.to(torch.int32),
                                ss.PIECE_CHUNKS)[-1])
    sweep = {}   # piece size -> ms: how PIECE_CHUNKS was chosen
    for piece in (4, 8, 16, 32, 64):
        yp = ss.launch(vals, lids, blk, nb, piece)
        check(max_abs(yp, y_plain) <= tol, f"K2 piece {piece}: differs")
        sweep[piece] = cuda_ms(lambda: ss.launch(vals, lids, blk, nb, piece),
                               10)
    ms = cuda_ms(lambda: segment_sum_chunked(vals, lids, blk, nb), 20)
    # the C entry point alone (its four kernels), the wrapper's
    # allocations and checks left out
    from repro_torch.kernels import _build
    tables = torch.empty((2 * (nb + 1),), dtype=torch.int32, device=dev)
    max_pieces = nb + -(-vals.shape[0] // ss.PIECE_CHUNKS)
    part = torch.empty((max_pieces, 128), device=dev)
    y_k = torch.empty_like(y)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernel_ms = cuda_ms(lambda: _build.launch(
        "segment_sum_chunked", vals.data_ptr(), lids.data_ptr(),
        blk.data_ptr(), tables.data_ptr(), part.data_ptr(), y_k.data_ptr(),
        vals.shape[0], nb, vals.shape[1], ss.PIECE_CHUNKS, max_pieces,
        stream), 20)
    check(torch.equal(y_k, y), "K2 kernels alone differ from the wrapper")
    bs32 = block_start.to(torch.int32)
    check(torch.equal(tables[:nb + 1], bs32) and torch.equal(
        tables[nb + 1:], ss.piece_table(bs32, ss.PIECE_CHUNKS)),
        "K2's device-built tables differ from piece_table")
    plain_ms = cuda_ms(lambda: segment_sum_chunked_plain(vals, lids, blk, nb), 3)
    keep = lids < 128
    gid = (blk.long()[:, None] * 128 + lids.long())[keep]
    flat = vals[keep]
    out = torch.zeros((nb * 128,), dtype=torch.float32, device=dev)
    lib_ms = cuda_ms(lambda: out.zero_().index_add_(0, gid, flat), 10)
    bnd, by = bound_ms(nbytes(vals, lids, blk, y), vals.numel(),
                       torch.float32)
    return {"name": "segment_sum_chunked", "launches": launches,
            "max_abs_err": err, "tolerance": tol, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms,
            "library": "index_add_ over precomputed global ids (includes a zero_)",
            "bit_equal_twice": True, "piece_chunks": ss.PIECE_CHUNKS,
            "pieces": pieces, "longest_block_run_chunks": longest,
            "piece_sweep_ms": sweep, "kernels_only_ms": kernel_ms,
            "faster_than_library": ms < lib_ms,
            "shape": {"chunks": list(vals.shape), "n_out_blocks": nb}}


def kernel_k3(u14, launches, by_variant, ptxas):
    from repro_torch.kernels import bsr_tricount as k3
    from repro_torch.kernels.bsr_tricount import (bsr_tricount,
                                                  bsr_tricount_plain)
    plan = u14.plan()
    tiles, rows, cols, nb = plan.bsr()
    tiles = torch.clamp(tiles, max=1.0)
    t_ij, t_ik, t_kj = plan.tri_triples()
    b, n_tri, dev = tiles.shape[1], int(t_ij.shape[0]), tiles.device
    check(k3.variant(b) == "sm90_wgmma", f"K3 at B = {b} takes "
          f"{k3.variant(b)}")
    runs = torch.empty((n_tri + 2,), dtype=torch.int32, device=dev)
    got = int(k3.launch("sm90_wgmma", tiles, t_ij, t_ik, t_kj, runs=runs))
    want = int(bsr_tricount_plain(tiles, t_ij, t_ik, t_kj))
    check(got == want, f"K3: kernel {got} != plain {want}")
    table = k3.run_table(t_ij, k3.max_run(b))
    check(torch.equal(runs[:table.numel()], table),
          "K3's device-built run table differs from run_table")
    check(int(bsr_tricount(tiles, t_ij, t_ik, t_kj)) == got,
          "K3: two launches differ")
    gen = torch.Generator(device=dev).manual_seed(0)
    order = torch.randperm(n_tri, generator=gen, device=dev)
    shuffled = [t[order].contiguous() for t in (t_ij, t_ik, t_kj)]
    got_shuffled = int(bsr_tricount(tiles, *shuffled))
    check(got_shuffled == want, f"K3 on shuffled triples: {got_shuffled} "
          f"!= {want}")
    ms = cuda_ms(lambda: bsr_tricount(tiles, t_ij, t_ik, t_kj), 5)
    shuffled_ms = cuda_ms(lambda: bsr_tricount(tiles, *shuffled), 2)
    got_wmma = int(k3.launch("wmma", tiles, t_ij, t_ik, t_kj))
    check(got_wmma == want, f"K3 wmma: {got_wmma} != {want}")
    wmma_ms = cuda_ms(lambda: k3.launch("wmma", tiles, t_ij, t_ik, t_kj), 3)
    check(wmma_ms >= 8 * ms, f"K3 wgmma {ms} ms is not 8x faster than "
          f"wmma {wmma_ms} ms")
    plain_ms = cuda_ms(lambda: bsr_tricount_plain(tiles, t_ij, t_ik, t_kj), 3)
    flops = 2 * b ** 3 * n_tri + b * b * n_tri
    bnd, by = bound_ms(nbytes(tiles, t_ij, t_ik, t_kj) + 8, flops,
                       torch.float16)
    # yardstick: the dense fp16 product A.A of the whole adjacency, the
    # product alone (no mask, no sum); timed only
    n = nb * b
    dense = torch.zeros((n, n), dtype=torch.float16, device=dev)
    dense.view(nb, b, nb, b)[rows.long(), :, cols.long(), :] = \
        tiles.to(torch.float16)
    lib_ms = cuda_ms(lambda: torch.mm(dense, dense), 5)
    del dense
    return {"name": "bsr_tricount", "launches": launches,
            "launches_by_variant": by_variant, "variant": k3.variant(b),
            "max_abs_err": float(abs(got - want)), "tolerance": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "tflops": flops / (ms * 1e9),
            "library_ms": lib_ms,
            "library": f"torch.mm of the dense ({n}, {n}) fp16 0/1 adjacency "
                       f"with itself: the product alone, timed only",
            "six_triangles": got, "six_triangles_shuffled": got_shuffled,
            "shuffled_ms": shuffled_ms, "runs": int(table[0]),
            "wmma": {"ms": wmma_ms, "six_triangles": got_wmma,
                     "speedup_of_wgmma": wmma_ms / ms},
            "ptxas": ptxas,
            "shape": {"tiles": list(tiles.shape), "triples": n_tri}}


def ptxas_report(source: str) -> dict:
    """Registers and spills of each kernel ptxas compiled from ``source``
    (from the build's ``-Xptxas -v`` log); fails on any spill."""
    from repro_torch.kernels import _build
    log = (_build.build_dir() / "build.log").read_text()
    text = log.split(f"== {source}\n", 1)[1].split("\n== ", 1)[0]
    out = {}
    for part in text.split("Compiling entry function '")[1:]:
        # the mangled name without its anonymous-namespace prefix
        name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d+", "",
                      part.split("'", 1)[0])
        regs = part.split("Used ", 1)[1].split(" registers", 1)[0]
        spills = part.split("bytes stack frame, ", 1)[1].split("\n", 1)[0]
        out[name] = {"registers": int(regs), "spills": spills.strip()}
        check(spills.startswith("0 bytes spill stores, 0 bytes spill loads"),
              f"{source} {name}: {spills}")
    check(bool(out), f"no ptxas report for {source}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile a 10-round \"bsr\" PageRank, one "
                         "prefill and one decode step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve
    from repro_torch.kernels import _build
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    from repro_torch.kernels.bsr_tricount import bsr_tricount
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.segment_sum import segment_sum_chunked

    # float32 products in the plain versions run in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve(None)

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.load()
    emit({"phase": "build", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc_seconds": _build.build_seconds,
          "build_dir": str(_build.build_dir().relative_to(ROOT)),
          "seconds": time.perf_counter() - t0})

    kernels = (bsr_spmv, segment_sum_chunked, bsr_tricount,
               flash_attention_fwd)
    for k in kernels:
        k.launches = 0
    g22 = phase_pagerank_scale(dev, 22)
    g14, u14, k3_variants = phase_bsr(dev, 14)
    path = {k.__name__: k.launches for k in kernels[:3]}
    check(path["bsr_spmv"] == K1_PATH_LAUNCHES, f"K1 launched "
          f"{path['bsr_spmv']} times on the path, not {K1_PATH_LAUNCHES}")
    if args.profile:
        profile_bsr(g14)
    phase_traversal(dev, g22, g14, u14)
    path["flash_attention_fwd"], k4_variants = phase_serve(dev, kernels,
                                                            args.profile)
    for name, n in path.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rows = [kernel_k1(g14, path["bsr_spmv"], ptxas_report("bsr_spmv.cu")),
            kernel_k2(g22, path["segment_sum_chunked"]),
            kernel_k3(u14, path["bsr_tricount"], k3_variants,
                      ptxas_report("bsr_tricount.cu")),
            kernel_k4(path["flash_attention_fwd"], k4_variants)]
    for r in rows:
        r.update(route="cuda", source=SOURCES[r["name"]],
                 replaces=REPLACES[r["name"]])
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
