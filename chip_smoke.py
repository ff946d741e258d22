#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check its kernels.

Run from the root of a checkout, on a machine with a card, ``nvcc`` and
PyTorch built for CUDA:

    python3 chip_smoke.py

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
   intersection exactly, and ``connected_components`` against scipy.
4. every kernel against its plain PyTorch version at the shapes phases 2-3
   gave it, with its time, the plain version's, a library call's where one
   computes the same function, and the card's lower bound.  Printed as one
   ``{"kernels": [...]}`` line.

The launch counts of phases 2-3 are the main path's: they are zeroed just
before phase 2 and read just after phase 3.  Any failed check raises, and
the script exits non-zero without its last line, which on success is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it fails before any phase.
"""

from __future__ import annotations

import json
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
}
SOURCES = {
    "bsr_spmv": "src/repro_torch/kernels/csrc/bsr_spmv.cu",
    "segment_sum_chunked": "src/repro_torch/kernels/csrc/segment_sum.cu",
    "bsr_tricount": "src/repro_torch/kernels/csrc/bsr_tricount.cu",
}


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
    tri_bsr, t_bsr = timed(lambda: A.triangle_count(u, backend="bsr"))
    k3 = bsr_tricount.launches - before
    check(tri_bsr == tri_xla, f"triangles bsr {tri_bsr} != xla {tri_xla}")
    check(k3 == 1, f"K3 launched {k3} times for one triangle count")

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
          "components": int(len(np.unique(comp))), "seconds_cc": t_cc,
          "seconds": time.perf_counter() - t0})
    return g, u


def kernel_k1(g14, launches):
    from repro_torch.kernels.bsr_spmv import bsr_spmv, bsr_spmv_plain
    tiles, rows, cols, nb = g14.plan().bsr()
    b = tiles.shape[1]
    gen = torch.Generator(device=tiles.device).manual_seed(0)
    x = torch.rand((nb, b), generator=gen, device=tiles.device)
    y = bsr_spmv(tiles, rows, cols, x, nb)
    y_plain = bsr_spmv_plain(tiles, rows, cols, x, nb)
    err = max_abs(y, y_plain)
    tol = 1e-5 * max(1.0, float(y_plain.abs().max()))
    check(err <= tol, f"K1 f32: {err} > {tol}")
    tiles_bf = tiles.to(torch.bfloat16)
    err_bf = max_abs(bsr_spmv(tiles_bf, rows, cols, x, nb),
                     bsr_spmv_plain(tiles_bf, rows, cols, x, nb))
    tol_bf = 5e-2 * max(1.0, float(y_plain.abs().max()))
    check(err_bf <= tol_bf, f"K1 bf16: {err_bf} > {tol_bf}")
    ms = cuda_ms(lambda: bsr_spmv(tiles, rows, cols, x, nb), 20)
    plain_ms = cuda_ms(lambda: bsr_spmv_plain(tiles, rows, cols, x, nb), 5)
    lib_ms, lib_note = None, "torch.sparse_bsr_tensor @ x"
    crow = torch.searchsorted(rows, torch.arange(nb + 1, dtype=torch.int32,
                                                 device=rows.device))
    try:
        a = torch.sparse_bsr_tensor(crow.to(torch.int32), cols, tiles,
                                    size=(nb * b, nb * b))
        xv = x.reshape(-1, 1)
        lib_err = max_abs((a @ xv).reshape(nb, b), y_plain)
        lib_ms = cuda_ms(lambda: a @ xv, 20)
        lib_note += f" (max|d| vs plain {lib_err})"
    except (RuntimeError, NotImplementedError) as e:   # yardstick only
        lib_note += f" unavailable: {str(e).splitlines()[0][:160]}"
    bnd, by = bound_ms(nbytes(tiles, rows, cols, x, y),
                       2 * tiles.shape[0] * b * b, torch.float32)
    ms_bf = cuda_ms(lambda: bsr_spmv(tiles_bf, rows, cols, x, nb), 20)
    bnd_bf, _ = bound_ms(nbytes(tiles_bf, rows, cols, x, y),
                         2 * tiles.shape[0] * b * b, torch.bfloat16)
    return {"name": "bsr_spmv", "launches": launches, "max_abs_err": err,
            "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
            "library": lib_note,
            "shape": {"tiles": list(tiles.shape), "n_row_blocks": nb},
            "bf16": {"max_abs_err": err_bf, "tolerance": tol_bf, "ms": ms_bf,
                     "bound_ms": bnd_bf}}


def kernel_k2(g22, launches):
    from repro_torch.core import engine
    from repro_torch.kernels.segment_sum import (segment_sum_chunked,
                                                 segment_sum_chunked_plain)
    ex = engine.get_exec(g22.plan(), "pallas")
    lids, blk, nb = ex.p_lids, ex.p_blk, ex.nb_in
    dev = lids.device
    gen = torch.Generator(device=dev).manual_seed(0)
    ev = torch.rand((g22.n_edges,), generator=gen, device=dev)
    vals = torch.zeros(lids.shape, dtype=torch.float32, device=dev)
    vals.view(-1)[ex.p_pos] = ev
    y = segment_sum_chunked(vals, lids, blk, nb)
    y_plain = segment_sum_chunked_plain(vals, lids, blk, nb)
    err = max_abs(y, y_plain)
    tol = 1e-5 * max(1.0, float(y_plain.abs().max()))
    check(err <= tol, f"K2: {err} > {tol}")
    ms = cuda_ms(lambda: segment_sum_chunked(vals, lids, blk, nb), 10)
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
            "shape": {"chunks": list(vals.shape), "n_out_blocks": nb}}


def kernel_k3(u14, launches):
    from repro_torch.kernels.bsr_tricount import (bsr_tricount,
                                                  bsr_tricount_plain)
    plan = u14.plan()
    tiles = torch.clamp(plan.bsr()[0], max=1.0)
    t_ij, t_ik, t_kj = plan.tri_triples()
    got = int(bsr_tricount(tiles, t_ij, t_ik, t_kj))
    want = int(bsr_tricount_plain(tiles, t_ij, t_ik, t_kj))
    check(got == want, f"K3: kernel {got} != plain {want}")
    ms = cuda_ms(lambda: bsr_tricount(tiles, t_ij, t_ik, t_kj), 5)
    plain_ms = cuda_ms(lambda: bsr_tricount_plain(tiles, t_ij, t_ik, t_kj), 3)
    b, n_tri = tiles.shape[1], int(t_ij.shape[0])
    bnd, by = bound_ms(nbytes(tiles, t_ij, t_ik, t_kj) + 8,
                       2 * b ** 3 * n_tri + b * b * n_tri, torch.float16)
    return {"name": "bsr_tricount", "launches": launches,
            "max_abs_err": float(abs(got - want)), "tolerance": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None, "six_triangles": got,
            "shape": {"tiles": list(tiles.shape), "triples": n_tri}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve
    from repro_torch.kernels import _build
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    from repro_torch.kernels.bsr_tricount import bsr_tricount
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

    kernels = (bsr_spmv, segment_sum_chunked, bsr_tricount)
    for k in kernels:
        k.launches = 0
    g22 = phase_pagerank_scale(dev, 22)
    g14, u14 = phase_bsr(dev, 14)
    path = {k.__name__: k.launches for k in kernels}
    for name, n in path.items():
        check(n > 0, f"kernel {name} never launched on the main path")

    t0 = time.perf_counter()
    rows = [kernel_k1(g14, path["bsr_spmv"]),
            kernel_k2(g22, path["segment_sum_chunked"]),
            kernel_k3(u14, path["bsr_tricount"])]
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
