"""The port's "sharded" backend against the reference and the oracles (CPU).

Counterpart of ``tests/test_oracle.py``'s sharded section (the device-count
sweep at d in {1, 2, 8} and the plan-cache tests).  The reference's own
"sharded" path is not the target (its d=1 sweep fails; ROADMAP Queue 3), so
the port is held to:

* its own "xla" results, bit for bit, for every engine analytic;
* the NumPy oracles: exactly for components and BFS, within 2e-5 for
  PageRank (``tests/test_oracle.py``'s tolerance);
* the reference's "xla" results: integers exactly, floats within 1e-5.

d = 1 runs in this process (no process group); d = 2 and d = 8 run in one
spawned gloo world each (``tests/_torch_worlds.py``), made once per module
by a fixture; every rank runs the whole corpus, and the parametrized cases
read its results.  The ``ShardPlan`` arrays are held array-equal to the
reference's ``_build_shard_dir``.
"""

import collections
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracles import (build, corpus, edge_list, np_bfs,
                            np_connected_components, np_pagerank)
from _torch_worlds import (SWEEP, corpus_job, run_world,
                           shard_local_pulls, sssp_weights)
from repro.core import algorithms as RA
from repro.core.graph import Graph as RGraph
from repro.core.plan import _build_shard_dir as r_build_shard_dir
from repro_torch import obs
from repro_torch.core import algorithms as A
from repro_torch.core import engine
from repro_torch.core.graph import EdgeDelta, Graph
from repro_torch.core.plan import EVICTABLE_FAMILIES
from repro_torch.data.rmat import rmat_edges

torch.set_num_threads(2)

SHARD_COUNTS = (1, 2, 8)
ENTRIES = corpus()
NAMES = [e[0] for e in ENTRIES]
BY_NAME = {e[0]: e for e in ENTRIES}
SPAWNS = collections.Counter()


def same_bits(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_bits(x, y)
                                        for x, y in zip(a, b))
    if not isinstance(a, np.ndarray):
        return type(a) is type(b) and a == b
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``world(d)``: the ranks' results of :func:`corpus_job` at ``d``
    shards, computed once per module (d = 1 in this process)."""
    cache = {}

    def get(d):
        if d not in cache:
            if d == 1:
                cache[1] = [corpus_job()]
            else:
                SPAWNS[d] += 1
                cache[d] = run_world(corpus_job, d,
                                     tmp_path_factory.mktemp(f"world{d}"))
        return cache[d]
    return get


@functools.lru_cache(maxsize=None)
def reference_sweep(name):
    """The reference's "xla" results of the sweep's five analytics."""
    r = build(RGraph, BY_NAME[name])
    out = {"cc": RA.connected_components(r),
           "pagerank": RA.pagerank(r, n_iter=8),
           "lp": RA.label_propagation(r, n_iter=6)}
    if r.n_nodes:
        out["bfs"] = RA.bfs(r, 0)
        out["sssp"] = RA.sssp(r, 0, weights=jnp.asarray(
            sssp_weights(r.n_edges)))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("d", SHARD_COUNTS)
def test_sharded_sweep_oracles_reference_and_xla(world, d, name):
    got = world(d)[0]["corpus"][name]
    sh, xl = got["sharded"], got["xla"]
    g = build(Graph, BY_NAME[name], device="cpu")
    edges = edge_list(*g.out_edges())
    n = g.n_nodes
    np.testing.assert_array_equal(sh["cc"],
                                  np_connected_components(edges, n))
    if n:
        np.testing.assert_array_equal(sh["bfs"], np_bfs(edges, n, 0))
    for key in ("pagerank", "lp") + (("sssp",) if n else ()):
        assert same_bits(sh[key], xl[key]), f"{key} d={d} differs from xla"
    np.testing.assert_allclose(sh["pagerank"],
                               np_pagerank(edges, n, n_iter=8), atol=2e-5)
    ref = reference_sweep(name)
    assert set(ref) == {k for k in SWEEP if k in sh}
    for key, want in ref.items():
        if sh[key].dtype.kind == "f":
            np.testing.assert_allclose(sh[key], want, rtol=0, atol=1e-5,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(sh[key], want, err_msg=key)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("d", SHARD_COUNTS)
def test_every_analytic_bit_identical_to_xla(world, d, name):
    got = world(d)[0]["corpus"][name]
    assert got["sharded"].keys() == got["xla"].keys()
    assert len(got["sharded"]) >= 10
    for key, want in got["xla"].items():
        assert same_bits(got["sharded"][key], want), f"{key} at d={d}"


@pytest.mark.parametrize("d", SHARD_COUNTS)
def test_every_rank_holds_the_same_results(world, d):
    ranks = world(d)
    assert [r["rank"] for r in ranks] == list(range(d))
    assert all(r["d"] == d for r in ranks)
    first = ranks[0]
    for other in ranks[1:]:
        for name in NAMES:
            for be in ("sharded", "xla"):
                a, b = first["corpus"][name][be], other["corpus"][name][be]
                assert all(same_bits(a[k], b[k]) for k in a), (name, be)
        assert other["edge_cases"] == first["edge_cases"]


@pytest.mark.parametrize("d", SHARD_COUNTS)
def test_sharded_exec_edge_cases(world, d):
    cases = world(d)[0]["edge_cases"]
    bad = [k for k, ok in cases.items()
           if not k.endswith("/type") and ok is not True]
    assert not bad, bad
    assert cases["rmat/type"] == cases["one_node/type"] == "ShardedExec"
    assert cases["zero_edge/type"] == "ShardedExec"
    assert len(cases) >= 3 * 24


def test_sharded_exec_cache_keyed_on_shard_count(world):
    info = world(2)[0]["exec_cache"]
    assert info["distinct"] and info["d"] == (1, 2)
    assert info["counts"] == [1, 2]            # one ShardPlan per count
    assert info["memoized"] and info["default_is_world"]
    assert info["pull_d1"]                     # d=1 and d=2 give equal bits


@pytest.mark.parametrize("d", SHARD_COUNTS)
def test_shard_plan_arrays_equal_reference(d):
    for entry in ENTRIES:
        g, r = build(Graph, entry, device="cpu"), build(RGraph, entry)
        sp, rp = g.plan().sharded(d), r.plan()
        ns = max(-(-g.n_nodes // d), 1)
        assert (sp.d, sp.ns) == (d, ns)
        for direction, key, other in (("pull", rp.in_dst, rp.in_src),
                                      ("push", rp.out_src, rp.out_dst)):
            want = r_build_shard_dir(np.asarray(key), np.asarray(other), d,
                                     ns, None)
            got = getattr(sp, direction)
            assert (got.es, got.halo) == (want.es, want.halo)
            for f in ("gather_idx", "seg_local", "edge_slot", "boundary"):
                a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
                assert a.dtype == b.dtype and np.array_equal(a, b), \
                    (entry[0], d, direction, f)
            assert got.bounds[0] == 0 and got.bounds[-1] == g.n_edges
        np.testing.assert_array_equal(
            sp.out_deg.numpy(), np.pad(np.asarray(rp.out_deg),
                                       (0, d * ns - g.n_nodes)))
        assert sp.halo_bytes_per_round() == d * sp.pull.halo * 4


@pytest.mark.parametrize("d", (2, 3, 8))
def test_shard_local_sums_equal_xla_slices(d):
    # the CUDA counterpart, where alignment matters, is in
    # tests/test_torch_kernels_cuda.py
    g = Graph.from_edges(*rmat_edges(10, 16, seed=1), device="cpu")
    pulls = shard_local_pulls(g, d)
    assert len(pulls) == d
    for got, want in pulls:
        assert same_bits(got.numpy(), want.numpy())


def test_sharded_plan_family_memoized_and_byte_accounted():
    g = build(Graph, BY_NAME["rmat"], device="cpu")
    plan = g.plan()
    sp = plan.sharded(1)
    assert plan.sharded(1) is sp               # identity-memoized per count
    assert plan.sharded(2) is not sp
    assert "sharded" in EVICTABLE_FAMILIES
    assert plan.nbytes_by_family()["sharded"] > 0
    baseline = A.pagerank(g, n_iter=8, backend="sharded")
    assert plan.execs
    freed = plan.evict("sharded")
    assert freed > 0
    assert plan.nbytes_by_family()["sharded"] == 0
    assert not plan.execs                      # stale Execs dropped with it
    sp2 = plan.sharded(1)
    assert sp2 is not sp                       # cold rebuild
    assert torch.equal(sp.pull.gather_idx, sp2.pull.gather_idx)
    assert torch.equal(sp.push.seg_local, sp2.push.seg_local)
    rebuilt = A.pagerank(g, n_iter=8, backend="sharded")
    assert same_bits(baseline.numpy(), rebuilt.numpy())


def test_sharded_plan_invalidated_on_apply_delta():
    g = build(Graph, BY_NAME["rmat"], device="cpu")
    plan = g.plan()
    parent_sp = plan.sharded(1)
    A.pagerank(g, n_iter=8, backend="sharded")
    ids = g.node_ids[: g.n_nodes]
    child = g.apply_delta(EdgeDelta.inserts(ids[:3], ids[3:6]))
    cp = child.plan()
    assert cp is not plan and cp._parent is plan
    assert not cp._sharded                     # the child starts cold
    child_sp = cp.sharded(1)
    assert child_sp is not parent_sp
    assert plan._sharded[1] is parent_sp       # parent cache untouched
    assert child_sp.pull.edge_slot.shape[0] == child.n_edges > g.n_edges
    for fn in (lambda h: A.pagerank(h, n_iter=8, backend="sharded"),
               lambda h: A.connected_components(h, backend="sharded")):
        want = fn(Graph.from_dense_edges(*child.out_edges(), child.n_nodes,
                                         device="cpu"))
        assert same_bits(fn(child).numpy(), want.numpy())
    assert same_bits(A.pagerank(child, n_iter=8, backend="sharded").numpy(),
                     A.pagerank(child, n_iter=8, backend="xla").numpy())


def test_fixpoint_records_sharded_halo_profile():
    g = build(Graph, BY_NAME["rmat"], device="cpu")
    halo = g.plan().sharded(1).halo_bytes_per_round()
    snap0 = obs.REGISTRY.snapshot()

    def value(snap, name, field="value"):
        return snap.get(name, {}).get(field, 0)
    A.pagerank(g, n_iter=7, backend="sharded")
    snap = obs.REGISTRY.snapshot()
    assert value(snap, "engine.profile.sharded.rounds") - \
        value(snap0, "engine.profile.sharded.rounds") == 7
    assert value(snap, "engine.profile.sharded.halo_bytes_total") - \
        value(snap0, "engine.profile.sharded.halo_bytes_total") == 7 * halo
    assert value(snap, "engine.profile.sharded.loop_ms", "count") == \
        value(snap0, "engine.profile.sharded.loop_ms", "count") + 1
    hb = snap["engine.profile.sharded.halo_bytes_per_round"]
    assert hb["sum"] - value(snap0, "engine.profile.sharded."
                             "halo_bytes_per_round", "sum") == halo
    report = obs.profile.profile_report(snap)
    for row in ("sharded.loop_ms", "sharded.halo_bytes_per_round",
                "sharded.halo_bytes_total", "sharded.rounds"):
        assert row in report, row


@pytest.mark.parametrize("d", (2, 8))
def test_one_spawn_per_world(world, d):
    assert len(world(d)) == d
    assert SPAWNS[d] == 1, f"world {d} spawned {SPAWNS[d]} times"
