"""The port's traversals and its "frontier" backend against the reference.

BFS, SSSP, label propagation and closeness run on every backend of the
port and must equal the reference's results exactly (closeness within
1e-5); the reference's integer and distance results do not depend on its
backend, so each graph's reference result is computed once, on "xla".
The frontier-specific cases follow ``tests/test_engine.py`` and
``tests/test_oracle.py``: weights re-keyed through ``w_perm``, a star that
forces the dense switch, batched mixed caps equal to per-row runs, a graph
with no edges, the CSR families, and ``select_backend``'s whole
(backend, op, env) grid against the reference's off-TPU rule.
"""

import functools
import types

import numpy as np
import pytest
import torch

from _torch_oracles import build, corpus, edge_list, np_bfs, np_sssp
from repro.core import algorithms as RA
from repro.core import engine as RE
from repro.core.graph import Graph as RGraph
from repro_torch.core import algorithms as A
from repro_torch.core import engine
from repro_torch.core.graph import Graph
from repro_torch.data.rmat import rmat_edges

torch.set_num_threads(2)

CPU = torch.device("cpu")
BACKENDS = ["xla", "frontier", "pallas", "bsr"]
ENTRIES = corpus() + [("rmat9", "edges", *rmat_edges(9, 8, seed=9), None)]
NAMES = [e[0] for e in ENTRIES]
BY_NAME = {e[0]: e for e in ENTRIES}
CASES = [(name, be) for name in NAMES for be in BACKENDS]


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference graph, port graph), built once per module."""
    entry = BY_NAME[name]
    return build(RGraph, entry), build(Graph, entry, device=CPU)


def _weights(n_edges, seed=7):
    """Per-edge weights in [0.5, 4.0), in-edge order (the sssp convention)."""
    return np.random.default_rng(seed).uniform(0.5, 4.0, n_edges).astype(
        np.float32)


def _source(g):
    """A deterministic source: the vertex of largest out-degree."""
    return int(torch.argmax(g.plan().out_deg)) if g.n_nodes else 0


@functools.lru_cache(maxsize=None)
def _ref(name, what):
    """The reference's result for one graph, on "xla" (numpy)."""
    r, g = _pair(name)
    s = _source(g)
    if what == "bfs":
        return np.asarray(RA.bfs(r, s, backend="xla"))
    if what == "sssp_w":
        w = _weights(r.n_edges)
        return np.asarray(RA.sssp(r, s, weights=w, backend="xla"))
    if what == "lp3":
        return np.asarray(RA.label_propagation(r, n_iter=3, backend="xla"))
    if what == "lp20":
        return np.asarray(RA.label_propagation(r, backend="xla"))
    if what == "closeness":
        return np.asarray(RA.closeness_centrality(r, n_samples=6,
                                                  backend="xla"))
    raise KeyError(what)


def _edges(g):
    return edge_list(*(t.numpy() for t in g.out_edges()))


# ---------------------------------------------------------------------------
# select_backend: the (backend, op, env) grid
# ---------------------------------------------------------------------------

OPS = (None, "bfs", "sssp", "connected_components", "label_propagation",
       "pagerank", "hits", "k_core", "triangle_count")
SIZES = {"small": (1000, (1 << 15) - 1), "large": (5000, 1 << 15)}


@pytest.mark.parametrize("env", [None, "xla", "frontier", "pallas", "bsr"])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_select_backend_grid_matches_reference(monkeypatch, env, size):
    n_nodes, n_edges = SIZES[size]
    plan = types.SimpleNamespace(n_nodes=n_nodes, n_edges=n_edges)
    if env is None:
        monkeypatch.delenv("REPRO_ENGINE_BACKEND", raising=False)
    else:
        monkeypatch.setenv("REPRO_ENGINE_BACKEND", env)
    for backend in (None, "xla", "frontier", "pallas", "bsr"):
        for op in OPS:
            want = RE.select_backend(plan, backend, op=op)
            assert engine.select_backend(plan, backend, op=op) == want, \
                (backend, op, env)


@pytest.mark.parametrize("via_env", [False, True])
def test_select_backend_sharded_and_unknown_raise(monkeypatch, via_env):
    # "sharded" resolves to itself for every op, as in the reference; an
    # unknown name still raises
    plan = types.SimpleNamespace(n_nodes=10, n_edges=1 << 20)
    monkeypatch.delenv("REPRO_ENGINE_BACKEND", raising=False)
    for name in ("sharded", "tpu_magic"):
        if via_env:
            monkeypatch.setenv("REPRO_ENGINE_BACKEND", name)
            args = (None,)
        else:
            args = (name,)
        for op in (None, "bfs", "pagerank"):
            if name == "sharded":
                got = engine.select_backend(plan, *args, op=op)
                assert got == RE.select_backend(plan, *args, op=op) == name
            else:
                with pytest.raises(ValueError, match="unknown backend"):
                    engine.select_backend(plan, *args, op=op)


# ---------------------------------------------------------------------------
# the frontier's plan families and exec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_frontier_csr_families_match_reference(name):
    r, g = _pair(name)
    rp, p = r.plan(), g.plan()
    for fam in ("csr_out", "csr_in"):
        got, want = getattr(p, fam)(), getattr(rp, fam)()
        assert getattr(p, fam)() is got, f"{fam} is not memoized"
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype, fam
            np.testing.assert_array_equal(a.numpy(), b, err_msg=fam)
    perm = p.in_perm_out()
    assert p.in_perm_out() is perm and perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.asarray(rp.in_perm_out()))
    ex = engine.get_exec(p, "frontier")
    assert engine.get_exec(p, "frontier") is ex
    want_type = engine.FrontierExec if g.n_nodes else engine.XlaExec
    assert type(ex) is want_type


# ---------------------------------------------------------------------------
# BFS / SSSP / label propagation / closeness on every backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,backend", CASES)
def test_bfs_sssp_exact(name, backend):
    _, g = _pair(name)
    s = _source(g)
    got = A.bfs(g, s, backend=backend)
    assert got.dtype == torch.int32 and got.shape == (g.n_nodes,)
    np.testing.assert_array_equal(got.numpy(), _ref(name, "bfs"))
    np.testing.assert_array_equal(got.numpy(),
                                  np_bfs(_edges(g), g.n_nodes, s))
    w = _weights(g.n_edges)
    dist = A.sssp(g, s, weights=torch.from_numpy(w), backend=backend)
    assert dist.dtype == torch.float32
    np.testing.assert_array_equal(dist.numpy(), _ref(name, "sssp_w"))
    # the oracle relaxes over out-edge order: re-key the in-order weights
    w_out = w[g.plan().in_perm_out().numpy()]
    np.testing.assert_allclose(dist.numpy(),
                               np_sssp(_edges(g), g.n_nodes, s, w_out),
                               rtol=1e-6)


@pytest.mark.parametrize("name,backend", CASES)
def test_label_propagation_exact(name, backend):
    _, g = _pair(name)
    for n_iter, key in ((3, "lp3"), (20, "lp20")):
        got = A.label_propagation(g, n_iter=n_iter, backend=backend)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), _ref(name, key))


@pytest.mark.parametrize("name", NAMES)
def test_connected_components_frontier_equals_dense(name):
    _, g = _pair(name)
    np.testing.assert_array_equal(
        A.connected_components(g, backend="frontier").numpy(),
        A.connected_components(g, backend="xla").numpy())


@pytest.mark.parametrize("name,backend", CASES)
def test_closeness_centrality_parity(name, backend):
    _, g = _pair(name)
    got = A.closeness_centrality(g, n_samples=6, backend=backend)
    assert got.dtype == torch.float32 and got.shape == (g.n_nodes,)
    np.testing.assert_allclose(got.numpy(), _ref(name, "closeness"),
                               atol=1e-5)
    if backend == "frontier":   # batched frontier rows == dense rows
        np.testing.assert_array_equal(
            got.numpy(), A.closeness_centrality(g, n_samples=6).numpy())


# ---------------------------------------------------------------------------
# batched sources and per-row caps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_mixed_caps_equal_per_row_runs(backend):
    r, g = _pair("rmat9")
    sources = np.asarray([0, 4, 8, _source(g)], np.int32)
    caps = np.asarray([1, 3, 8, 10_000], np.int32)
    rows = A.bfs(g, torch.from_numpy(sources), n_iter=caps, backend=backend)
    assert rows.shape == (4, g.n_nodes)
    for i, (s, c) in enumerate(zip(sources, caps)):
        np.testing.assert_array_equal(
            rows[i].numpy(),
            A.bfs(g, int(s), n_iter=int(c), backend=backend).numpy(),
            err_msg=f"row {i}")
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(RA.bfs(r, sources, n_iter=caps,
                                        backend="xla")))
    uncapped = A.bfs(g, torch.from_numpy(sources), backend=backend)
    for i, s in enumerate(sources):
        np.testing.assert_array_equal(
            uncapped[i].numpy(), A.bfs(g, int(s), backend=backend).numpy())


@pytest.mark.parametrize("name", ["rmat9", "path", "star"])
def test_frontier_equals_dense_round_for_round(name):
    """Capped at r rounds, the frontier run equals r dense rounds."""
    _, g = _pair(name)
    s = _source(g)
    w = torch.from_numpy(_weights(g.n_edges, seed=3))
    for r in range(0, 12):
        for weights in (None, w):
            np.testing.assert_array_equal(
                A.sssp(g, s, weights, n_iter=r, backend="frontier").numpy(),
                A.sssp(g, s, weights, n_iter=r, backend="xla").numpy(),
                err_msg=f"round cap {r}")


@pytest.mark.parametrize("seed,edge_factor", [(61, 1), (67, 4), (71, 8)])
def test_frontier_bfs_sssp_match_dense_on_rmat(seed, edge_factor):
    g = Graph.from_edges(*rmat_edges(7, edge_factor, seed=seed), device=CPU)
    for src in (0, 3):
        np.testing.assert_array_equal(
            A.bfs(g, src, backend="frontier").numpy(),
            A.bfs(g, src, backend="xla").numpy())
    w = torch.from_numpy(np.random.default_rng(seed).uniform(
        0.1, 2.0, g.n_edges).astype(np.float32))
    np.testing.assert_array_equal(
        A.sssp(g, 1, weights=w, backend="frontier").numpy(),
        A.sssp(g, 1, weights=w, backend="xla").numpy())


@pytest.mark.parametrize("seed", range(8))
def test_random_graph_sssp_frontier_vs_dense(seed):
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(2, 41)), int(rng.integers(1, 121))
    g = Graph.from_dense_edges(rng.integers(0, n, m), rng.integers(0, n, m),
                               n, device=CPU)
    w = torch.from_numpy(rng.uniform(0.5, 3.0, g.n_edges).astype(np.float32))
    np.testing.assert_array_equal(
        A.sssp(g, 1 % n, weights=w, backend="frontier").numpy(),
        A.sssp(g, 1 % n, weights=w, backend="xla").numpy())


# ---------------------------------------------------------------------------
# frontier edge cases
# ---------------------------------------------------------------------------


def test_frontier_weights_rekeyed_through_w_perm():
    g = Graph.from_edges(np.asarray([0, 1, 0], np.int32),
                         np.asarray([1, 2, 2], np.int32), device=CPU)
    # in-edge order (sorted by dst, then src): (0->1), (0->2), (1->2)
    w = torch.tensor([1.0, 5.0, 1.0])
    d = A.sssp(g, 0, weights=w, backend="frontier")
    assert d.tolist() == [0.0, 1.0, 2.0]   # 0->1->2 beats the heavy 0->2
    assert engine.get_exec(g.plan(), "frontier").w_perm.tolist() == [0, 1, 2]


def _frontier_rounds():
    """The engine's frontier round counters (``repro_torch.obs``)."""
    from repro_torch import obs
    return (obs.counter("engine.frontier.rounds").value,
            obs.counter("engine.frontier.dense_rounds").value)


def test_frontier_star_forces_the_dense_switch():
    _, g = _pair("star")
    hub = _source(g)
    rounds, dense = _frontier_rounds()
    got = A.bfs(g, hub, backend="frontier")
    # round 0 relaxes all 32 hub edges (>= |E| / 4): a dense pull; round 1
    # pushes from the 32 leaves, which own no out-edge, and changes nothing
    r, d = _frontier_rounds()
    assert (r - rounds, d - dense) == (2, 1)
    np.testing.assert_array_equal(got.numpy(),
                                  A.bfs(g, hub, backend="xla").numpy())
    _, path = _pair("path")
    rounds, dense = _frontier_rounds()
    A.bfs(path, 0, backend="frontier")
    # one sparse round per hop of the 40-edge path, one more from its end
    r, d = _frontier_rounds()
    assert (r - rounds, d - dense) == (41, 0)


def test_frontier_zero_edge_returns_init():
    _, g = _pair("zero_edge")
    assert A.sssp(g, 2, backend="frontier").tolist() == \
        [float("inf")] * 2 + [0.0] + [float("inf")] * 5
    assert A.bfs(g, 2, backend="frontier").tolist() == \
        [-1, -1, 0, -1, -1, -1, -1, -1]
    init = torch.arange(8, dtype=torch.int32)
    out = engine.frontier_fixpoint(g.plan(), init, torch.ones(8, dtype=bool))
    assert out is init
    assert A.label_propagation(g, backend="frontier").tolist() == list(
        range(8))


def test_frontier_fixpoint_batched_labels_and_bounds():
    _, g = _pair("rmat9")
    u = g.to_undirected()
    plan = u.plan()
    n = u.n_nodes
    rng = np.random.default_rng(4)
    init = torch.from_numpy(rng.permutation(2 * n).astype(np.int32)
                            .reshape(2, n))
    ones = torch.ones((n,), dtype=torch.bool)
    ex = engine.get_exec(plan, "xla")

    def dense(x, rounds):
        for _ in range(rounds):
            x = torch.minimum(x, ex.pull(x, "min"))
        return x

    both = engine.frontier_fixpoint(plan, init, ones, caps=[2, 5])
    np.testing.assert_array_equal(both[0].numpy(), dense(init[0], 2).numpy())
    np.testing.assert_array_equal(both[1].numpy(), dense(init[1], 5).numpy())
    capped = engine.frontier_fixpoint(plan, init, ones, caps=3)
    np.testing.assert_array_equal(capped.numpy(),
                                  torch.stack([dense(x, 3) for x in init])
                                  .numpy())
    full = engine.frontier_fixpoint(plan, init[0], ones)
    np.testing.assert_array_equal(full.numpy(), dense(init[0], n).numpy())
