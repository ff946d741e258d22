"""The port's algorithms against the reference's and the NumPy oracles (CPU).

The same edge arrays build both packages' graphs.  PageRank (``n_iter`` and
``tol``), HITS, personalized PageRank and eigenvector centrality must match
the reference on the same backend within 1e-5 and PageRank the NumPy power
iteration within 2e-5; connected components, k-cores, core numbers, SCCs,
per-node triangles, degree histograms and triangle counts must match
exactly.  The integer results of the reference do not depend on its
backend, so they are computed once per graph, on "xla", and every backend
of the port is held to them.  On the CPU the port's "pallas" and "bsr"
backends run the kernels' plain versions; the reference runs its Pallas
kernels in interpret mode.
"""

import functools

import numpy as np
import pytest
import torch

from _torch_oracles import (build, corpus, edge_list, np_connected_components,
                            np_k_core, np_pagerank, np_triangle_count)
from repro.core import algorithms as RA
from repro.core.graph import Graph as RGraph
from repro_torch.core import algorithms as A
from repro_torch.core import engine
from repro_torch.core.graph import Graph
from repro_torch.data.rmat import rmat_edges

torch.set_num_threads(2)

CPU = torch.device("cpu")
BACKENDS = ["xla", "pallas", "bsr"]
ENTRIES = corpus() + [("rmat9", "edges", *rmat_edges(9, 8, seed=9), None)]
NAMES = [e[0] for e in ENTRIES]
BY_NAME = {e[0]: e for e in ENTRIES}
# held against the reference on every backend: the power-law graphs and the
# edge cases (isolated vertices, self loops, no edges); every graph is held
# against the NumPy oracles on every backend
REF_NAMES = ["rmat", "disconnected", "self_loop", "zero_edge", "rmat9"]
CASES = [(name, be) for name in REF_NAMES for be in BACKENDS]
ORACLE_CASES = [(name, be) for name in NAMES for be in BACKENDS]


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference graph, port graph), built once per module."""
    entry = BY_NAME[name]
    return build(RGraph, entry), build(Graph, entry, device=CPU)


def _edges(g):
    return edge_list(*(t.numpy() for t in g.out_edges()))


@pytest.mark.parametrize("name,backend", CASES)
def test_pagerank_parity(name, backend):
    r, g = _pair(name)
    got = A.pagerank(g, n_iter=10, backend=backend)
    want = RA.pagerank(r, n_iter=10, backend=backend, interpret=True)
    assert got.dtype == torch.float32 and got.shape == (g.n_nodes,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    got = A.pagerank(g, tol=1e-6, backend=backend)
    want = RA.pagerank(r, tol=1e-6, backend=backend, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("name,backend", CASES)
def test_hits_parity(name, backend):
    r, g = _pair(name)
    got = A.hits(g, n_iter=20, backend=backend)
    want = RA.hits(r, n_iter=20, backend=backend, interpret=True)
    for a, b in zip(got, want):
        assert a.shape == (g.n_nodes,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("name,backend", CASES)
def test_connected_components_exact(name, backend):
    r, g = _pair(name)
    got = A.connected_components(g, backend=backend)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        RA.connected_components(r, backend=backend, interpret=True)))


@pytest.mark.parametrize("name,backend",
                         [(n, b) for n in REF_NAMES for b in ("xla", "bsr")])
def test_triangle_count_exact(name, backend):
    r, g = _pair(name)
    u, ru = (g.to_undirected(), r.to_undirected()) if g.n_edges else (g, r)
    assert A.triangle_count(u, backend=backend) == RA.triangle_count(
        ru, backend=backend, interpret=True)


@pytest.mark.parametrize("name,backend", ORACLE_CASES)
def test_algorithms_match_numpy_oracles(name, backend):
    g = build(Graph, BY_NAME[name], device=CPU)
    edges, n = _edges(g), g.n_nodes
    if n:
        np.testing.assert_allclose(A.pagerank(g, backend=backend).numpy(),
                                   np_pagerank(edges, n), atol=2e-5)
    np.testing.assert_array_equal(
        A.connected_components(g, backend=backend).numpy(),
        np_connected_components(edges, n))
    if backend != "pallas":        # triangle_count has no "pallas" path
        u = g.to_undirected() if g.n_edges else g
        assert A.triangle_count(u, backend=backend) == np_triangle_count(
            edges, n)


@pytest.mark.parametrize("backend", ["pallas", "bsr"])
def test_fallback_predicates_give_xla_results(backend):
    _, g = _pair("rmat9")
    plan = g.plan()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=g.n_nodes).astype(np.float32))
    w = torch.from_numpy(rng.random(g.n_edges).astype(np.float32))
    ones = torch.ones((g.n_nodes,), dtype=torch.int32)
    for prim in (engine.pull, engine.push):
        for args, kw in (((x, "min"), {}), ((x, "max"), {}),
                         ((ones, "sum"), {}),
                         ((x, "sum"), {"edge_values": w}),
                         ((x, "min"), {"edge_values": w, "edge_op": "add"})):
            want = prim(plan, *args, backend="xla", **kw)
            got = prim(plan, *args, backend=backend, **kw)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("backend", BACKENDS)
def test_pull_push_sum_match_numpy(backend):
    _, g = _pair("rmat")
    plan = g.plan()
    x = torch.arange(g.n_nodes, dtype=torch.float32) + 1.0
    s, d = (t.numpy() for t in g.out_edges())
    want_pull = np.zeros(g.n_nodes, np.float32)
    np.add.at(want_pull, d, x.numpy()[s])
    want_push = np.zeros(g.n_nodes, np.float32)
    np.add.at(want_push, s, x.numpy()[d])
    np.testing.assert_allclose(engine.pull(plan, x, backend=backend).numpy(),
                               want_pull, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(engine.push(plan, x, backend=backend).numpy(),
                               want_push, rtol=1e-5, atol=1e-5)


def test_empty_segments_keep_the_reference_identities():
    # a sink has no out-edges: segment_min/max of nothing is +-inf / INT32
    g = Graph.from_edges(np.asarray([0, 0], np.int32),
                         np.asarray([1, 2], np.int32), device=CPU)
    plan = g.plan()
    xf = torch.tensor([1.0, 2.0, 3.0])
    xi = torch.tensor([1, 2, 3], dtype=torch.int32)
    assert engine.push(plan, xf, "min").tolist() == [2.0, float("inf"),
                                                     float("inf")]
    assert engine.push(plan, xf, "max").tolist() == [3.0, float("-inf"),
                                                     float("-inf")]
    imax = torch.iinfo(torch.int32).max
    assert engine.push(plan, xi, "min").tolist() == [2, imax, imax]


def test_unported_backends_raise():
    _, g = _pair("rmat")
    # "frontier" is ported: PageRank has no sparse formulation and runs
    # through FrontierExec's inherited dense pull, as in the reference
    assert type(engine.get_exec(g.plan(), "frontier")) is engine.FrontierExec
    np.testing.assert_array_equal(A.pagerank(g, backend="frontier").numpy(),
                                  A.pagerank(g, backend="xla").numpy())
    # so is "sharded": at one shard (no process group) it equals "xla"
    assert type(engine.get_exec(g.plan(), "sharded")) is engine.ShardedExec
    np.testing.assert_array_equal(A.pagerank(g, backend="sharded").numpy(),
                                  A.pagerank(g, backend="xla").numpy())
    u = g.to_undirected()
    assert A.triangle_count(u, backend="sharded") == A.triangle_count(u)
    with pytest.raises(ValueError):
        A.pagerank(g, backend="tpu")
    assert engine.select_backend(g.plan()) == "xla"


def test_exec_is_memoized_and_zero_node_graph_downgrades():
    _, g = _pair("rmat")
    plan = g.plan()
    assert engine.get_exec(plan, "pallas") is engine.get_exec(plan, "pallas")
    assert type(engine.get_exec(plan, "bsr")) is engine.BsrExec
    empty = Graph.from_edges(np.zeros(0, np.int32), np.zeros(0, np.int32),
                             device=CPU)
    assert type(engine.get_exec(empty.plan(), "bsr")) is engine.XlaExec


def test_fixpoint_modes():
    _, g = _pair("rmat")
    ex = engine.get_exec(g.plan(), "xla")
    calls = []

    def halve(ex, x):
        calls.append(1)
        return torch.floor(x / 2)

    x0 = torch.full((4,), 64.0)
    assert engine.fixpoint(ex, halve, x0, n_iter=3).tolist() == [8.0] * 4
    calls.clear()
    assert engine.fixpoint(ex, halve, x0).tolist() == [0.0] * 4
    assert len(calls) == 8          # 64 -> 0 in 7 rounds, one more to see it
    calls.clear()
    engine.fixpoint(ex, halve, x0, max_iter=2)
    assert len(calls) == 2
    nan = torch.full((3,), float("nan"))
    out = engine.fixpoint(ex, lambda ex, x: x * 1.0, nan, max_iter=50)
    assert torch.isnan(out).all()   # NaN that stays NaN is converged
    calls.clear()
    engine.fixpoint(ex, halve, x0, tol=4.0)
    assert len(calls) == 6          # residuals 128, 64, 32, 16, 8, 4 <= tol


def test_hits_pagerank_on_the_zero_edge_graph():
    _, g = _pair("zero_edge")
    hub, auth = A.hits(g, n_iter=3)
    assert not hub.any() and not auth.any()
    np.testing.assert_allclose(A.pagerank(g).numpy(), np.full(8, 1 / 8),
                               atol=1e-7)



# ---------------------------------------------------------------------------
# the rest of the analytics: k-core, core numbers, SCC, PPR, eigenvector
# centrality, per-node triangles, degree measures
# ---------------------------------------------------------------------------

ALL_BACKENDS = BACKENDS + ["frontier"]
ALL_CASES = [(name, be) for name in NAMES for be in ALL_BACKENDS]


@functools.lru_cache(maxsize=None)
def _ref_int(name, what):
    """The reference's integer result for one graph, on "xla" (numpy)."""
    r, _ = _pair(name)
    if what == "k_core":
        return [np.asarray(RA.k_core(r, k, backend="xla")) for k in (0, 2, 3)]
    if what == "core_numbers":
        return np.asarray(RA.core_numbers(r, backend="xla"))
    if what == "scc":
        return np.asarray(RA.strongly_connected_components(r, backend="xla"))
    raise KeyError(what)


def _float_backend(backend):
    # the reference's "frontier" pulls are its "xla" ones: compare to those
    # instead of compiling the same fixpoint again
    return "xla" if backend == "frontier" else backend


@pytest.mark.parametrize("name,backend", ALL_CASES)
def test_k_core_and_core_numbers_exact(name, backend):
    _, g = _pair(name)
    for k, want in zip((0, 2, 3), _ref_int(name, "k_core")):
        got = A.k_core(g, k, backend=backend)
        assert got.dtype == torch.bool and got.shape == (g.n_nodes,)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"k={k}")
    got = A.core_numbers(g, backend=backend)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _ref_int(name, "core_numbers"))


@pytest.mark.parametrize("name,backend", ALL_CASES)
def test_strongly_connected_components_exact(name, backend):
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as sp_cc
    _, g = _pair(name)
    got = A.strongly_connected_components(g, backend=backend).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _ref_int(name, "scc"))
    n = g.n_nodes
    s, d = (t.numpy() for t in g.out_edges())
    _, comp = sp_cc(coo_matrix((np.ones(len(s)), (s, d)), shape=(n, n)),
                    directed=True, connection="strong")
    max_id = np.full(comp.max() + 1 if n else 0, -1)
    np.maximum.at(max_id, comp, np.arange(n))
    np.testing.assert_array_equal(got, max_id[comp])


@pytest.mark.parametrize("name,backend", ALL_CASES)
def test_eigenvector_centrality_parity(name, backend):
    r, g = _pair(name)
    got = A.eigenvector_centrality(g, n_iter=50, backend=backend)
    want = RA.eigenvector_centrality(r, n_iter=50,
                                     backend=_float_backend(backend),
                                     interpret=True)
    assert got.dtype == torch.float32 and got.shape == (g.n_nodes,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("name,backend", ALL_CASES)
def test_personalized_pagerank_parity(name, backend):
    r, g = _pair(name)
    sources = np.asarray([0, g.n_nodes - 1], np.int32)
    got = A.personalized_pagerank(g, torch.from_numpy(sources),
                                  backend=backend)
    want = RA.personalized_pagerank(r, sources,
                                    backend=_float_backend(backend),
                                    interpret=True)
    assert got.shape == (2, g.n_nodes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for i, s in enumerate(sources):   # each row is a standalone call
        np.testing.assert_array_equal(
            got[i].numpy(),
            A.personalized_pagerank(g, int(s), backend=backend).numpy())


@pytest.mark.parametrize("name", NAMES)
def test_personalized_pagerank_caps_and_tol(name):
    r, g = _pair(name)
    sources = np.asarray([0, g.n_nodes // 2, g.n_nodes - 1], np.int32)
    caps = np.asarray([1, 4, 12], np.int32)
    got = A.personalized_pagerank(g, torch.from_numpy(sources), n_iter=caps)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(RA.personalized_pagerank(r, sources,
                                                         n_iter=caps)),
        atol=1e-5)
    for i, (s, c) in enumerate(zip(sources, caps)):
        np.testing.assert_array_equal(
            got[i].numpy(),
            A.personalized_pagerank(g, int(s), n_iter=int(c)).numpy())
    init = np.full((3, g.n_nodes), 1.0 / g.n_nodes, np.float32)
    got = A.personalized_pagerank(g, torch.from_numpy(sources), tol=1e-6,
                                  init=torch.from_numpy(init))
    want = RA.personalized_pagerank(r, sources, tol=1e-6, init=init)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    got = A.personalized_pagerank(g, int(sources[1]), tol=1e-6)
    want = RA.personalized_pagerank(r, int(sources[1]), tol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_per_node_triangles_and_clustering(name):
    r, g = _pair(name)
    u, ru = (g.to_undirected(), r.to_undirected()) if g.n_edges else (g, r)
    tri = A.per_node_triangles(u, edge_chunk=64)
    assert tri.dtype == torch.int32
    np.testing.assert_array_equal(tri.numpy(),
                                  np.asarray(RA.per_node_triangles(ru)))
    assert int(tri.sum()) == 3 * A.triangle_count(u)
    np.testing.assert_allclose(A.clustering_coefficient(u).numpy(),
                               np.asarray(RA.clustering_coefficient(ru)),
                               atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_degree_measures(name):
    r, g = _pair(name)
    for direction in ("out", "in"):
        got = A.degree_histogram(g, direction)
        want = np.asarray(RA.degree_histogram(r, direction))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_allclose(A.degree_centrality(g, direction).numpy(),
                                   np.asarray(RA.degree_centrality(
                                       r, direction)), atol=1e-5)


@pytest.mark.parametrize("name,backend", ORACLE_CASES)
def test_k_core_matches_numpy_peel(name, backend):
    g = build(Graph, BY_NAME[name], device=CPU)
    edges, n = _edges(g), g.n_nodes
    for k in (1, 2, 3):
        np.testing.assert_array_equal(A.k_core(g, k, backend=backend).numpy(),
                                      np_k_core(edges, n, k))


def test_isolated_vertices_map_back_from_the_undirected_view():
    # ids 3 and 4 have no non-loop edges: absent from to_undirected()
    g = Graph.from_dense_edges(np.asarray([0, 1, 4], np.int32),
                               np.asarray([1, 2, 4], np.int32), 5, device=CPU)
    assert A.k_core(g, 1).tolist() == [True, True, True, False, False]
    assert A.k_core(g, 0).tolist() == [True] * 5
    assert A.core_numbers(g).tolist() == [1, 1, 1, 0, 0]
    assert A.label_propagation(g).tolist() == [0, 0, 0, 3, 4]
    empty = Graph.from_edges(np.zeros(0, np.int32), np.zeros(0, np.int32),
                             device=CPU)
    for fn in (A.k_core, A.core_numbers, A.strongly_connected_components,
               A.per_node_triangles, A.label_propagation,
               A.eigenvector_centrality, A.clustering_coefficient):
        out = fn(empty, 2) if fn is A.k_core else fn(empty)
        assert out.shape == (0,)
