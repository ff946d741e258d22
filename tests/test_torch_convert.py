"""The port's table <-> graph conversions against the reference's (CPU).

``to_graph`` over int and string key columns, with and without dedupe and
self loops, must build a graph whose five CSR arrays equal the reference's
exactly; ``graph_to_edge_table``, ``graph_to_node_table`` and
``table_from_map`` (tied scores included) must give the reference's tables
(``assert_tables_equal``).  The port's quickstart must reach the
reference's triangles, component count and top-5 on the CPU.
"""

import numpy as np
import pytest
import torch

from _torch_oracles import assert_tables_equal
from repro.core import algorithms as RA
from repro.core import convert as RC
from repro.core import relational as RR
from repro.core.table import Table as RTable
from repro_torch.core import algorithms as A
from repro_torch.core import convert as C
from repro_torch.core.table import FLOAT, INT, STR, Table
from repro_torch.examples import quickstart

CPU = torch.device("cpu")


def _pair(schema, data):
    return (RTable.from_columns(schema, data),
            Table.from_columns(schema, data, device=CPU))


def assert_graphs_equal(ref, port):
    assert (port.n_nodes, port.n_edges) == (ref.n_nodes, ref.n_edges)
    want = (ref.node_ids, ref.out_ptr, ref.out_idx, ref.in_ptr, ref.in_idx)
    for got, w in zip(port.to_arrays(), want):
        np.testing.assert_array_equal(got, np.asarray(w))
    assert port.device == CPU


def _edge_table(kind, seed=3, n=300):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 40, n)
    d = np.where(rng.random(n) < 0.1, s, rng.integers(0, 40, n))  # self loops
    w = rng.random(n).astype(np.float32)
    if kind == "int":
        return _pair({"a": INT, "b": INT, "w": FLOAT},
                     {"a": s * 7 - 50, "b": d * 7 - 50, "w": w})
    names = [f"user{i}" for i in range(45)]
    # the two columns meet their strings in different orders, and some
    # strings appear on one side only
    return _pair({"a": STR, "b": STR, "w": FLOAT},
                 {"a": [names[i] for i in s],
                  "b": [names[(i * 3) % 45] if i % 5 else "only_dst"
                        for i in d],
                  "w": w})


@pytest.mark.parametrize("kind", ["int", "str"])
@pytest.mark.parametrize("dedupe", [True, False])
@pytest.mark.parametrize("drop_self_loops", [False, True])
def test_to_graph(kind, dedupe, drop_self_loops):
    rt, pt = _edge_table(kind)
    ref = RC.to_graph(rt, "a", "b", dedupe=dedupe,
                      drop_self_loops=drop_self_loops)
    port = C.to_graph(pt, "a", "b", dedupe=dedupe,
                      drop_self_loops=drop_self_loops)
    assert_graphs_equal(ref, port)


def test_to_graph_rejects_mixed_key_types_and_takes_empty_tables():
    mixed = Table.from_columns({"a": INT, "b": STR}, {"a": [1], "b": ["x"]},
                               device=CPU)
    with pytest.raises(TypeError):
        C.to_graph(mixed, "a", "b")
    re_, pe = (RTable.empty({"a": INT, "b": INT}),
               Table.empty({"a": INT, "b": INT}, device=CPU))
    assert_graphs_equal(RC.to_graph(re_, "a", "b"), C.to_graph(pe, "a", "b"))


@pytest.mark.parametrize("kind", ["int", "str"])
def test_graph_to_tables(kind):
    rt, pt = _edge_table(kind)
    rg, pg = RC.to_graph(rt, "a", "b"), C.to_graph(pt, "a", "b")
    assert_tables_equal(RC.graph_to_edge_table(rg, "s", "d"),
                        C.graph_to_edge_table(pg, "s", "d"))
    rpr, ppr = RA.pagerank(rg, n_iter=5), A.pagerank(pg, n_iter=5)
    rdeg = RA.degree_centrality(rg)
    pdeg = A.degree_centrality(pg)
    rk = RA.k_core(rg, 2)
    pk = A.k_core(pg, 2)
    ref = RC.graph_to_node_table(rg, {"pr": rpr, "deg": rdeg, "core": rk},
                                 id_name="v")
    port = C.graph_to_node_table(pg, {"pr": ppr, "deg": pdeg, "core": pk},
                                 id_name="v")
    assert_tables_equal(ref, port)
    assert port.schema.fields == (("v", INT), ("pr", FLOAT), ("deg", FLOAT),
                                  ("core", INT))
    assert_tables_equal(RC.graph_to_node_table(rg), C.graph_to_node_table(pg))


def test_table_from_map_with_tied_scores():
    """Scores with ties (in-degrees, k-core flags, rounded PageRank): the
    stable descending sort keeps tied nodes in ascending id order."""
    rt, pt = _edge_table("int", seed=5)
    rg, pg = RC.to_graph(rt, "a", "b"), C.to_graph(pt, "a", "b")
    assert_tables_equal(RC.table_from_map(rg, rg.in_degrees(), "n", "deg"),
                        C.table_from_map(pg, pg.in_degrees(), "n", "deg"))
    assert_tables_equal(RC.table_from_map(rg, RA.k_core(rg, 3)),
                        C.table_from_map(pg, A.k_core(pg, 3)))
    rpr = np.round(np.asarray(RA.pagerank(rg, n_iter=10)), 3)
    ppr = torch.from_numpy(rpr.copy())
    ref = RC.table_from_map(rg, rpr, "n", "pr")
    port = C.table_from_map(pg, ppr, "n", "pr")
    assert_tables_equal(ref, port)
    assert len(set(rpr.tolist())) < len(rpr)          # there are ties


def test_quickstart_matches_the_reference():
    got = quickstart.run(device="cpu")
    rng = np.random.default_rng(0)
    t = RTable.from_columns(
        {"src": INT, "dst": INT, "weight": INT},
        {"src": rng.integers(0, 200, 2000),
         "dst": rng.integers(0, 200, 2000),
         "weight": rng.integers(1, 10, 2000)})
    strong = RR.select(t, "weight", ">=", 5)
    g = RC.to_graph(strong, "src", "dst", drop_self_loops=True)
    pr = RA.pagerank(g, n_iter=10)
    assert got["triangles"] == RA.triangle_count(g.to_undirected())
    assert got["components"] == len(set(np.asarray(
        RA.connected_components(g)).tolist()))
    ranked = RC.table_from_map(g, pr, "node", "pagerank")
    top = ranked.to_pydict()
    assert [n for n, _ in got["top5"]] == top["node"][:5]
    np.testing.assert_allclose([s for _, s in got["top5"]],
                               top["pagerank"][:5], rtol=1e-5, atol=1e-5)
    for ref, port in ((t, got["table"]), (strong, got["strong"]),
                      (ranked, got["ranked"]),
                      (RC.graph_to_edge_table(g), got["edges"])):
        assert_tables_equal(ref, port)
    assert_graphs_equal(g, got["graph"])
