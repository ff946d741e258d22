"""The port's Graph and GraphPlan against the reference's, array for array.

The same edge arrays build a reference ``repro.core.graph.Graph`` and a port
``repro_torch.core.graph.Graph`` (on the CPU); every CSR array, eager plan
field and lazy plan family must be equal element for element, on the
corpus of ``tests/test_oracle.py`` and on R-MAT graphs up to scale 9.
"""

import functools

import numpy as np
import pytest
import torch

from _torch_oracles import build, corpus
from repro.core.graph import Graph as RGraph
from repro.core.table import next_capacity as r_next_capacity
from repro.data.rmat import rmat_edges as r_rmat_edges
from repro_torch.core.graph import INVALID_ID, Graph
from repro_torch.core.table import next_capacity
from repro_torch.data.rmat import rmat_edges

torch.set_num_threads(2)

CPU = torch.device("cpu")
CSR = ("node_ids", "out_ptr", "out_idx", "in_ptr", "in_idx")
EAGER = ("in_src", "in_dst", "out_src", "out_dst", "out_deg", "in_deg",
         "inv_out_deg", "dangling")

ENTRIES = corpus() + [("rmat9", "edges", *rmat_edges(9, 8, seed=9), None)]
NAMES = [e[0] for e in ENTRIES]
BY_NAME = {e[0]: e for e in ENTRIES}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference graph, port graph), built once per module: their plans
    memoize on them, so later tests reuse the derived arrays."""
    entry = BY_NAME[name]
    return build(RGraph, entry), build(Graph, entry, device=CPU)


def _eq(got, want, what=""):
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _graph_eq(g, r):
    assert (g.n_nodes, g.n_edges) == (r.n_nodes, r.n_edges)
    for f in CSR:
        _eq(getattr(g, f), getattr(r, f), f)


@pytest.mark.parametrize("name", NAMES)
def test_csr_arrays_equal(name):
    r, g = _pair(name)
    _graph_eq(g, r)
    assert g.node_capacity == r.node_capacity
    assert g.edge_capacity == r.edge_capacity
    for mine, ref in ((g.out_degrees(), r.out_degrees()),
                      (g.in_degrees(), r.in_degrees()),
                      *zip(g.out_edges(), r.out_edges()),
                      *zip(g.in_edges(), r.in_edges())):
        _eq(mine, ref)
    if g.n_nodes:
        assert int(g.node_ids[g.n_nodes - 1]) != INVALID_ID
        ids = np.asarray(r.node_ids[: r.n_nodes])
        _eq(g.dense_of(ids), r.dense_of(ids))
        dense = np.arange(g.n_nodes, dtype=np.int32)
        _eq(g.original_of(dense), r.original_of(dense))


@pytest.mark.parametrize("name", NAMES)
def test_plan_eager_fields_equal(name):
    r, g = _pair(name)
    rp, p = r.plan(), g.plan()
    for f in EAGER:
        _eq(getattr(p, f), getattr(rp, f), f)


@pytest.mark.parametrize("name", NAMES)
def test_plan_lazy_families_equal(name):
    r, g = _pair(name)
    rp, p = r.plan(), g.plan()
    _graph_eq(p.undirected(), rp.undirected())
    for fam in ("bsr", "bsr_t"):
        got, want = getattr(p, fam)(), getattr(rp, fam)()
        assert got[3] == want[3], fam
        for a, b in zip(got[:3], want[:3]):
            _eq(a, b, fam)
    for fam in ("chunk_layout_in", "chunk_layout_out"):
        got, want = getattr(p, fam)(), getattr(rp, fam)()
        assert got[4:] == tuple(want[4:]), fam
        for a, b in zip(got[:4], want[:4]):
            _eq(a, b, fam)
    up, rup = p.undirected().plan(), rp.undirected().plan()
    if up.n_nodes:
        for a, b in zip(up.oriented(), rup.oriented()):
            _eq(a, b, "oriented")
    for a, b in zip(up.tri_triples(), rup.tri_triples()):
        _eq(a, b, "tri_triples")


@pytest.mark.parametrize("name", NAMES)
def test_from_arrays_matches_from_edges(name):
    r, g = _pair(name)
    arrays = [np.asarray(getattr(r, f)) for f in CSR]
    h = Graph.from_arrays(arrays, r.n_nodes, r.n_edges, device=CPU)
    _graph_eq(h, r)
    for a, b in zip(h.to_arrays(), g.to_arrays()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale,edge_factor,seed", [(4, 3, 9), (6, 4, 5),
                                                    (9, 8, 9), (12, 16, 0)])
def test_rmat_edges_byte_identical(scale, edge_factor, seed):
    for a, b in zip(rmat_edges(scale, edge_factor, seed=seed),
                    r_rmat_edges(scale, edge_factor, seed=seed)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_next_capacity_matches_reference():
    for n in list(range(0, 70)) + [1000, 1 << 20, (1 << 20) + 1]:
        assert next_capacity(n) == r_next_capacity(n)
    assert next_capacity(3, minimum=1) == r_next_capacity(3, minimum=1)


def test_functional_updates_match_reference():
    r, g = _pair("rmat")
    add_s = np.asarray([1, 5, 9999], np.int32)
    add_d = np.asarray([2, 5, 3], np.int32)
    _graph_eq(g.add_edges(add_s, add_d), r.add_edges(add_s, add_d))
    s, d = (np.asarray(a) for a in r.out_edges())
    del_s = np.asarray(r.original_of(s[:7]))
    del_d = np.asarray(r.original_of(d[:7]))
    _graph_eq(g.delete_edges(del_s, del_d), r.delete_edges(del_s, del_d))


def test_plan_is_memoized_and_updates_start_cold():
    g = build(Graph, BY_NAME["rmat"], device=CPU)
    p = g.plan()
    assert g.plan() is p and p.undirected() is p.undirected()
    assert p.bsr() is p.bsr() and p.tri_triples() is p.tri_triples()
    h = g.add_edges([0], [1])
    assert h.plan() is not p and h.plan() is h.plan()


def test_from_dense_edges_keeps_given_ids_and_pads():
    g = Graph.from_dense_edges(np.asarray([0, 1], np.int32),
                               np.asarray([1, 2], np.int32), 3,
                               node_ids=np.asarray([10, 20, 30], np.int32),
                               device=CPU)
    assert g.node_ids.tolist() == [10, 20, 30] + [INVALID_ID] * 5
    assert g.out_ptr.dtype == torch.int32 and g.out_idx.shape == (8,)
