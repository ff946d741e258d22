"""The port's incremental analytics against cold runs and the reference (CPU).

The port of ``tests/test_oracle.py``'s incremental oracle over
``tests/_torch_oracles.py``'s corpus: after a random insert-only or mixed
delta, ``incremental_bfs`` / ``_sssp`` / ``_connected_components`` /
``_label_propagation`` must equal the cold run on the child, which must
equal a lineage-free rebuild and the reference's cold run, bit for bit
(integer labels and levels, and distances that are sums of unit hops).  An
insert-only delta must engage BFS and SSSP; a mixed one must make every
helper decline.  A warm PageRank (``tol=1e-6`` from the parent's vector)
must lie within 1e-5 of the cold one on "xla", "pallas" and "bsr", and the
cold one within 1e-5 of the reference's; the warm-start tolerance is the
reference's live-update epilogue's.  Every case in which a helper declines
is held to the reference's: None, with the same logged reason.
"""

import functools
import logging

import numpy as np
import pytest
import torch

from _torch_oracles import build, corpus, edge_list, np_bfs
from repro.core import algorithms as RA
from repro.core.graph import EdgeDelta as REdgeDelta
from repro.core.graph import Graph as RGraph
from repro_torch.core import algorithms as A
from repro_torch.core.graph import EdgeDelta, Graph

torch.set_num_threads(2)

CPU = torch.device("cpu")
PR_TOL = 1e-5
ENTRIES = corpus()
NAMES = [e[0] for e in ENTRIES]
BY_NAME = {e[0]: e for e in ENTRIES}
OPS = ("bfs", "sssp", "cc", "lp")


@functools.lru_cache(maxsize=None)
def _pair(name):
    entry = BY_NAME[name]
    return build(RGraph, entry), build(Graph, entry, device=CPU)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _delta_for(r, seed, mixed):
    """``tests/test_oracle.py``'s random delta over the known ids, as the
    four original-id columns."""
    rng = np.random.default_rng(seed)
    ids = np.asarray(r.node_ids)[: r.n_nodes]
    k = max(2, r.n_nodes // 6)
    a_s = ids[rng.integers(0, r.n_nodes, k)].astype(np.int32)
    a_d = ids[rng.integers(0, r.n_nodes, k)].astype(np.int32)
    empty = np.empty((0,), np.int32)
    if not mixed or r.n_edges == 0:
        return a_s, a_d, empty, empty
    es, ed = (np.asarray(x) for x in r.out_edges())
    pick = rng.integers(0, r.n_edges, max(1, r.n_edges // 8))
    return (a_s, a_d, ids[es[pick]].astype(np.int32),
            ids[ed[pick]].astype(np.int32))


def _parent_results(mod, g, n_lp):
    return {"bfs": mod.bfs(g, 0), "sssp": mod.sssp(g, 0),
            "cc": mod.connected_components(g),
            "lp": mod.label_propagation(g, n_iter=n_lp)}


def _incremental(mod, child, parent, n_lp):
    return {"bfs": mod.incremental_bfs(child, 0, parent["bfs"]),
            "sssp": mod.incremental_sssp(child, 0, parent["sssp"]),
            "cc": mod.incremental_connected_components(child, parent["cc"]),
            "lp": mod.incremental_label_propagation(child, parent["lp"],
                                                    n_iter=n_lp)}


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_incremental_matches_from_scratch_and_reference(name, mixed):
    r, g = _pair(name)
    cols = _delta_for(r, seed=sum(map(ord, name)), mixed=mixed)
    delta = EdgeDelta(*cols)
    n_lp = max(g.n_nodes, 1)
    parent = _parent_results(A, g, n_lp)
    child = g.apply_delta(delta)
    assert child._delta is not None
    assert child._delta.insert_only == delta.insert_only
    fresh = Graph.from_dense_edges(*child.out_edges(), child.n_nodes,
                                   device=CPU)
    incs = _incremental(A, child, parent, n_lp)
    colds = _parent_results(A, child, n_lp)
    scratch = _parent_results(A, fresh, n_lp)

    rchild = r.apply_delta(REdgeDelta(*cols))
    rparent = _parent_results(RA, r, n_lp)
    rincs = _incremental(RA, rchild, rparent, n_lp)
    rcolds = _parent_results(RA, rchild, n_lp)

    np.testing.assert_array_equal(
        _np(colds["bfs"]), np_bfs(edge_list(*rchild.out_edges()),
                                  rchild.n_nodes, 0))
    for op in OPS:
        np.testing.assert_array_equal(_np(colds[op]), _np(scratch[op]),
                                      err_msg=f"{op}: cold != rebuild")
        np.testing.assert_array_equal(_np(colds[op]), _np(rcolds[op]),
                                      err_msg=f"{op}: cold != reference")
        assert (incs[op] is None) == (rincs[op] is None), op
        if delta.insert_only:
            if op in ("bfs", "sssp"):
                assert incs[op] is not None, f"{op} declined an insert-only"
            if incs[op] is not None:
                assert incs[op].dtype == colds[op].dtype, op
                np.testing.assert_array_equal(
                    _np(incs[op]), _np(colds[op]),
                    err_msg=f"{op}: incremental != from scratch")
                np.testing.assert_array_equal(_np(incs[op]),
                                              _np(rincs[op]))
        else:
            assert incs[op] is None, f"{op} warmed through deletions"


@pytest.mark.parametrize("backend", ["xla", "pallas", "bsr"])
@pytest.mark.parametrize("name", ["rmat", "disconnected", "star"])
def test_warm_pagerank_within_tolerance(name, backend):
    r, g = _pair(name)
    cols = _delta_for(r, seed=sum(map(ord, name)), mixed=False)
    child = g.apply_delta(EdgeDelta(*cols))
    parent_pr = A.pagerank(g, tol=1e-6, backend=backend)
    warm = A.pagerank(child, tol=1e-6, init=parent_pr, backend=backend)
    cold = A.pagerank(child, tol=1e-6, backend=backend)
    ref = RA.pagerank(r.apply_delta(REdgeDelta(*cols)), tol=1e-6)
    np.testing.assert_allclose(_np(warm), _np(cold), rtol=0, atol=PR_TOL)
    np.testing.assert_allclose(_np(cold), _np(ref), rtol=0, atol=PR_TOL)
    assert abs(float(warm.double().sum()) - 1.0) <= 1e-4


# ---------------------------------------------------------------------------
# every case in which a helper declines, against the reference
# ---------------------------------------------------------------------------


def _calls(mod, ch, n):
    """Case -> calls of ``mod``'s helpers on the child ``ch`` that must
    decline (``n`` = the child's node count)."""
    lv = np.zeros((n,), np.int32)
    dist = np.zeros((n,), np.float32)
    lab = np.arange(n, dtype=np.int32)
    return {
        "weighted": lambda: mod.incremental_sssp(
            ch, 0, dist, weights=np.ones((ch.n_edges,), np.float32)),
        "capped": lambda: mod.incremental_bfs(ch, 0, lv, n_iter=3),
        "batched": lambda: mod.incremental_sssp(ch, np.asarray([0, 1]), dist),
        "lp_capped": lambda: mod.incremental_label_propagation(ch, lab,
                                                               n_iter=1),
        "no_lineage": lambda: mod.incremental_connected_components(ch, lab),
        "deletes": lambda: mod.incremental_bfs(ch, 0, lv),
        "undirected_rebuilt": lambda: mod.incremental_connected_components(
            ch, lab),
    }


def _child_for(case, r, g):
    """(reference graph, port graph) the case's call runs on."""
    if case == "no_lineage":
        return r, g
    ids = np.asarray(r.node_ids)[: r.n_nodes]
    es, ed = (np.asarray(x) for x in r.out_edges())
    if case == "deletes":
        cols = (ids[:2], ids[1:3], ids[es[:2]], ids[ed[:2]])
    elif case == "undirected_rebuilt":
        # vertex 20 of "disconnected" has no edges: the parent's undirected
        # view lacks it, so patching the view rebuilds it
        cols = ([20], [0], [], [])
    else:
        cols = (ids[:2], ids[1:3], [], [])
    return (r.apply_delta(REdgeDelta(*cols)), g.apply_delta(EdgeDelta(*cols)))


CASES = list(_calls(A, None, 0))


@pytest.mark.parametrize("case", CASES)
def test_declines_with_the_reference_reason(case, caplog):
    name = "disconnected" if case == "undirected_rebuilt" else "rmat"
    r, g = _child_for(case, *_pair(name))
    caplog.set_level(logging.INFO, logger="repro")
    caplog.set_level(logging.INFO, logger="repro_torch")
    got = _calls(A, g, g.n_nodes)[case]()
    want = _calls(RA, r, r.n_nodes)[case]()
    assert got is None and want is None

    def reasons(prefix):
        return [rec.getMessage() for rec in caplog.records
                if rec.name.startswith(prefix)
                and rec.getMessage().startswith("incremental.")]

    assert reasons("repro_torch.") == reasons("repro.core.")
    assert reasons("repro_torch.")


def test_incremental_cc_engages_on_plain_graph():
    r, g = _pair("rmat")
    es, ed = (x.numpy() for x in g.out_edges())
    ids = g.node_ids[: g.n_nodes].numpy()
    delta = EdgeDelta.inserts(ids[es[:4]], ids[ed[2:6]])
    child = g.apply_delta(delta)
    inc = A.incremental_connected_components(child,
                                             A.connected_components(g))
    assert inc is not None
    assert child.plan().undirected()._delta is not None
    assert torch.equal(inc, A.connected_components(child))
    rchild = r.apply_delta(REdgeDelta(ids[es[:4]], ids[ed[2:6]], [], []))
    np.testing.assert_array_equal(
        inc.numpy(), np.asarray(RA.incremental_connected_components(
            rchild, RA.connected_components(r))))
