"""The port's incremental maintenance against the reference's (CPU).

The same ``EdgeDelta`` goes through the reference's ``Graph.apply_delta``
and the port's, on the corpus of ``tests/test_oracle.py``: the child's CSR
arrays, its ``_DeltaInfo`` and its patched plan must equal the reference's
element for element (the cases: insert-only, mixed, deletes of absent
pairs, duplicate inserts, the empty delta, and new node ids with negative
originals, which rebuild).  Then the counterparts of
``tests/test_engine.py``'s plan-patching tests, the patched BSR families
(shared ``rows`` / ``cols`` and triples; a new tile rebuilds), the
delta-built weight permutation against the lexsort, and lineage pruning.
Every comparison is exact: these are integer arrays and 0/1 tiles.
"""

import functools
import logging

import numpy as np
import pytest
import torch

from _torch_oracles import build, corpus
from repro.core import algorithms as RA
from repro.core.graph import EdgeDelta as REdgeDelta
from repro.core.graph import Graph as RGraph
from repro_torch.core import algorithms as A
from repro_torch.core import plan as plan_mod
from repro_torch.core.graph import EdgeDelta, Graph
from repro_torch.core.plan import GraphPlan
from repro_torch.data.rmat import rmat_edges
from repro_torch.kernels.ops import build_block_triples, edges_to_bsr

torch.set_num_threads(2)

CPU = torch.device("cpu")
CSR = ("node_ids", "out_ptr", "out_idx", "in_ptr", "in_idx")
INFO = ("add_src", "add_dst", "del_src", "del_dst", "dirty", "out_src",
        "out_dst", "in_src", "in_dst")
EAGER = ("in_src", "in_dst", "out_src", "out_dst", "out_deg", "in_deg",
         "inv_out_deg", "dangling")
ENTRIES = corpus() + [("rmat9", "edges", *rmat_edges(9, 8, seed=9), None)]
NAMES = [e[0] for e in ENTRIES]
BY_NAME = {e[0]: e for e in ENTRIES}
CASES = ["insert_only", "mixed", "absent_deletes", "duplicate_inserts",
         "empty", "new_ids"]
EMPTY = np.empty((0,), np.int32)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference graph, port graph), built once per module."""
    entry = BY_NAME[name]
    return build(RGraph, entry), build(Graph, entry, device=CPU)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _graph_eq(g, r):
    assert (g.n_nodes, g.n_edges) == (r.n_nodes, r.n_edges)
    for f in CSR:
        _eq(getattr(g, f), getattr(r, f), f)


def _ids(r):
    return np.asarray(r.node_ids)[: r.n_nodes]


def delta_args(r, case, seed=0):
    """(add_src, add_dst, del_src, del_dst) in original ids for ``case``."""
    rng = np.random.default_rng(seed)
    ids, n = _ids(r), r.n_nodes
    k = max(2, n // 6)
    if case == "empty" or n == 0:
        return EMPTY, EMPTY, EMPTY, EMPTY
    a_s, a_d = ids[rng.integers(0, n, k)], ids[rng.integers(0, n, k)]
    es, ed = (np.asarray(x) for x in r.out_edges())
    if case == "insert_only":
        return a_s, a_d, EMPTY, EMPTY
    if case == "mixed":
        pick = rng.integers(0, max(r.n_edges, 1), max(1, r.n_edges // 8))
        if r.n_edges == 0:
            return a_s, a_d, EMPTY, EMPTY
        return a_s, a_d, ids[es[pick]], ids[ed[pick]]
    if case == "absent_deletes":
        have = set(zip(es.tolist(), ed.tolist()))
        absent = [(i, j) for i in range(n) for j in range(n)
                  if (i, j) not in have][:5]
        ds = np.asarray([ids[i] for i, _ in absent] + [999_999], np.int32)
        dd = np.asarray([ids[j] for _, j in absent] + [ids[0]], np.int32)
        return a_s, a_d, ds, dd
    if case == "duplicate_inserts":
        # each insert twice, plus inserts of pairs that are already edges
        pick = rng.integers(0, max(r.n_edges, 1), 3) if r.n_edges else []
        return (np.concatenate([a_s, a_s, ids[es[pick]]]).astype(np.int32),
                np.concatenate([a_d, a_d, ids[ed[pick]]]).astype(np.int32),
                EMPTY, EMPTY)
    assert case == "new_ids"
    pick = rng.integers(0, max(r.n_edges, 1), 2) if r.n_edges else []
    return (np.concatenate([a_s, [-5, 2**31 - 7]]).astype(np.int32),
            np.concatenate([a_d, [-(2**31), ids[0]]]).astype(np.int32),
            ids[es[pick]].astype(np.int32), ids[ed[pick]].astype(np.int32))


@functools.lru_cache(maxsize=None)
def _children(name, case):
    """(reference child, port child, reference log, port log) of one case."""
    r, g = _pair(name)
    args = delta_args(r, case, seed=sum(map(ord, name)))
    rec = _Records()
    for lg in ("repro", "repro_torch"):
        logging.getLogger(lg).addHandler(rec)
    old = {lg: logging.getLogger(lg).level for lg in ("repro", "repro_torch")}
    try:
        for lg in old:
            logging.getLogger(lg).setLevel(logging.INFO)
        rc = r.apply_delta(REdgeDelta(*args))
        c = g.apply_delta(EdgeDelta(*args))
    finally:
        for lg, lvl in old.items():
            logging.getLogger(lg).setLevel(lvl)
            logging.getLogger(lg).removeHandler(rec)
    return rc, c, rec.by_root("repro."), rec.by_root("repro_torch.")


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def by_root(self, prefix):
        return [r.getMessage() for r in self.records
                if r.name.startswith(prefix)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", NAMES)
def test_apply_delta_csr_matches_reference(name, case):
    rc, c, rlog, plog = _children(name, case)
    _graph_eq(c, rc)
    assert (c._delta is None) == (rc._delta is None)
    assert c.node_capacity == rc.node_capacity
    assert c.edge_capacity == rc.edge_capacity
    # the rebuild path's logged reason is the reference's, word for word
    assert plog == rlog
    if case == "new_ids" and _pair(name)[0].n_nodes:
        assert c._delta is None and plog and \
            plog[0].startswith("apply_delta.full_rebuild")
    elif c._delta is not None:
        assert c.node_ids is _pair(name)[1].node_ids   # shared, not copied


@pytest.mark.parametrize("case", [c for c in CASES if c != "new_ids"])
@pytest.mark.parametrize("name", NAMES)
def test_delta_info_fields_match_reference(name, case):
    rc, c, _, _ = _children(name, case)
    info, rinfo = c._delta, rc._delta
    assert info is not None and rinfo is not None
    assert info.parent is _pair(name)[1]
    assert info.insert_only == rinfo.insert_only
    for f in INFO:
        _eq(getattr(info, f), getattr(rinfo, f), f)
    # the merged lists in the order the CSR arrays hold them, no copy
    e = c.n_edges
    assert info.out_dst.untyped_storage().data_ptr() == \
        c.out_idx.untyped_storage().data_ptr()
    assert info.in_src.untyped_storage().data_ptr() == \
        c.in_idx.untyped_storage().data_ptr()
    _eq(info.out_dst, c.out_idx[:e])


@pytest.mark.parametrize("case", [c for c in CASES if c != "new_ids"])
@pytest.mark.parametrize("name", NAMES)
def test_patched_plan_matches_reference_and_rederived(name, case):
    rc, c, _, _ = _children(name, case)
    p, rp = c.plan(), rc.plan()
    assert p._parent is _pair(name)[1].plan() and p._info is c._delta
    fresh = Graph.from_dense_edges(*c.out_edges(), c.n_nodes,
                                   device=CPU).plan()
    for f in EAGER:
        _eq(getattr(p, f), getattr(rp, f), f)
        _eq(getattr(p, f), getattr(fresh, f), f)
    _eq(p.dirty_vertices, rp.dirty_vertices, "dirty_vertices")
    _eq(p.in_perm_out(), rp.in_perm_out(), "in_perm_out")
    _eq(p.in_perm_out(), fresh.in_perm_out(), "in_perm_out")
    u, ru = p.undirected(), rp.undirected()
    _graph_eq(u, ru)
    assert (u._delta is None) == (ru._delta is None)
    _graph_eq(u, c.to_undirected())


# ---------------------------------------------------------------------------
# EdgeDelta itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["numpy_int64", "list", "tensor_int64"])
def test_edge_delta_stores_int32_columns(kind):
    raw = [[1, 2, 3], [4, 5, 6], [7], [8]]
    conv = {"numpy_int64": lambda x: np.asarray(x, np.int64), "list": list,
            "tensor_int64": lambda x: torch.tensor(x, dtype=torch.int64)}
    d = EdgeDelta(*(conv[kind](x) for x in raw))
    rd = REdgeDelta(*(np.asarray(x) for x in raw))
    for f in ("add_src", "add_dst", "del_src", "del_dst"):
        col = getattr(d, f)
        assert torch.is_tensor(col) and col.dtype == torch.int32
        _eq(col, getattr(rd, f), f)
    assert (d.n_adds, d.n_dels, d.insert_only) == \
        (rd.n_adds, rd.n_dels, rd.insert_only) == (3, 1, False)
    ins, dels = EdgeDelta.inserts([1], [2]), EdgeDelta.deletes([1], [2])
    assert (ins.n_adds, ins.n_dels, ins.insert_only) == (1, 0, True)
    assert (dels.n_adds, dels.n_dels, dels.insert_only) == (0, 1, False)


@pytest.mark.parametrize("cols", [([1, 2], [3], [], []), ([], [], [1], [])])
def test_edge_delta_length_mismatch_raises_as_reference(cols):
    with pytest.raises(ValueError) as mine:
        EdgeDelta(*cols)
    with pytest.raises(ValueError) as ref:
        REdgeDelta(*cols)
    assert str(mine.value) == str(ref.value)


# ---------------------------------------------------------------------------
# counterparts of tests/test_engine.py's plan-cache tests under deltas
# ---------------------------------------------------------------------------


def _rmat_graph(seed, scale=7):
    s, d = rmat_edges(scale, edge_factor=4, seed=seed)
    return Graph.from_edges(s, d, device=CPU)


def _known_id_delta(g, k=6, seed=0):
    r = np.random.default_rng(seed)
    ids = g.node_ids[: g.n_nodes].numpy()
    return EdgeDelta.inserts(ids[r.integers(0, g.n_nodes, k)],
                             ids[r.integers(0, g.n_nodes, k)])


def test_delta_child_plan_patched_without_resorting(monkeypatch):
    g = _rmat_graph(seed=83)
    p = g.plan()
    child = g.apply_delta(_known_id_delta(g))
    assert child._delta is not None

    def boom(*a, **kw):
        raise AssertionError("patched plan re-derived edge arrays")

    monkeypatch.setattr(Graph, "in_edges", boom)
    monkeypatch.setattr(Graph, "out_edges", boom)
    cp = child.plan()
    assert child.plan() is cp
    assert cp._parent is p
    assert cp.dirty_vertices is not None and len(cp.dirty_vertices) > 0
    # the eager fields are the delta's tensors themselves
    for f in ("in_src", "in_dst", "out_src", "out_dst"):
        assert getattr(cp, f) is getattr(child._delta, f)


def test_delta_leaves_parent_plan_untouched():
    g = _rmat_graph(seed=89)
    p = g.plan()
    in_src0 = p.in_src.clone()
    tiles0 = p.bsr(16)[0].clone()
    child = g.apply_delta(_known_id_delta(g))
    child.plan().bsr(16)
    assert g.plan() is p and g.n_edges == p.n_edges
    assert torch.equal(p.in_src, in_src0)
    assert torch.equal(p.bsr(16)[0], tiles0)


def test_second_update_gets_its_own_plan():
    g = _rmat_graph(seed=101)
    c1 = g.apply_delta(_known_id_delta(g, seed=2))
    p1 = c1.plan()
    c2 = c1.apply_delta(_known_id_delta(g, seed=3))
    p2 = c2.plan()
    assert p2 is not p1 and c1.plan() is p1 and p2._parent is p1
    fresh = Graph.from_dense_edges(*c2.out_edges(), c2.n_nodes, device=CPU)
    assert torch.equal(A.connected_components(c2),
                       A.connected_components(fresh))
    # the reference chains the same way to the same arrays
    s, d = rmat_edges(7, edge_factor=4, seed=101)
    r = RGraph.from_edges(s, d)
    rc2 = r.apply_delta(_ref_delta(_known_id_delta(g, seed=2))).apply_delta(
        _ref_delta(_known_id_delta(g, seed=3)))
    _graph_eq(c2, rc2)
    _eq(A.connected_components(c2), RA.connected_components(rc2))


def _ref_delta(d):
    return REdgeDelta(*(getattr(d, f).numpy() for f in (
        "add_src", "add_dst", "del_src", "del_dst")))


# ---------------------------------------------------------------------------
# patched BSR families
# ---------------------------------------------------------------------------


def _in_tile_delta(g, block, k=8, seed=0):
    """Inserts of absent pairs whose tiles the graph already holds, in
    both the pull (M[dst, src]) and the push (M[src, dst]) layouts."""
    rng = np.random.default_rng(seed)
    s, d = (t.numpy().astype(np.int64) for t in g.out_edges())
    have = set(zip(s.tolist(), d.tolist()))
    tiles = set(zip((s // block).tolist(), (d // block).tolist()))
    picks = []
    while len(picks) < k:
        i, j = (int(x) for x in rng.integers(0, g.n_nodes, 2))
        if (i // block, j // block) in tiles and (i, j) not in have:
            picks.append((i, j))
            have.add((i, j))
    ids = g.node_ids.numpy()
    return EdgeDelta.inserts([ids[i] for i, _ in picks],
                             [ids[j] for _, j in picks])


@pytest.mark.parametrize("block", [8, 16])
def test_patched_bsr_shares_structure_and_equals_cold(block):
    g = _rmat_graph(seed=7)
    p = g.plan()
    parent = {"bsr": p.bsr(block), "bsr_t": p.bsr_t(block),
              "tri": p.tri_triples(block)}
    kept = {k: v[0].clone() for k, v in parent.items() if k != "tri"}
    child = g.apply_delta(_in_tile_delta(g, block))
    cp = child.plan()
    s, d = (t.numpy() for t in child.out_edges())
    cold = {"bsr": edges_to_bsr(s, d, child.n_nodes, block=block, device=CPU),
            "bsr_t": edges_to_bsr(d, s, child.n_nodes, block=block,
                                  device=CPU)}
    for fam in ("bsr", "bsr_t"):
        tiles, rows, cols, nb = getattr(cp, fam)(block)
        ptiles, prows, pcols, pnb = parent[fam]
        assert rows is prows and cols is pcols and nb == pnb, fam
        assert tiles is not ptiles
        assert torch.equal(ptiles, kept[fam]), f"{fam}: parent tiles changed"
        for a, b in zip((tiles, rows, cols), cold[fam][:3]):
            assert torch.equal(a, b), fam
    assert cp.tri_triples(block) is parent["tri"]
    want = build_block_triples(cp.bsr(block)[1].numpy(),
                               cp.bsr(block)[2].numpy(), device=CPU)
    for a, b in zip(cp.tri_triples(block), want):
        assert torch.equal(a, b)
    # the reference patches the same tiles
    r = RGraph.from_edges(*rmat_edges(7, edge_factor=4, seed=7))
    rp = r.plan()
    rp.bsr(block), rp.bsr_t(block)
    rcp = r.apply_delta(_ref_delta(_in_tile_delta(g, block))).plan()
    for fam in ("bsr", "bsr_t"):
        for a, b in zip(getattr(cp, fam)(block)[:3],
                        getattr(rcp, fam)(block)[:3]):
            _eq(a, b, fam)


@pytest.mark.parametrize("why", ["new_tile", "deletes", "parent_cold"])
def test_bsr_rebuilds_when_patch_is_unsound(why):
    block = 8
    g = _rmat_graph(seed=11)
    p = g.plan()
    s, d = (t.numpy().astype(np.int64) for t in g.out_edges())
    ids = g.node_ids.numpy()
    if why == "new_tile":
        # a (dst, src) tile pair the parent lacks
        tiles = set(zip((d // block).tolist(), (s // block).tolist()))
        nb = -(-g.n_nodes // block)
        rb, cb = next((i, j) for i in range(nb) for j in range(nb)
                      if (i, j) not in tiles)
        delta = EdgeDelta.inserts([ids[cb * block]], [ids[rb * block]])
    elif why == "deletes":
        delta = EdgeDelta.deletes(ids[s[:2]], ids[d[:2]])
    else:
        delta = _in_tile_delta(g, block)
    if why != "parent_cold":
        p.bsr(block)
    child = g.apply_delta(delta)
    assert child._delta is not None
    tiles, rows, _, _ = child.plan().bsr(block)
    if why != "parent_cold":
        assert rows is not p.bsr(block)[1]
    cs, cd = (t.numpy() for t in child.out_edges())
    cold = edges_to_bsr(cs, cd, child.n_nodes, block=block, device=CPU)
    assert torch.equal(tiles, cold[0]) and torch.equal(rows, cold[1])


# ---------------------------------------------------------------------------
# the weight permutation from the delta, and lineage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dupes", [False, True])
def test_delta_in_perm_out_against_lexsort(dupes):
    s, d = rmat_edges(7, edge_factor=4, seed=13)
    if dupes:   # duplicate pairs make the key -> slot map ambiguous
        g = Graph.from_edges(np.concatenate([s, s[:5]]),
                             np.concatenate([d, d[:5]]), dedupe=False,
                             device=CPU)
    else:
        g = Graph.from_edges(s, d, device=CPU)
    child = g.apply_delta(_known_id_delta(g, seed=4))
    got = plan_mod._delta_in_perm_out(child._delta)
    want = GraphPlan.build(child).in_perm_out()
    if dupes:
        assert got is None
    else:
        assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(child.plan().in_perm_out(), want)


@pytest.mark.parametrize("max_depth", [1, 2, 5])
def test_lineage_depth_and_prune_match_reference(max_depth):
    g = _rmat_graph(seed=17)
    s, d = rmat_edges(7, edge_factor=4, seed=17)
    r = RGraph.from_edges(s, d)
    chain, rchain = [g], [r]
    for i in range(4):
        delta = _known_id_delta(g, seed=20 + i)
        chain.append(chain[-1].apply_delta(delta))
        rchain.append(rchain[-1].apply_delta(_ref_delta(delta)))
        chain[-1].plan(), rchain[-1].plan()
    assert [c.lineage_depth() for c in chain] == \
        [c.lineage_depth() for c in rchain] == [0, 1, 2, 3, 4]
    assert chain[-1].prune_lineage(max_depth) == \
        rchain[-1].prune_lineage(max_depth)
    assert chain[-1].lineage_depth() == rchain[-1].lineage_depth() == \
        min(max_depth, 4)
    # results are unaffected by the cut
    fresh = Graph.from_dense_edges(*chain[-1].out_edges(), chain[-1].n_nodes,
                                   device=CPU)
    assert torch.equal(A.bfs(chain[-1], 0), A.bfs(fresh, 0))
