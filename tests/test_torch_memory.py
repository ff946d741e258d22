"""The port's plan byte accounting and eviction against the reference (CPU).

Counterparts of ``tests/test_memory.py``'s plan tests (per-family counts,
transparent eviction that re-derives bit for bit, ``base`` and ``lineage``
never evictable, the ``csr`` family not charged for the graph's storage,
eviction dropping the Execs), then the counts family by family against the
reference's, which must be equal but for the named differences:

* the port dedupes by storage, so a view is charged to its base: ``base``'s
  ``in_src`` / ``out_dst`` are views of the graph's ``in_idx`` / ``out_idx``
  and ``csr``'s trimmed row pointers views of ``out_ptr`` / ``in_ptr``;
  the reference charges each JAX slice that is a copy (a full-length slice
  is the array itself there, and is not charged either);
* a patched plan's ``lineage`` holds no merged edge list of its own (they
  are ``base``'s tensors and the child graph's storage), where the
  reference keeps four host copies;
* ``execs``: the port's ``XlaExec`` holds int64 degree run lengths (16
  bytes a node); the reference's holds only the plan's edge arrays;
* ``sharded`` holds the reference's flat per-shard arrays, dtype for
  dtype, so its bytes are the reference's (compared at one shard, the
  count the reference's mesh has here).

Counts are exact integers; no tolerance applies.
"""

import functools

import numpy as np
import pytest
import torch

from _torch_oracles import build, corpus
from repro.core import engine as RE
from repro.core.graph import EdgeDelta as REdgeDelta
from repro.core.graph import Graph as RGraph
from repro.core.plan import EVICTABLE_FAMILIES as R_EVICTABLE
from repro_torch.core import engine
from repro_torch.core import plan as plan_mod
from repro_torch.core.graph import EdgeDelta, Graph
from repro_torch.core.plan import EVICTABLE_FAMILIES
from repro_torch.data.rmat import rmat_edges

torch.set_num_threads(2)

CPU = torch.device("cpu")
ENTRIES = corpus()
NAMES = [e[0] for e in ENTRIES]
BY_NAME = {e[0]: e for e in ENTRIES}


def small_graph(n=32, e=160, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    return Graph.from_edges(src, dst, device=CPU)


def _warm(p, xla_exec):
    """Touch every family of plan ``p`` (the undirected view's own plan
    stays cold) and build its "xla" Exec."""
    p.csr_out(), p.csr_in(), p.in_perm_out(), p.oriented()
    p.bsr(), p.bsr_t(), p.tri_triples(), p.undirected()
    p.chunk_layout_in(), p.chunk_layout_out(), p.sharded(1)
    xla_exec(p, "xla")


@functools.lru_cache(maxsize=None)
def _warm_pair(name):
    entry = BY_NAME[name]
    r, g = build(RGraph, entry), build(Graph, entry, device=CPU)
    _warm(r.plan(), RE.get_exec)
    _warm(g.plan(), engine.get_exec)
    return r, g


def _copy_bytes(ref_arr, graph_arr, n_elems):
    """Bytes the reference charges for a slice the port holds as a view:
    none when its slice is the graph's array itself."""
    return 0 if ref_arr is graph_arr else 4 * n_elems


# ---------------------------------------------------------------------------
# counterparts of tests/test_memory.py's plan tests
# ---------------------------------------------------------------------------


def test_plan_nbytes_per_family_and_transparent_evict():
    g = small_graph()
    p = g.plan()
    cold = p.nbytes_by_family()
    assert cold["base"] > 0
    for fam in EVICTABLE_FAMILIES:
        assert cold[fam] == 0, f"{fam} should be cold"
    before = {
        "csr": tuple(a.clone() for a in p.csr_out()),
        "perm": p.in_perm_out().clone(),
        "oriented": tuple(a.clone() for a in p.oriented()),
        "bsr": p.bsr()[0].clone(),
        "und": p.undirected().out_edges()[0].clone(),
        "chunks": tuple(a.clone() for a in p.chunk_layout_in()[:4]),
        "tri": tuple(a.clone() for a in p.tri_triples()),
        "sharded": tuple(a.clone() for a in p.sharded(1).pull[2:6]),
    }
    engine.get_exec(p, "pallas")
    warm = p.nbytes_by_family()
    for fam in EVICTABLE_FAMILIES:
        assert warm[fam] > 0, f"{fam} should be warm"
    assert p.evictable_bytes() == sum(warm[f] for f in EVICTABLE_FAMILIES)
    assert p.nbytes() == sum(warm.values()) == g.plan_nbytes()
    freed = p.evict_all()
    assert freed == sum(warm[f] for f in EVICTABLE_FAMILIES)
    assert p.evictable_bytes() == 0
    after = p.nbytes_by_family()
    for fam in EVICTABLE_FAMILIES:
        assert after[fam] == 0
    assert after["base"] == cold["base"]
    assert all(torch.equal(a, b) for a, b in zip(before["csr"], p.csr_out()))
    assert torch.equal(before["perm"], p.in_perm_out())
    assert all(torch.equal(a, b)
               for a, b in zip(before["oriented"], p.oriented()))
    assert torch.equal(before["bsr"], p.bsr()[0])
    assert torch.equal(before["und"], p.undirected().out_edges()[0])
    assert all(torch.equal(a, b)
               for a, b in zip(before["chunks"], p.chunk_layout_in()[:4]))
    assert all(torch.equal(a, b)
               for a, b in zip(before["tri"], p.tri_triples()))
    assert all(torch.equal(a, b)
               for a, b in zip(before["sharded"], p.sharded(1).pull[2:6]))


@pytest.mark.parametrize("family", ["base", "lineage", "graph", "nope"])
def test_unevictable_families_raise(family):
    p = small_graph().plan()
    with pytest.raises(ValueError):
        p.evict(family)


def test_evictable_families_are_the_reference_s_but_sharded():
    # "sharded" is ported: the tuples are equal, in the reference's order
    assert EVICTABLE_FAMILIES == R_EVICTABLE


def test_csr_family_does_not_double_count_graph_storage():
    g = small_graph()
    p = g.plan()
    p.csr_out()
    p.csr_in()
    # the trimmed pointers and the neighbour arrays are the graph's own
    # storage: only the two deg_pad vectors are charged
    assert p.nbytes_by_family()["csr"] == 2 * 4 * (g.n_nodes + 1)
    assert p.nbytes_by_family()["csr"] < g.nbytes() // 4


@pytest.mark.parametrize("family", EVICTABLE_FAMILIES)
def test_evict_of_any_family_drops_the_execs(family):
    p = small_graph().plan()
    engine.get_exec(p, "xla")
    engine.get_exec(p, "bsr")
    assert p.execs and p.nbytes_by_family()["execs"] > 0
    p.evict(family)
    assert not p.execs
    assert p.nbytes_by_family()["execs"] == 0


# ---------------------------------------------------------------------------
# against the reference, family by family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_family_bytes_match_reference_but_for_views(name):
    r, g = _warm_pair(name)
    rp, p = r.plan(), g.plan()
    got, want = p.nbytes_by_family(), rp.nbytes_by_family()
    n, e = g.n_nodes, g.n_edges
    diff = {
        "base": _copy_bytes(rp.in_src, r.in_idx, e)
        + _copy_bytes(rp.out_dst, r.out_idx, e),
        "csr": _copy_bytes(rp._csr_out[0], r.out_ptr, n + 1)
        + _copy_bytes(rp._csr_in[0], r.in_ptr, n + 1),
        "execs": -16 * n,
    }
    assert got["sharded"] > 0
    for fam, nbytes in got.items():
        assert want[fam] - nbytes == diff.get(fam, 0), fam
    assert g.nbytes() == r.nbytes()


@pytest.mark.parametrize("mixed", [False, True])
def test_patched_plan_bytes_match_reference(mixed):
    s, d = rmat_edges(7, edge_factor=4, seed=3)
    r, g = RGraph.from_edges(s, d), Graph.from_edges(s, d, device=CPU)
    rp, p = r.plan(), g.plan()
    for plan in (rp, p):
        plan.bsr(16), plan.bsr_t(16), plan.undirected()
    rng = np.random.default_rng(5)
    ids = g.node_ids[: g.n_nodes].numpy()
    es, ed = (x.numpy() for x in g.out_edges())
    inside = [(i, j) for i, j in zip(rng.integers(0, g.n_nodes, 200),
                                     rng.integers(0, g.n_nodes, 200))]
    tiles = set(zip((ed // 16).tolist(), (es // 16).tolist())) & \
        set(zip((es // 16).tolist(), (ed // 16).tolist()))
    ins = [(i, j) for i, j in inside if (j // 16, i // 16) in tiles][:6]
    assert len(ins) == 6
    parent_bytes = p.nbytes_by_family()
    cols = ([ids[i] for i, _ in ins], [ids[j] for _, j in ins],
            ids[es[:3]] if mixed else [], ids[ed[:3]] if mixed else [])
    rc, c = r.apply_delta(REdgeDelta(*cols)), g.apply_delta(EdgeDelta(*cols))
    rcp, cp = rc.plan(), c.plan()
    for plan in (rcp, cp):
        plan.bsr(16), plan.bsr_t(16)
    got, want = cp.nbytes_by_family(), rcp.nbytes_by_family()
    e = c.n_edges
    assert want["base"] - got["base"] == 8 * e        # out_dst, in_src views
    assert want["lineage"] - got["lineage"] == 16 * e  # merged lists
    assert got["lineage"] == sum(
        t.numel() * 4 for t in (c._delta.add_src, c._delta.add_dst,
                                c._delta.del_src, c._delta.del_dst,
                                c._delta.dirty))
    assert got["bsr"] == want["bsr"]
    if not mixed:   # patched: the child is charged its new tiles alone
        t, rows, _, _ = cp.bsr(16)
        assert rows is p.bsr(16)[1]
        assert got["bsr"] == t.numel() * 4 + cp.bsr_t(16)[0].numel() * 4
    assert got["undirected"] == want["undirected"] == 0
    cp.undirected()
    rcp.undirected()
    assert cp.nbytes_by_family()["undirected"] == \
        rcp.nbytes_by_family()["undirected"]
    # the parent's count does not move when the child patches from it
    assert p.nbytes_by_family() == parent_bytes


@pytest.mark.parametrize("views", [1, 3])
def test_a_view_is_counted_once(views):
    t = torch.arange(64, dtype=torch.int32)
    parts = [t[i:] for i in range(views)] + [t.view(8, 8)]
    assert plan_mod._tree_bytes((parts, {"again": t}), set()) == 64 * 4
    seen = {plan_mod._storage_key(t)}
    assert plan_mod._tree_bytes(parts, seen) == 0


def test_prune_lineage_drops_the_parent_plan():
    g = small_graph(seed=3)
    ids = g.node_ids[: g.n_nodes].numpy()
    chain = [g]
    for i in range(3):
        chain.append(chain[-1].apply_delta(
            EdgeDelta.inserts(ids[i:i + 2], ids[i + 1:i + 3])))
        chain[-1].plan()
    assert chain[-1].prune_lineage(1) == 2
    assert chain[-1].lineage_depth() == 1
    assert chain[-2]._delta is None and chain[-2].plan()._parent is None
    assert chain[-1].plan()._parent is chain[-2].plan()
