"""The port's provenance layer: recording, export, replay (CPU).

The thirteen tests of ``tests/test_provenance.py`` run on the port.  Then
one pipeline (select -> join -> to_graph -> pagerank -> table_from_map)
runs through both packages, which must record the same op chains with the
same canonical parameters (the reference's ``interpret=`` aside, which the
port does not have) and export the same script body once version tokens,
the header and ``device=`` are normalised; the port's script, run with
``exec`` on the CPU, must rebuild the tables bit for bit.  Tracking must
leave the results of ``pagerank``, ``connected_components`` and ``bfs``
unchanged.
"""

import re

import numpy as np
import pytest
import torch

from repro.core import algorithms as RA
from repro.core import provenance as RP
from repro.core import relational as RR
from repro.core.convert import table_from_map as r_table_from_map
from repro.core.convert import to_graph as r_to_graph
from repro.core.table import Table as RTable
from repro_torch.core import algorithms as A
from repro_torch.core import provenance as P
from repro_torch.core import relational as R
from repro_torch.core.convert import table_from_map, to_graph
from repro_torch.core.graph import EdgeDelta, Graph
from repro_torch.core.table import INT, STR, Table

CPU = torch.device("cpu")


def posts_table(n=40, seed=0, table=Table, **kw):
    rng = np.random.default_rng(seed)
    return table.from_columns(
        {"id": INT, "ref": INT, "tag": STR},
        {"id": list(range(n)),
         "ref": rng.integers(0, n, n).tolist(),
         "tag": [("java" if i % 3 else "py") for i in range(n)]}, **kw)


def port_posts(n=40, seed=0):
    return posts_table(n, seed, device=CPU)


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


def test_ops_append_records():
    t = port_posts()
    s = R.select(t, "tag", "==", "java")
    recs = P.records_of(s)
    assert [r.op for r in recs] == ["relational.select"]
    assert recs[0].inputs == (("t", P.version_of(t)),)
    assert dict(recs[0].params)["value"] == "java"
    assert recs[0].outputs == (P.version_of(s),)


def test_chains_merge_across_two_input_ops():
    t = port_posts()
    a = R.select(t, "tag", "==", "java")
    b = R.select(t, "tag", "==", "py")
    j = R.join(a, b, "ref", "id")
    ops = [r.op for r in P.records_of(j)]
    assert ops.count("relational.select") == 2
    assert ops[-1] == "relational.join"


def test_nested_tracked_calls_record_once():
    t = port_posts()
    u = R.unique(t, "tag")          # unique is implemented via group_by
    assert [r.op for r in P.records_of(u)] == ["relational.unique"]
    s = R.select_inplace(t, "tag", "==", "java")   # implemented via select
    assert [r.op for r in P.records_of(s)] == ["relational.select_inplace"]


def test_version_tokens_are_stable_and_fresh_per_object():
    g = Graph.from_edges([0, 1], [1, 2], device=CPU)
    assert g.version == g.version
    g2 = g.add_edges([2], [0])
    assert g2.version != g.version
    assert [r.op for r in P.records_of(g2)] == ["graph.add_edges"]


def test_algorithm_results_carry_provenance():
    g = Graph.from_edges([0, 1, 2], [1, 2, 0], device=CPU)
    pr = A.pagerank(g, n_iter=3)
    recs = P.records_of(pr)
    assert recs[-1].op == "algorithms.pagerank"
    assert dict(recs[-1].params)["n_iter"] == 3


def test_tuple_outputs_get_distinct_versions():
    g = Graph.from_edges([0, 1, 2], [1, 2, 0], device=CPU)
    hub, auth = A.hits(g, n_iter=3)
    rh, ra = P.records_of(hub)[-1], P.records_of(auth)[-1]
    assert rh == ra and len(rh.outputs) == 2
    assert P.version_of(hub) != P.version_of(auth)
    assert set(rh.outputs) == {P.version_of(hub), P.version_of(auth)}


# ---------------------------------------------------------------------------
# export_script -> exec -> identical results (the §4 demo feature)
# ---------------------------------------------------------------------------


def _expert_pipeline(t):
    qa = R.join(R.select(t, "tag", "==", "java"), t, "ref", "id")
    g = to_graph(qa, "id_1", "id_2")
    pr = A.pagerank(g, n_iter=10)
    return g, table_from_map(g, pr, "node", "score")


def test_export_script_round_trips_identically():
    t = port_posts()
    _, scores = _expert_pipeline(t)
    script = P.export_script(scores)
    ns = {}
    exec(compile(script, "<prov-export>", "exec"), ns)
    rebuilt = ns["rebuild"]()
    assert rebuilt.schema.names == scores.schema.names
    np.testing.assert_array_equal(rebuilt.column_np("node"),
                                  scores.column_np("node"))
    np.testing.assert_array_equal(rebuilt.column_np("score"),
                                  scores.column_np("score"))


def test_export_script_with_root_args():
    t = port_posts()
    s = R.select(t, "tag", "==", "py")
    script = P.export_script(s, embed_roots=False)
    root = P.roots_of(P.records_of(s))[0]
    assert f"def rebuild({root}):" in script
    ns = {}
    exec(compile(script, "<prov-export>", "exec"), ns)
    rebuilt = ns["rebuild"](t)
    np.testing.assert_array_equal(rebuilt.column_np("id"), s.column_np("id"))


def test_export_refuses_rootless_objects():
    with pytest.raises(P.ProvenanceError):
        P.export_script(port_posts())          # a root has no records


# ---------------------------------------------------------------------------
# replay against fresh inputs
# ---------------------------------------------------------------------------


def test_replay_against_fresh_inputs():
    t = port_posts(seed=0)
    _, scores = _expert_pipeline(t)
    recs = P.records_of(scores)
    (root,) = P.roots_of(recs)
    same = P.replay(recs, {root: t})
    np.testing.assert_array_equal(same.column_np("score"),
                                  scores.column_np("score"))
    t2 = port_posts(seed=7)
    got = P.replay(recs, {root: t2})
    _, want = _expert_pipeline(t2)
    np.testing.assert_array_equal(got.column_np("score"),
                                  want.column_np("score"))


def test_replay_missing_root_raises():
    s = R.select(port_posts(), "tag", "==", "java")
    with pytest.raises(P.ProvenanceError):
        P.replay(P.records_of(s), {})


# ---------------------------------------------------------------------------
# canonicalization corner cases
# ---------------------------------------------------------------------------


def test_canonical_small_arrays_round_trip_big_arrays_opaque():
    small = P.canonical_value(torch.tensor([1, 2, 3], dtype=torch.int32))
    assert small == ("array", "int32", (3,), (1, 2, 3))
    assert P.contains_opaque(small) is False
    back = P._uncanonical(small)
    assert back.dtype == torch.int32 and back.tolist() == [1, 2, 3]
    big = P.canonical_value(torch.zeros((100_000,), dtype=torch.float32))
    assert P.contains_opaque(big)
    assert big.desc == "array(100000,):float32"


def test_canonical_params_are_hashable_cache_keys():
    canon = P.canonical_params({"cols": ["a", "b"], "k": 3,
                                "aggs": {"n": ("id", "count")}})
    hash(canon)   # must not raise
    assert canon == P.canonical_params({"cols": ("a", "b"), "k": 3,
                                        "aggs": {"n": ("id", "count")}})


# ---------------------------------------------------------------------------
# the same pipeline through both packages
# ---------------------------------------------------------------------------


def _pipeline(t, R_, to_graph_, A_, table_from_map_):
    j = R_.join(R_.select(t, "tag", "==", "java"), t, "ref", "id")
    g = to_graph_(j, "id_1", "id_2", drop_self_loops=True)
    pr = A_.pagerank(g, n_iter=10, damping=0.9)
    return table_from_map_(g, pr, "node", "score")


def _normalised(script: str) -> str:
    """The script's body with version tokens numbered by first appearance,
    and without the header, ``device=`` and the reference's
    ``interpret=`` (a parameter the port does not have)."""
    body = script.split("\ndef ", 1)[1]
    body = re.sub(r", (device='cpu'|interpret=None)", "", body)
    names = {}
    return re.sub(r"\b[tgav]\d+x[0-9a-f]{8}\b",
                  lambda m: names.setdefault(m.group(0), f"v{len(names)}"),
                  body)


def test_pipeline_records_and_script_match_the_reference():
    rt, pt = posts_table(table=RTable), port_posts()
    ref = _pipeline(rt, RR, r_to_graph, RA, r_table_from_map)
    port = _pipeline(pt, R, to_graph, A, table_from_map)
    rrec, prec = RP.records_of(ref), P.records_of(port)
    assert [r.op for r in prec] == [r.op for r in rrec] == [
        "relational.select", "relational.join", "convert.to_graph",
        "algorithms.pagerank", "convert.table_from_map"]
    for r, p in zip(rrec, prec):
        assert [n for n, _ in p.inputs] == [n for n, _ in r.inputs]
        assert p.params == tuple(kv for kv in r.params if kv[0] != "interpret")
    for embed in (True, False):
        rs = RP.export_script(ref, embed_roots=embed)
        ps = P.export_script(port, embed_roots=embed)
        assert _normalised(ps) == _normalised(rs)
    # the port's standalone script rebuilds the same tables on the CPU
    ns = {}
    exec(compile(P.export_script(port), "<prov-export>", "exec"), ns)
    rebuilt = ns["rebuild"]()
    assert rebuilt.device == CPU
    for name in ("node", "score"):
        assert torch.equal(rebuilt.column(name), port.column(name))
    assert torch.equal(rebuilt.row_ids, port.row_ids)
    np.testing.assert_allclose(port.column_np("score"),
                               np.asarray(ref.column("score")),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,call", [
    ("pagerank", lambda f, g: f(g, n_iter=10)),
    ("connected_components", lambda f, g: f(g)),
    ("bfs", lambda f, g: f(g, 0)),
    ("bfs", lambda f, g: f(g, torch.tensor([0, 3, 5]), backend="frontier")),
])
def test_tracking_leaves_results_unchanged(name, call):
    rng = np.random.default_rng(11)
    g = Graph.from_edges(rng.integers(0, 60, 400), rng.integers(0, 60, 400),
                         device=CPU)
    fn = getattr(A, name)
    tracked, plain = call(fn, g), call(fn.__wrapped__, g)
    assert torch.equal(tracked, plain) and tracked.dtype == plain.dtype
    assert P.records_of(tracked)[-1].op == f"algorithms.{name}"
    assert P.records_of(plain) == ()


def test_pin_ring_is_bounded():
    """Objects that take neither an attribute nor a weakref are pinned in a
    ring of bounded capacity; the oldest pins are evicted first."""
    class Frozen:
        __slots__ = ()
    try:
        P.set_pin_capacity(2)
        objs = [Frozen() for _ in range(3)]
        tokens = [P.version_of(o) for o in objs]
        assert P.pin_stats() == {"pinned": 2, "capacity": 2, "bytes": 0}
        assert P.object_for_version(tokens[0]) is None
        assert P.object_for_version(tokens[2]) is objs[2]
    finally:
        P.set_pin_capacity(4096)


# ---------------------------------------------------------------------------
# EdgeDelta parameters: canonical form, export and replay of update chains
# ---------------------------------------------------------------------------


def _delta_cols(n_add=3, n_del=1):
    rng = np.random.default_rng(3)
    return (rng.integers(0, 40, n_add).astype(np.int32),
            rng.integers(0, 40, n_add).astype(np.int32),
            np.arange(n_del, dtype=np.int32), np.arange(n_del, dtype=np.int32))


@pytest.mark.parametrize("n_add,n_del", [(3, 1), (0, 0), (256, 2)])
def test_edge_delta_canonical_tuple_equals_the_reference(n_add, n_del):
    from repro.core.graph import EdgeDelta as REdgeDelta
    cols = _delta_cols(n_add, n_del)
    got = P.canonical_value(EdgeDelta(*cols))
    assert got == RP.canonical_value(REdgeDelta(*cols))
    assert got[0] == "edge_delta" and not P.contains_opaque(got)
    back = P._uncanonical(got)
    assert isinstance(back, EdgeDelta)
    for f, col in zip(("add_src", "add_dst", "del_src", "del_dst"), cols):
        assert getattr(back, f).tolist() == col.tolist()


def test_edge_delta_chain_exports_and_replays_bit_identically():
    t = port_posts()
    g = to_graph(t, "id", "ref")
    ids = g.node_ids[: g.n_nodes].numpy()
    child = g.apply_delta(EdgeDelta(ids[[0, 1, 2]], ids[[3, 4, 5]],
                                    ids[g.out_edges()[0][:1].numpy()],
                                    ids[g.out_edges()[1][:1].numpy()]))
    pr = A.pagerank(child, n_iter=10)
    recs = P.records_of(pr)
    assert [r.op for r in recs] == ["convert.to_graph", "graph.apply_delta",
                                    "algorithms.pagerank"]
    script = P.export_script(pr)
    assert "EdgeDelta(add_src=torch.tensor(" in script
    assert "from repro_torch.core.graph import EdgeDelta, Graph" in script
    ns = {}
    exec(compile(script, "<prov-export>", "exec"), ns)
    assert torch.equal(ns["rebuild"](), pr)
    (root,) = P.roots_of(recs)
    assert torch.equal(P.replay(recs, {root: t}), pr)


def test_large_edge_delta_is_opaque_without_a_host_copy(monkeypatch):
    cols = [torch.arange(300, dtype=torch.int32) for _ in range(2)]
    delta = EdgeDelta(*cols, torch.arange(4), torch.arange(4))

    def guard(name):
        real = getattr(torch.Tensor, name)

        def copy(self, *a, **kw):
            assert self.numel() <= 256, f"{name} of a large delta column"
            return real(self, *a, **kw)
        return copy

    for name in ("cpu", "numpy", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, guard(name))
    canon = P.canonical_value(EdgeDelta(*cols, [], []))
    monkeypatch.undo()
    assert canon[0] == "edge_delta" and P.contains_opaque(canon)
    assert all(isinstance(c, P.Opaque) for c in canon[1:3])
    assert canon[1].desc == "array(300,):int32"
    assert P.contains_opaque(P.canonical_value(delta))
    with pytest.raises(P.ProvenanceError):
        P._uncanonical(canon)
