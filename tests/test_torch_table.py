"""The port's tables and relational ops against the reference's (CPU).

Every test of ``tests/test_table.py`` runs here on both packages: the same
inputs build a reference ``Table`` and a port ``Table`` (``device="cpu"``),
the same op runs on each, and the two results must hold the same table
(``assert_tables_equal``: schema, sizes, dictionaries, ``row_ids`` over the
whole capacity, every column's valid prefix and dtype; integers exact,
floats within 1e-5).  The oracle checks of the original tests then run on
the port's result.  The edge cases after them go past what the reference's
tests cover: empty tables, descending order with ties, string keys missing
on one side, the band edges of ``sim_join``, int64 inputs outside int32.
"""

from collections import Counter

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # pragma: no cover - depends on environment
    from _hypothesis_fallback import given, settings, strategies as st

from _torch_oracles import assert_tables_equal
from repro.core import relational as RR
from repro.core.table import Table as RTable
from repro_torch.core import relational as R
from repro_torch.core import table as table_mod
from repro_torch.core.table import FLOAT, INT, STR, Schema, Table, next_capacity

CPU = torch.device("cpu")


class Both(tuple):
    """(reference table, port table) built from the same inputs."""

    @property
    def port(self) -> Table:
        return self[1]


def make(schema, data, **kw) -> Both:
    return Both((RTable.from_columns(schema, data, **kw),
                 Table.from_columns(schema, data, device=CPU, **kw)))


def empty(schema) -> Both:
    return Both((RTable.empty(schema), Table.empty(schema, device=CPU)))


def run(name, *args, **kw) -> Both:
    """``name`` on both packages (``Both`` arguments split per package);
    the two results must hold the same table."""
    ref = getattr(RR, name)(*(a[0] if isinstance(a, Both) else a
                              for a in args), **kw)
    port = getattr(R, name)(*(a[1] if isinstance(a, Both) else a
                              for a in args), **kw)
    assert_tables_equal(ref, port)
    return Both((ref, port))


def T0() -> Both:
    return make({"id": INT, "score": FLOAT, "tag": STR},
                {"id": [3, 1, 2, 5, 4], "score": [0.5, 0.1, 0.9, 0.3, 0.7],
                 "tag": ["java", "py", "java", "c", "py"]})


def test_schema_validation():
    with pytest.raises(ValueError):
        Schema.of([("a", INT), ("a", FLOAT)])
    with pytest.raises(ValueError):
        Schema.of([("a", "bogus")])


def test_capacity_bucketing():
    assert next_capacity(0) == 8
    assert next_capacity(8) == 8
    assert next_capacity(9) == 16
    assert next_capacity(1000) == 1024


def test_int_columns_are_int32_and_round_trip():
    """INT is int32 and full-range int32 values round-trip through the
    structural ops, on both packages."""
    assert table_mod._DTYPE_FOR[INT] == torch.int32
    vals = [2**31 - 1, -(2**31), 0, -1, 123456789]
    t = make({"x": INT}, {"x": vals})
    assert_tables_equal(*t)
    assert t.port.column("x").dtype == torch.int32
    assert t.port.column_np("x").tolist() == vals
    idx = np.arange(len(vals), dtype=np.int32)
    t2 = Both((t[0].gathered(idx, len(vals)), t.port.gathered(idx, len(vals))))
    assert_tables_equal(*t2)
    assert t2.port.column_np("x").tolist() == vals
    t3 = Both((t[0].with_column_added("y", INT, vals),
               t.port.with_column_added("y", INT, vals)))
    assert_tables_equal(*t3)
    assert t3.port.column("y").dtype == torch.int32
    assert t3.port.column_np("y").tolist() == vals


def test_select_eq_string():
    t0 = T0()
    s = run("select", t0, "tag", "==", "java")
    d = s.port.to_pydict()
    assert d["id"] == [3, 2] and d["tag"] == ["java", "java"]
    assert d["score"] == pytest.approx([0.5, 0.9])
    assert s.port.capacity == t0.port.capacity


def test_select_cmp_numeric():
    t0 = T0()
    s = run("select", t0, "score", ">=", 0.5)
    assert sorted(s.port.to_pydict()["id"]) == [2, 3, 4]
    s2 = run("select", t0, "id", "!=", 3)
    assert len(s2.port) == 4


def test_select_missing_string_matches_nothing():
    assert len(run("select", T0(), "tag", "==", "rust").port) == 0


def test_order():
    t0 = T0()
    assert run("order", t0, ["score"]).port.to_pydict()["id"] == [1, 5, 3, 4, 2]
    o2 = run("order", t0, ["tag", "score"])
    assert o2.port.to_pydict()["tag"] == ["c", "java", "java", "py", "py"]


def test_project_and_rename():
    p = run("project", T0(), ["tag", "id"])
    assert p.port.schema.names == ("tag", "id")
    r = Both((p[0].renamed({"tag": "language"}),
              p.port.renamed({"tag": "language"})))
    assert_tables_equal(*r)
    assert r.port.schema.names == ("language", "id")
    assert r.port.strings("language")[0] == "java"


def test_join_counts_and_values():
    lt = make({"q": INT, "u": INT}, {"q": [1, 2, 3, 3], "u": [10, 20, 30, 40]})
    rt = make({"q": INT, "v": INT}, {"q": [3, 3, 1], "v": [7, 8, 9]})
    j = run("join", lt, rt, "q", "q").port.to_pydict()
    got = sorted(zip(j["u"], j["v"]))
    assert got == [(10, 9), (30, 7), (30, 8), (40, 7), (40, 8)]


def test_join_string_keys_different_dicts():
    lt = make({"k": STR, "x": INT}, {"k": ["a", "b", "c"], "x": [1, 2, 3]})
    rt = make({"k": STR, "y": INT}, {"k": ["c", "a", "z"], "y": [30, 10, 99]})
    j = run("join", lt, rt, "k", "k").port.to_pydict()
    assert sorted(zip(j["x"], j["y"])) == [(1, 10), (3, 30)]


def test_group_by():
    g = run("group_by", T0(), "tag", {"total": ("score", "sum"),
                                      "n": ("id", "count"),
                                      "hi": ("score", "max")})
    d = g.port.to_pydict()
    by = dict(zip(d["tag"], zip(d["total"], d["n"], d["hi"])))
    assert by["java"][1] == 2 and abs(by["java"][0] - 1.4) < 1e-5
    assert by["c"] == (pytest.approx(0.3), 1, pytest.approx(0.3))


def test_set_ops():
    lt = make({"k": INT}, {"k": [1, 2, 3, 4]})
    rt = make({"k": INT}, {"k": [3, 4, 5]})
    assert sorted(run("intersect", lt, rt, "k").port.to_pydict()["k"]) == [3, 4]
    assert sorted(run("difference", lt, rt, "k").port.to_pydict()["k"]) == [1, 2]
    u = run("union", lt, rt)
    assert sorted(u.port.to_pydict()["k"]) == [1, 2, 3, 3, 4, 4, 5]


def test_union_string_dictionary_merge():
    lt = make({"k": STR}, {"k": ["a", "b"]})
    rt = make({"k": STR}, {"k": ["b", "z"]})
    assert run("union", lt, rt).port.strings("k") == ["a", "b", "b", "z"]


def test_sim_join_band():
    lt = make({"x": FLOAT}, {"x": [0.0, 10.0]})
    rt = make({"y": FLOAT}, {"y": [1.0, 2.5, 9.0, 50.0]})
    sj = run("sim_join", lt, rt, "x", "y", threshold=2.0).port.to_pydict()
    assert sorted(zip(sj["x"], sj["y"])) == [(0.0, 1.0), (10.0, 9.0)]


def test_next_k_successors():
    ev = make({"user": INT, "ts": INT},
              {"user": [1, 1, 1, 2, 2], "ts": [5, 1, 3, 2, 9]})
    nk = run("next_k", ev, "user", "ts", k=1).port.to_pydict()
    assert sorted(zip(nk["ts_1"], nk["ts_2"])) == [(1, 3), (2, 9), (3, 5)]


def test_row_id_tracking_through_select():
    s = run("select", T0(), "tag", "==", "py")
    assert sorted(s.port.row_ids[:len(s.port)].tolist()) == [1, 4]


# ---------------------------------------------------------------------------
# hypothesis properties, on both packages
# ---------------------------------------------------------------------------

ints = st.lists(st.integers(-50, 50), min_size=0, max_size=40)


@settings(max_examples=25, deadline=None)
@given(ints, st.integers(-50, 50))
def test_prop_select_matches_python(xs, pivot):
    s = run("select", make({"x": INT}, {"x": xs}), "x", "<", pivot)
    assert sorted(s.port.to_pydict()["x"]) == sorted([v for v in xs if v < pivot])


@settings(max_examples=25, deadline=None)
@given(ints, ints)
def test_prop_join_cardinality(lxs, rxs):
    j = run("join", make({"k": INT}, {"k": lxs}), make({"k": INT}, {"k": rxs}),
            "k", "k")
    cl, cr = Counter(lxs), Counter(rxs)
    assert len(j.port) == sum(cl[k] * cr[k] for k in cl)


@settings(max_examples=25, deadline=None)
@given(ints)
def test_prop_order_is_sorted_permutation(xs):
    o = run("order", make({"x": INT}, {"x": xs}), ["x"])
    assert o.port.to_pydict()["x"] == sorted(xs)


@settings(max_examples=25, deadline=None)
@given(ints)
def test_prop_group_count_sums_to_n(xs):
    g = run("group_by", make({"x": INT}, {"x": xs}), "x", {"n": ("x", "count")})
    assert sum(g.port.to_pydict()["n"]) == len(xs)
    assert g.port.to_pydict()["x"] == sorted(set(xs))


# ---------------------------------------------------------------------------
# edge cases past the reference's own tests
# ---------------------------------------------------------------------------

SCHEMA = {"k": INT, "v": FLOAT, "s": STR}


def _small() -> Both:
    return make(SCHEMA, {"k": [1, 2, 2, 7], "v": [0.5, 0.25, 1.0, -3.0],
                         "s": ["a", "b", "a", "c"]})


ALL_AGGS = {"n": ("v", "count"), "sv": ("v", "sum"), "sk": ("k", "sum"),
            "lo": ("v", "min"), "hi": ("k", "max"), "m": ("v", "mean"),
            "mk": ("k", "mean"), "f": ("v", "first")}


@pytest.mark.parametrize("side", ["left", "right", "both"])
@pytest.mark.parametrize("key", ["k", "s"])
def test_join_with_an_empty_table(side, key):
    e, f = empty(SCHEMA), _small()
    lt, rt = {"left": (e, f), "right": (f, e), "both": (e, e)}[side]
    assert len(run("join", lt, rt, key, key).port) == 0


@pytest.mark.parametrize("key", ["k", "v", "s"])
def test_group_by_every_aggregate(key):
    for t in (empty(SCHEMA), _small()):
        run("group_by", t, key, ALL_AGGS)
        run("unique", t, key)


@pytest.mark.parametrize("cols", [["k"], ["s", "v"], ["v", "k"]])
@pytest.mark.parametrize("ascending", [True, False])
def test_order_empty_and_ties(cols, ascending):
    run("order", empty(SCHEMA), cols, ascending=ascending)
    ties = make(SCHEMA, {"k": [2, 1, 2, 1, 2, 3], "v": [1.0, 1.0, 0.5, 1.0, 1.0, 0.5],
                         "s": ["b", "a", "b", "c", "a", "b"]})
    o = run("order", ties, cols, ascending=ascending)
    # descending is the ascending order reversed, ties included
    # (``perm[::-1]``): the row ids show which of the tied rows comes first
    up = run("order", ties, cols).port.row_ids[:6].tolist()
    assert o.port.row_ids[:6].tolist() == (up if ascending else up[::-1])


def test_next_k_and_sim_join_on_empty_tables():
    """The port gives empty tables; the reference raises on these inputs
    (an out-of-range gather on a zero-length array; ROADMAP Queue 3)."""
    e, f = empty(SCHEMA), _small()
    nk = R.next_k(e.port, "k", "v", 2)
    assert nk.n_valid == 0 and nk.row_ids.tolist() == [-1] * 8
    assert nk.schema.names == ("k_1", "v_1", "s_1", "k_2", "v_2", "s_2")
    for lt, rt in ((e, f), (f, e)):
        sj = R.sim_join(lt.port, rt.port, "v", "v", 1.0)
        assert sj.n_valid == 0 and sj.capacity == 8
    with pytest.raises(TypeError):
        RR.next_k(e[0], "k", "v", 2)
    with pytest.raises(TypeError):
        RR.sim_join(e[0], f[0], "v", "v", 1.0)


@pytest.mark.parametrize("k", [0, 1, 2, 5])
def test_next_k_successor_counts(k):
    ev = make({"user": INT, "ts": INT, "w": FLOAT},
              {"user": [1, 1, 1, 2, 2, 3, 1], "ts": [5, 1, 3, 2, 9, 4, 7],
               "w": [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7]})
    run("next_k", ev, "user", "ts", k)


@pytest.mark.parametrize("missing", ["left", "right"])
def test_join_string_keys_missing_on_one_side(missing):
    a = make({"k": STR, "x": INT}, {"k": ["a", "b", "q", "b"], "x": [1, 2, 3, 4]})
    b = make({"k": STR, "y": INT}, {"k": ["b", "z", "b", "y", "a"],
                                     "y": [10, 20, 30, 40, 50]})
    lt, rt = (a, b) if missing == "left" else (b, a)
    j = run("join", lt, rt, "k", "k")
    assert len(j.port) == 5      # a x1, b x2 x2
    for op in ("intersect", "difference"):
        run(op, lt, rt, "k")


@pytest.mark.parametrize("threshold", [0.0, 0.1, 1.5, 2.0])
def test_sim_join_band_edges(threshold):
    """Values exactly ``threshold`` apart are in the band (both edges are
    closed), in float32 arithmetic on both packages."""
    lt = make({"x": FLOAT, "i": INT}, {"x": [0.0, 0.3, 10.0, 1.5], "i": [1, 2, 3, 4]})
    rt = make({"y": FLOAT}, {"y": [2.0, -2.0, 0.2, 0.4, 8.0, 12.0, 1.5, 0.0]})
    sj = run("sim_join", lt, rt, "x", "y", threshold)
    d = sj.port.to_pydict()
    f32 = np.float32
    want = sorted((x, y) for x in lt.port.to_pydict()["x"]
                  for y in rt.port.to_pydict()["y"]
                  if f32(y) >= f32(x) - f32(threshold)
                  and f32(y) <= f32(x) + f32(threshold))
    assert sorted(zip(d["x"], d["y"])) == want


def test_int64_inputs_outside_int32_wrap_as_in_the_reference():
    vals = [2**31, -(2**31) - 1, 2**40 + 3, 7]
    for data in (vals, np.asarray(vals, dtype=np.int64)):
        t = make({"x": INT}, {"x": data})
        assert t.port.column_np("x").tolist() == \
            np.asarray(vals, np.int64).astype(np.int32).tolist()
        run("select", t, "x", ">", 0)
    # a tensor input takes the same wrap
    p = Table.from_columns({"x": INT}, {"x": torch.tensor(vals)}, device=CPU)
    assert p.column_np("x").tolist() == t.port.column_np("x").tolist()


def test_union_intersect_difference_string_columns():
    a = make(SCHEMA, {"k": [1, 2, 3], "v": [1.0, 2.0, 3.0], "s": ["x", "y", "x"]})
    b = make(SCHEMA, {"k": [3, 9], "v": [3.0, 9.0], "s": ["w", "y"]})
    run("union", a, b)
    run("union", b, a)
    run("union", empty(SCHEMA), a)
    for op in ("intersect", "difference"):
        run(op, a, b, "s")
        run(op, a, empty(SCHEMA), "k")
    run("select_inplace", a, "s", "!=", "x")


def test_nbytes_counts_every_array():
    t = _small()
    assert t.port.nbytes() == t[0].nbytes() == 4 * 8 * 4
