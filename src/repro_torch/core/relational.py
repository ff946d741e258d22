"""Relational operations on Ringo tables (paper §2.3, Table 4) in PyTorch.

Counterpart of ``repro/core/relational.py``: select, join, project, group
& aggregate, set operations and order, plus Ringo's two graph-construction
ops, **SimJoin** (join two records whose distance is below a threshold) and
**NextK** (join predecessor-successor records).  Every op is a composition
of stable sorts, ``searchsorted`` and segmented scans, as in the reference,
so each output equals the reference's row for row, ``row_ids`` included.

Output sizes are data-dependent: ``select``, ``join``, ``sim_join``,
``next_k`` and ``group_by`` read one count from the device each (as the
reference does) and pad their outputs to power-of-two capacities.  A
gather whose index the reference clamps or fills is clamped or masked here
before it runs, so no index leaves its array on the card.  Float sums in
``group_by`` are a segmented scan of elementwise ops over the sorted rows
(no atomics), so they give the same bits on every run.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .provenance import track
from .table import (FLOAT, INT, STR, Schema, Table, _remap_codes,
                    next_capacity)

__all__ = [
    "select",
    "select_inplace",
    "join",
    "order",
    "group_by",
    "project",
    "union",
    "intersect",
    "difference",
    "sim_join",
    "next_k",
    "unique",
]

_I32 = torch.int32

# ---------------------------------------------------------------------------
# Predicates / select
# ---------------------------------------------------------------------------

_CMPS: Dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def _predicate_mask(t: Table, col: str, op: str, value) -> torch.Tensor:
    typ = t.schema.type_of(col)
    if typ == STR:
        if op not in ("==", "!="):
            raise ValueError("string columns support ==/!= only")
        try:
            code = t.dicts[col].index(value)
        except ValueError:
            code = -1  # not present: == matches nothing, != matches all
        value = code
    arr = t.column(col)
    # the value in the column's dtype, as the reference's jnp.asarray does;
    # a 0-d host tensor is a scalar operand on any device (no copy)
    value = torch.from_numpy(np.asarray(
        value, dtype=np.float32 if arr.is_floating_point() else np.int32))
    return _CMPS[op](arr, value)


@track("relational.select", "R.select")
def select(t: Table, col: str, op: str, value) -> Table:
    """New table with rows where ``col <op> value`` (paper's Select)."""
    mask = _predicate_mask(t, col, op, value)
    return t.compacted(mask)


@track("relational.select_inplace", "R.select_inplace")
def select_inplace(t: Table, col: str, op: str, value) -> Table:
    """Paper Table 4 benchmarks "select, in place": same storage, compacted.

    Functionally identical to :func:`select`; the distinction Ringo draws
    (no new table object) maps to reusing the same capacity bucket, which
    :meth:`Table.compacted` already does.
    """
    return select(t, col, op, value)


@track("relational.project", "R.project")
def project(t: Table, cols: Sequence[str]) -> Table:
    schema = t.schema.project(cols)
    columns = {c: t.columns[c] for c in cols}
    dicts = {c: t.dicts[c] for c in cols if c in t.dicts}
    return Table(schema=schema, columns=columns, row_ids=t.row_ids,
                 n_valid=t.n_valid, dicts=dicts, next_row_id=t.next_row_id)


# ---------------------------------------------------------------------------
# Order (sort)
# ---------------------------------------------------------------------------


def _sort_key(t: Table, col: str) -> torch.Tensor:
    """Sortable key for a column; STR codes map to lexicographic ranks."""
    arr = t.column(col)
    if t.schema.type_of(col) == STR:
        uniq = t.dicts[col]
        rank_of = np.empty(len(uniq), dtype=np.int32)
        for rank, idx in enumerate(sorted(range(len(uniq)),
                                          key=lambda i: uniq[i])):
            rank_of[idx] = rank
        arr = _remap_codes(arr, rank_of) if t.n_valid > 0 else arr
    return arr


def _lexsort(keys: Sequence[torch.Tensor], n: int, device) -> torch.Tensor:
    """``jnp.lexsort(keys)``: the last key is the primary one.  Stable sorts
    from the least significant key (``keys[0]``) to the most significant."""
    perm = torch.arange(n, device=device)
    for k in keys:
        perm = perm[torch.argsort(k[perm], stable=True)]
    return perm


@track("relational.order", "R.order")
def order(t: Table, cols: Sequence[str], ascending: bool = True) -> Table:
    """Sort rows lexicographically by ``cols`` (paper's Order)."""
    keys = [_sort_key(t, c) for c in reversed(cols)]  # lexsort: last primary
    perm = _lexsort(keys, t.n_valid, t.device)
    if not ascending:
        perm = torch.flip(perm, (0,))
    return t.gathered(perm, t.n_valid)


# ---------------------------------------------------------------------------
# Join (sort-merge, contention free)
# ---------------------------------------------------------------------------


def _align_str_keys(lt: Table, lcol: str, rt: Table, rcol: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map both STR key columns into the left dictionary's code space."""
    index = {s: i for i, s in enumerate(lt.dicts[lcol])}
    remap = [index.get(s, -1) for s in rt.dicts[rcol]]
    return lt.column(lcol), _remap_codes(rt.column(rcol), remap)


def _join_keys(lt: Table, lcol: str, rt: Table, rcol: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    ltyp, rtyp = lt.schema.type_of(lcol), rt.schema.type_of(rcol)
    if (ltyp == STR) != (rtyp == STR):
        raise TypeError("cannot join string column with non-string column")
    if ltyp == STR:
        return _align_str_keys(lt, lcol, rt, rcol)
    return lt.column(lcol), rt.column(rcol)


def _search(sorted_seq: torch.Tensor, values: torch.Tensor, right: bool
            ) -> torch.Tensor:
    """int32 ``searchsorted`` (torch wants one dtype and contiguous inputs)."""
    return torch.searchsorted(sorted_seq.contiguous(),
                              values.to(sorted_seq.dtype).contiguous(),
                              right=right, out_int32=True)


def _expand_matches(lo: torch.Tensor, cnt: torch.Tensor, r_perm: torch.Tensor,
                    total: int, out_cap: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand per-left-row match ranges into (left_idx, right_idx) pairs.

    Output row j belongs to left row i = searchsorted(offsets, j, 'right')-1
    with rank k = j - offsets[i]; its right index is r_perm[lo[i] + k].
    Slots past ``total`` get (0, 0).
    """
    if total == 0:
        zeros = torch.zeros((out_cap,), dtype=_I32, device=lo.device)
        return zeros, zeros.clone()
    offsets = torch.cumsum(cnt, 0, dtype=torch.int64).to(_I32)
    starts = offsets - cnt
    j = torch.arange(out_cap, dtype=_I32, device=lo.device)
    li = torch.clamp(_search(offsets, j, right=True), max=lo.shape[0] - 1)
    k = j - starts[li.long()]
    pos = torch.clamp(lo[li.long()] + k, 0, r_perm.shape[0] - 1)
    ri = r_perm[pos.long()]
    valid = j < total
    return torch.where(valid, li, 0), torch.where(valid, ri, 0)


@track("relational.join", "R.join")
def join(lt: Table, rt: Table, lcol: str, rcol: str,
         suffixes: Tuple[str, str] = ("_1", "_2")) -> Table:
    """Equi-join (paper's Join): sort-merge, parallel and contention-free.

    Column names colliding between the two inputs get ``suffixes``.
    Output row-ids are fresh (it is a new table, per the paper: "Ringo join
    operation always produces a new table object").
    """
    lk, rk = _join_keys(lt, lcol, rt, rcol)
    if lt.n_valid == 0 or rt.n_valid == 0:
        total, out_cap = 0, next_capacity(0)
        li = ri = torch.zeros((out_cap,), dtype=_I32, device=lt.device)
    else:
        r_perm = torch.argsort(rk, stable=True).to(_I32)
        rk_sorted = rk[r_perm.long()]
        lo = _search(rk_sorted, lk, right=False)
        cnt = _search(rk_sorted, lk, right=True) - lo
        total = int(cnt.sum())
        out_cap = next_capacity(total)
        li, ri = _expand_matches(lo, cnt, r_perm, total, out_cap)

    fields: List[Tuple[str, str]] = []
    columns: Dict[str, torch.Tensor] = {}
    dicts: Dict[str, List[str]] = {}

    def _emit(src: Table, idx: torch.Tensor, suffix: str, other: Table):
        for name, typ in src.schema.fields:
            out_name = name + suffix if name in other.schema else name
            fields.append((out_name, typ))
            # match indices only ever point into the valid prefix
            columns[out_name] = src.columns[name][idx.long()]
            if typ == STR:
                dicts[out_name] = list(src.dicts[name])

    _emit(lt, li, suffixes[0], rt)
    _emit(rt, ri, suffixes[1], lt)
    return Table(schema=Schema(tuple(fields)), columns=columns,
                 row_ids=_fresh_row_ids(total, out_cap, lt.device),
                 n_valid=total, dicts=dicts, next_row_id=total)


def _fresh_row_ids(n: int, cap: int, device) -> torch.Tensor:
    ids = torch.arange(cap, dtype=_I32, device=device)
    return torch.where(ids < n, ids, -1)


# ---------------------------------------------------------------------------
# Group & aggregate
# ---------------------------------------------------------------------------

_AGGS = ("sum", "min", "max", "count", "mean", "first")


def _segment_sums(v: torch.Tensor, rank: torch.Tensor, last: torch.Tensor,
                  cap: int) -> torch.Tensor:
    """Per-segment sums of ``v`` (sorted so each segment is contiguous):
    ``cap`` slots, zero past the segments ``last`` ends.

    A Hillis–Steele inclusive scan restricted to each segment (``rank`` is
    each row's position in its segment), then each segment's last row.
    Elementwise ops only, in a fixed order: the same bits on every run.
    """
    n = int(v.shape[0])
    x = v
    d = 1
    while d < n:
        shifted = torch.cat([torch.zeros((d,), dtype=x.dtype,
                                         device=x.device), x[:-d]])
        x = x + torch.where(rank >= d, shifted, torch.zeros_like(shifted))
        d *= 2
    out = torch.zeros((cap,), dtype=v.dtype, device=v.device)
    out[: last.shape[0]] = x[last]
    return out


@track("relational.group_by", "R.group_by")
def group_by(t: Table, key: str, aggs: Dict[str, Tuple[str, str]]) -> Table:
    """Group rows by ``key``; ``aggs`` maps out_col -> (in_col, agg).

    agg ∈ {sum, min, max, count, mean, first}.  Sort-based: a stable sort
    of the key turns every group into a contiguous run, so grouping is
    segmented scans (no concurrent hash table).  The group count is read
    from the device once.
    """
    n = t.n_valid
    dev = t.device
    k = t.column(key)
    perm = torch.argsort(k, stable=True)
    ks = k[perm]
    is_start = torch.ones((n,), dtype=torch.bool, device=dev)
    is_start[1:] = ks[1:] != ks[:-1]
    seg_id = torch.cumsum(is_start, 0) - 1                   # int64
    n_groups = int(seg_id[-1]) + 1 if n > 0 else 0
    cap = next_capacity(max(n_groups, 1))

    # starts of the segments, then cap - n_groups zeros (nonzero(size=,
    # fill_value=0) in the reference)
    starts = torch.nonzero_static(is_start, size=cap, fill_value=0)[:, 0]
    first = starts[:n_groups]
    ends = torch.cat([first[1:], torch.full((min(n_groups, 1),), n,
                                            dtype=first.dtype, device=dev)])
    counts = (ends - first).to(_I32)
    rank = torch.arange(n, device=dev) - first[seg_id]
    last = ends - 1

    out_cols: Dict[str, torch.Tensor] = {}
    fields: List[Tuple[str, str]] = [(key, t.schema.type_of(key))]
    out_cols[key] = ks[starts] if n > 0 else torch.zeros((cap,),
                                                         dtype=k.dtype,
                                                         device=dev)
    for out_name, (in_col, agg) in aggs.items():
        if agg not in _AGGS:
            raise ValueError(f"unknown aggregate {agg}")
        typ = t.schema.type_of(in_col)
        v = t.column(in_col)[perm]
        if agg == "count":
            vals = torch.zeros((cap,), dtype=_I32, device=dev)
            vals[:n_groups] = counts
            fields.append((out_name, INT))
        elif agg == "sum":
            vals = _segment_sums(v, rank, last, cap)
            fields.append((out_name, typ))
        elif agg in ("min", "max"):
            vals = torch.zeros((cap,), dtype=v.dtype, device=dev).scatter_reduce(
                0, seg_id, v, reduce="a" + agg, include_self=False)
            fields.append((out_name, typ))
        elif agg == "mean":
            s = _segment_sums(v.to(torch.float32), rank, last, cap)
            c = torch.zeros((cap,), dtype=torch.float32, device=dev)
            c[:n_groups] = counts.to(torch.float32)
            vals = s / torch.clamp_min(c, 1.0)
            fields.append((out_name, FLOAT))
        else:  # first
            vals = v[starts] if n > 0 else torch.zeros((cap,), dtype=v.dtype,
                                                       device=dev)
            fields.append((out_name, typ))
        out_cols[out_name] = vals

    dicts = {key: list(t.dicts[key])} if key in t.dicts else {}
    return Table(schema=Schema(tuple(fields)), columns=out_cols,
                 row_ids=_fresh_row_ids(n_groups, cap, dev),
                 n_valid=n_groups, dicts=dicts, next_row_id=n_groups)


@track("relational.unique", "R.unique")
def unique(t: Table, col: str) -> Table:
    """Distinct values of one column (sorted)."""
    return group_by(t, col, {})


# ---------------------------------------------------------------------------
# Set operations (on a key column)
# ---------------------------------------------------------------------------


def _set_op(lt: Table, rt: Table, col: str, mode: str) -> Table:
    lk, rk = _join_keys(lt, col, rt, col)
    rk_sorted = torch.sort(rk).values
    in_right = _search(rk_sorted, lk, right=True) > _search(rk_sorted, lk,
                                                            right=False)
    if mode == "intersect":
        return lt.compacted(in_right)
    if mode == "difference":
        return lt.compacted(~in_right)
    raise ValueError(mode)


@track("relational.intersect", "R.intersect")
def intersect(lt: Table, rt: Table, col: str) -> Table:
    """Rows of ``lt`` whose key appears in ``rt`` (semi-join)."""
    return _set_op(lt, rt, col, "intersect")


@track("relational.difference", "R.difference")
def difference(lt: Table, rt: Table, col: str) -> Table:
    """Rows of ``lt`` whose key does NOT appear in ``rt`` (anti-join)."""
    return _set_op(lt, rt, col, "difference")


@track("relational.union", "R.union")
def union(lt: Table, rt: Table) -> Table:
    """Row union (concatenate; schemas must match by name/type)."""
    if lt.schema.names != rt.schema.names:
        raise ValueError("union requires identical schemas")
    n = lt.n_valid + rt.n_valid
    cap = next_capacity(n)
    cols: Dict[str, torch.Tensor] = {}
    dicts: Dict[str, List[str]] = {}
    for name, typ in lt.schema.fields:
        lv = lt.column(name)
        rv = rt.column(name)
        if typ == STR:
            # re-encode right codes into (extended) left dictionary
            merged = list(lt.dicts[name])
            index = {s: i for i, s in enumerate(merged)}
            remap = []
            for s in rt.dicts[name]:
                if s not in index:
                    index[s] = len(merged)
                    merged.append(s)
                remap.append(index[s])
            rv = _remap_codes(rv, remap) if rt.n_valid > 0 else rv
            dicts[name] = merged
        cols[name] = torch.cat([lv, rv, torch.zeros((cap - n,), dtype=lv.dtype,
                                                    device=lv.device)])
    return Table(schema=lt.schema, columns=cols,
                 row_ids=_fresh_row_ids(n, cap, lt.device), n_valid=n,
                 dicts=dicts, next_row_id=n)


# ---------------------------------------------------------------------------
# SimJoin — join records whose distance is below a threshold (paper §2.3)
# ---------------------------------------------------------------------------


@track("relational.sim_join", "R.sim_join")
def sim_join(lt: Table, rt: Table, lcol: str, rcol: str, threshold: float,
             suffixes: Tuple[str, str] = ("_1", "_2")) -> Table:
    """Join rows with |l - r| <= threshold on numeric columns.

    Sort-based band join: sort the right column; each left value matches the
    contiguous sorted range [value-thr, value+thr] found by two searchsorteds.
    Same expansion machinery as the equi-join, so it parallelizes identically.
    """
    lk = lt.column(lcol).to(torch.float32)
    rk = rt.column(rcol).to(torch.float32)
    r_perm = torch.argsort(rk, stable=True).to(_I32)
    rk_sorted = rk[r_perm.long()]
    # the band's edges in float32, as the reference's f32 arithmetic
    thr = torch.tensor(threshold, dtype=torch.float32, device=lk.device)
    lo = _search(rk_sorted, lk - thr, right=False)
    cnt = _search(rk_sorted, lk + thr, right=True) - lo
    total = int(cnt.sum())
    out_cap = next_capacity(total)
    li, ri = _expand_matches(lo, cnt, r_perm, total, out_cap)
    return _assemble_pair_table(lt, rt, li, ri, total, out_cap, suffixes)


# ---------------------------------------------------------------------------
# NextK — predecessor/successor join (paper §2.3)
# ---------------------------------------------------------------------------


@track("relational.next_k", "R.next_k")
def next_k(t: Table, key: str, time_col: str, k: int,
           suffixes: Tuple[str, str] = ("_1", "_2")) -> Table:
    """Join each record with its next ``k`` successors within the same key.

    E.g. consecutive events of the same user: edges (event_i -> event_{i+j})
    for j in 1..k.  Sort by (key, time); successor ranks are then index
    arithmetic — the sort-first trick again.
    """
    n = t.n_valid
    dev = t.device
    sorted_t = order(t, [key, time_col])
    kcol = sorted_t.column(key)
    base = torch.arange(n, dtype=_I32, device=dev)
    lis, ris = [], []
    for j in range(1, k + 1):
        succ = base + j
        same = (succ < n) & (kcol[torch.clamp(succ, max=max(n - 1, 0)).long()]
                             == kcol)
        lis.append(torch.where(same, base, -1))
        ris.append(torch.where(same, succ, -1))
    li_all = torch.cat(lis) if lis else torch.zeros((1,), dtype=_I32,
                                                    device=dev)
    ri_all = torch.cat(ris) if ris else torch.zeros((1,), dtype=_I32,
                                                    device=dev)
    mask = li_all >= 0
    total = int(mask.sum())
    out_cap = next_capacity(total)
    if total == 0:
        li = ri = torch.zeros((out_cap,), dtype=_I32, device=dev)
    else:
        # compact valid pairs to the front; pad the permutation to capacity
        perm = torch.argsort((~mask).to(torch.uint8), stable=True)
        take = min(out_cap, int(perm.shape[0]))
        perm = torch.cat([perm[:take], torch.zeros((out_cap - take,),
                                                   dtype=perm.dtype,
                                                   device=dev)])
        valid = torch.arange(out_cap, device=dev) < total
        li = torch.where(valid, torch.clamp_min(li_all[perm], 0), 0)
        ri = torch.where(valid, torch.clamp_min(ri_all[perm], 0), 0)
    return _assemble_pair_table(sorted_t, sorted_t, li, ri, total, out_cap,
                                suffixes)


# ---------------------------------------------------------------------------
# shared output assembly
# ---------------------------------------------------------------------------


def _assemble_pair_table(lt: Table, rt: Table, li: torch.Tensor,
                         ri: torch.Tensor, total: int, out_cap: int,
                         suffixes: Tuple[str, str]) -> Table:
    fields: List[Tuple[str, str]] = []
    columns: Dict[str, torch.Tensor] = {}
    dicts: Dict[str, List[str]] = {}

    def _emit(src: Table, idx: torch.Tensor, suffix: str, other: Table,
              always_suffix: bool):
        for name, typ in src.schema.fields:
            clash = name in other.schema
            out_name = name + suffix if (clash or always_suffix) else name
            fields.append((out_name, typ))
            columns[out_name] = src.columns[name][idx.long()]
            if typ == STR:
                dicts[out_name] = list(src.dicts[name])

    same = lt is rt
    _emit(lt, li, suffixes[0], rt, always_suffix=same)
    _emit(rt, ri, suffixes[1], lt, always_suffix=same)
    return Table(schema=Schema(tuple(fields)), columns=columns,
                 row_ids=_fresh_row_ids(total, out_cap, lt.device),
                 n_valid=total, dicts=dicts, next_row_id=total)
