"""Columnar in-memory tables (Ringo §2.3) in PyTorch.

Counterpart of ``repro/core/table.py``, with the same padded layout, so a
table's arrays equal the reference's element for element: every table has
a power-of-two *capacity* and a host-side ``n_valid``; rows past
``n_valid`` are padding (``row_ids`` -1, columns zero-padded where a
constructor pads).  Each row carries a **persistent unique row id**, and
"select in place" compacts the kept rows to the front of the same
capacity bucket.

INT columns are int32 (an int64 input wraps, as the reference's
``astype`` does), FLOAT columns float32, and STR columns int32 codes into
a host-side dictionary of unique strings in first-seen order.  A table
lives on one device: the root constructors take ``device=`` (default: the
card, see :func:`repro_torch.device.resolve`), and every derived table
lives on its input's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve

__all__ = [
    "Schema",
    "Table",
    "ColumnType",
    "next_capacity",
    "INT",
    "FLOAT",
    "STR",
]

INT = "int"
FLOAT = "float"
STR = "str"

_DTYPE_FOR = {INT: torch.int32, FLOAT: torch.float32, STR: torch.int32}
_NP_DTYPE_FOR = {INT: np.int32, FLOAT: np.float32, STR: np.int32}

ColumnType = str


@dataclass(frozen=True)
class Schema:
    """Ordered mapping of column name -> type (int | float | str)."""

    fields: Tuple[Tuple[str, ColumnType], ...]

    def __post_init__(self):
        names = [n for n, _ in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in schema: {names}")
        for _, t in self.fields:
            if t not in (INT, FLOAT, STR):
                raise ValueError(f"unknown column type {t!r}")

    @classmethod
    def of(cls, spec: Mapping[str, ColumnType] | Sequence[Tuple[str, ColumnType]]) -> "Schema":
        if isinstance(spec, Mapping):
            return cls(tuple(spec.items()))
        return cls(tuple(spec))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.fields)

    def type_of(self, name: str) -> ColumnType:
        for n, t in self.fields:
            if n == name:
                return t
        raise KeyError(f"no column {name!r}; have {self.names}")

    def __contains__(self, name: str) -> bool:
        return any(n == name for n, _ in self.fields)

    def with_column(self, name: str, typ: ColumnType) -> "Schema":
        if name in self:
            raise ValueError(f"column {name!r} already exists")
        return Schema(self.fields + ((name, typ),))

    def project(self, names: Sequence[str]) -> "Schema":
        return Schema(tuple((n, self.type_of(n)) for n in names))


def next_capacity(n: int, minimum: int = 8) -> int:
    """Bucket a length to the next power of two."""
    cap = max(int(minimum), 1)
    while cap < n:
        cap *= 2
    return cap


# ---------------------------------------------------------------------------
# Table
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class Table:
    """Columnar table with padded capacity and persistent row ids.

    Attributes
    ----------
    schema:   column names and types.
    columns:  dict name -> tensor of shape (capacity,).
    row_ids:  (capacity,) int32 persistent unique row identifiers.
    n_valid:  number of valid rows (a host int, like Ringo's table length;
              an op that changes it reads the device once).
    dicts:    for STR columns, name -> list of unique strings (host side).
    next_row_id: next fresh row id (host side).
    """

    schema: Schema
    columns: Dict[str, torch.Tensor]
    row_ids: torch.Tensor
    n_valid: int
    dicts: Dict[str, List[str]] = field(default_factory=dict)
    next_row_id: int = 0

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_columns(
        cls,
        schema: Schema | Mapping[str, ColumnType],
        data: Mapping[str, Any],
        capacity: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "Table":
        if not isinstance(schema, Schema):
            schema = Schema.of(schema)
        dev = resolve(device)
        names = schema.names
        if set(data.keys()) != set(names):
            raise ValueError(f"data columns {sorted(data)} != schema columns {sorted(names)}")

        n = None
        dicts: Dict[str, List[str]] = {}
        cols: Dict[str, torch.Tensor] = {}
        for name in names:
            typ = schema.type_of(name)
            raw = data[name]
            if typ == STR:
                codes, uniq = _encode_strings(raw)
                dicts[name] = uniq
                arr = torch.from_numpy(codes).to(dev)
            else:
                arr = _as_column(raw, typ, dev)
            if n is None:
                n = int(arr.shape[0])
            elif int(arr.shape[0]) != n:
                raise ValueError("ragged columns")
            cols[name] = arr
        n = n or 0
        cap = next_capacity(n) if capacity is None else capacity
        if cap < n:
            raise ValueError(f"capacity {cap} < n rows {n}")
        for name in names:
            cols[name] = _pad_to(cols[name], cap)
        row_ids = _pad_to(torch.arange(n, dtype=torch.int32, device=dev), cap,
                          fill=-1)
        return cls(schema=schema, columns=cols, row_ids=row_ids, n_valid=n,
                   dicts=dicts, next_row_id=n)

    @classmethod
    def empty(cls, schema: Schema | Mapping[str, ColumnType], capacity: int = 8,
              device: DeviceLike = None) -> "Table":
        if not isinstance(schema, Schema):
            schema = Schema.of(schema)
        data = {n: np.zeros((0,), dtype=_NP_DTYPE_FOR[schema.type_of(n)])
                if schema.type_of(n) != STR else []
                for n in schema.names}
        return cls.from_columns(schema, data, capacity=capacity, device=device)

    # -- basic accessors ------------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.row_ids.shape[0])

    @property
    def device(self) -> torch.device:
        return self.row_ids.device

    @property
    def version(self) -> str:
        """Provenance version token (see :mod:`repro_torch.core.provenance`).

        Tables are value-immutable (ops return new tables), so the token is
        a stable cache key for any result derived from this table.
        """
        from .provenance import version_of
        return version_of(self)

    def __len__(self) -> int:
        return self.n_valid

    def column(self, name: str) -> torch.Tensor:
        """Valid prefix of a column (length n_valid, on the table's device)."""
        return self.columns[name][: self.n_valid]

    def column_np(self, name: str) -> np.ndarray:
        return self.column(name).cpu().numpy()

    def strings(self, name: str) -> List[str]:
        """Decode a STR column back to python strings (host side)."""
        if self.schema.type_of(name) != STR:
            raise TypeError(f"{name} is not a string column")
        codes = self.column_np(name)
        uniq = self.dicts[name]
        return [uniq[c] for c in codes]

    def to_pydict(self) -> Dict[str, list]:
        out: Dict[str, list] = {}
        for name in self.schema.names:
            if self.schema.type_of(name) == STR:
                out[name] = self.strings(name)
            else:
                out[name] = self.column_np(name).tolist()
        return out

    # -- structural ops -------------------------------------------------------
    def with_valid(self, columns: Dict[str, torch.Tensor], row_ids: torch.Tensor,
                   n_valid: int) -> "Table":
        """Rebuild with same schema/dicts but new storage (bucketed)."""
        return Table(schema=self.schema, columns=columns, row_ids=row_ids,
                     n_valid=n_valid, dicts=dict(self.dicts),
                     next_row_id=self.next_row_id)

    def compacted(self, keep_mask: torch.Tensor) -> "Table":
        """Keep rows where mask (length n_valid) is True; compact to front.

        This is Ringo's "select in place": same capacity, fewer valid rows.
        The kept count is read from the device once.
        """
        mask = keep_mask[: self.n_valid]
        n_keep = int(mask.sum())
        perm = _compact_perm(mask, self.capacity)
        cols = {n: self.columns[n][perm] for n in self.schema.names}
        return self.with_valid(cols, self.row_ids[perm], n_keep)

    def gathered(self, idx: torch.Tensor, n_valid: int,
                 fresh_row_ids: bool = False) -> "Table":
        """New table whose rows are self[idx] (idx may exceed n_valid into pad)."""
        idx = torch.as_tensor(idx, device=self.device)
        cap = next_capacity(int(idx.shape[0]))
        idx = _pad_to(idx.to(torch.int32), cap).long()
        cols = {n: self.columns[n][idx] for n in self.schema.names}
        if fresh_row_ids:
            rid = _pad_to(torch.arange(n_valid, dtype=torch.int32,
                                       device=self.device), cap, fill=-1)
            t = self.with_valid(cols, rid, n_valid)
            t.next_row_id = n_valid
            return t
        return self.with_valid(cols, self.row_ids[idx], n_valid)

    def with_column_added(self, name: str, typ: ColumnType, values: Any,
                          strings: Optional[List[str]] = None) -> "Table":
        """Add a column (length n_valid or capacity); pads to capacity."""
        if typ == STR and strings is None:
            codes, strings = _encode_strings(values)
            arr = torch.from_numpy(codes).to(self.device)
        else:
            arr = _as_column(values, typ, self.device)
        if int(arr.shape[0]) == self.n_valid:
            arr = _pad_to(arr, self.capacity)
        elif int(arr.shape[0]) != self.capacity:
            raise ValueError("column length must be n_valid or capacity")
        new_schema = self.schema.with_column(name, typ)
        cols = dict(self.columns)
        cols[name] = arr
        dicts = dict(self.dicts)
        if typ == STR:
            dicts[name] = list(strings or [])
        return Table(schema=new_schema, columns=cols, row_ids=self.row_ids,
                     n_valid=self.n_valid, dicts=dicts,
                     next_row_id=self.next_row_id)

    def renamed(self, mapping: Mapping[str, str]) -> "Table":
        fields = tuple((mapping.get(n, n), t) for n, t in self.schema.fields)
        cols = {mapping.get(n, n): a for n, a in self.columns.items()}
        dicts = {mapping.get(n, n): v for n, v in self.dicts.items()}
        return Table(schema=Schema(fields), columns=cols, row_ids=self.row_ids,
                     n_valid=self.n_valid, dicts=dicts,
                     next_row_id=self.next_row_id)

    def nbytes(self) -> int:
        """In-memory size (paper Table 2 analogue)."""
        return sum(a.numel() * a.element_size()
                   for a in (self.row_ids, *self.columns.values()))

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"Table({self.n_valid} rows / cap {self.capacity}, "
                f"cols={list(self.schema.names)})")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _as_column(raw: Any, typ: ColumnType, dev: torch.device) -> torch.Tensor:
    """A column's values as a tensor of its declared dtype on ``dev``; host
    values go through numpy's ``astype`` (int64 wraps to int32, as in the
    reference)."""
    if torch.is_tensor(raw):
        return raw.to(device=dev, dtype=_DTYPE_FOR[typ])
    arr = np.asarray(raw).astype(_NP_DTYPE_FOR[typ])
    return torch.from_numpy(arr).to(dev)


def _pad_to(a: torch.Tensor, cap: int, fill: int | float = 0) -> torch.Tensor:
    n = int(a.shape[0])
    if n == cap:
        return a
    if n > cap:
        raise ValueError(f"array of {n} rows > capacity {cap}")
    pad = torch.full((cap - n,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad])


def _encode_strings(raw: Iterable[str]) -> Tuple[np.ndarray, List[str]]:
    """Dictionary-encode strings -> (codes, uniques). Stable first-seen order."""
    uniq: Dict[str, int] = {}
    codes = []
    for s in raw:
        code = uniq.setdefault(s, len(uniq))
        codes.append(code)
    return np.asarray(codes, dtype=np.int32), list(uniq.keys())


def _remap_codes(codes: torch.Tensor, table: Sequence[int]) -> torch.Tensor:
    """``table[codes]`` on the codes' device; a negative code (or an empty
    table) gives -1.  Valid STR codes index their dictionary, so the clamp
    only keeps -1 codes (keys missing from a dictionary) off the gather."""
    if codes.numel() == 0 or len(table) == 0:
        return torch.full_like(codes, -1)
    lut = torch.tensor(np.asarray(table, dtype=np.int32), device=codes.device)
    return torch.where(codes >= 0, lut[codes.clamp(min=0).long()], -1)


def _compact_perm(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Permutation (int64, length cap) putting True rows first in order,
    then the dropped rows and the padding in order: a stable argsort of
    ``~mask`` over the whole capacity."""
    full = torch.ones((cap,), dtype=torch.uint8, device=mask.device)
    full[: mask.shape[0]] = (~mask).to(torch.uint8)
    return torch.argsort(full, stable=True)
