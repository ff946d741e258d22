"""Provenance layer — op recording, script export, replay (Ringo §2.1/§4).

Ringo's front end is *interactive*: an analyst iterates trial-and-error over
named tables and graphs, and every derived object silently accumulates
metadata about how it was built, so a finished exploration can be exported as
a runnable script (the paper's §4 demo: "Ringo can export the sequence of
commands as a standalone Python program").  This module is that layer for the
port, the counterpart of ``repro/core/provenance.py`` with an op registry of
its own (the two packages' op names are the same, and a process may load
both):

* every tracked operation (relational ops, table↔graph conversions, graph
  functional updates, algorithms) appends a :class:`ProvRecord` to the
  objects it produces — op name, named inputs (as *version tokens*), literal
  params, output version token(s);
* :func:`version_of` hands out a stable per-object version token (``t3`` /
  ``g7`` / ``a12``).  Objects are immutable and functional updates return
  fresh objects, so a version token also keys result caching — the same
  contract as the identity-memoized ``Graph.plan()`` cache;
* :func:`export_script` emits a runnable Python script reproducing an object
  (roots embedded as literals, or taken as function arguments);
* :func:`replay` re-executes a record chain in-process against fresh root
  inputs.

Implementation notes.  Tracking is *reentrancy-guarded*: while a tracked op
runs, nested tracked calls (``bfs`` → ``sssp``, ``unique`` → ``group_by``)
record nothing, so chains stay at user-call granularity.  Records ride on the
objects themselves (``Table``, ``Graph`` and ``torch.Tensor`` take a dynamic
attribute; objects that refuse one go through a weakref side table, or a
bounded strong pin ring when they refuse weakrefs too).  A tensor parameter
becomes a literal only when it has at most ``_MAX_EMBED`` elements, and only
then is it copied to the host: tracking a call on larger tensors reads
nothing from the card.  An ``EdgeDelta`` parameter is a tagged tuple of its
four columns, each by the same rule.
"""

from __future__ import annotations

import functools
import inspect
import secrets
import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass, replace as _dc_replace
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

__all__ = [
    "ProvRecord",
    "ProvenanceError",
    "Opaque",
    "track",
    "record_call",
    "annotate_last",
    "records_of",
    "version_of",
    "peek_version",
    "bind_version",
    "adopt_records",
    "records_to_wire",
    "records_from_wire",
    "roots_of",
    "object_for_version",
    "canonical_value",
    "canonical_params",
    "contains_opaque",
    "export_script",
    "replay",
    "register_op",
    "set_pin_capacity",
    "pin_stats",
]


class ProvenanceError(RuntimeError):
    """Raised when a chain cannot be exported or replayed."""


class Opaque:
    """Placeholder for a parameter that has no literal form (big arrays,
    callables...).  Hashable by identity, so a cache key containing one
    simply never hits; export/replay refuse it with a clear error."""

    __slots__ = ("desc",)

    def __init__(self, desc: str):
        self.desc = desc

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<opaque {self.desc}>"


@dataclass(frozen=True)
class ProvRecord:
    """One executed operation: how some object(s) came to be.

    ``inputs`` are (param_name, version_token) pairs in signature order;
    ``params`` are (param_name, canonical_literal) pairs; ``outputs`` are the
    version token(s) of the produced value(s) (len > 1 for tuple-returning
    ops like ``hits``).
    """

    op: str
    inputs: Tuple[Tuple[str, str], ...]
    params: Tuple[Tuple[str, Any], ...]
    outputs: Tuple[str, ...]
    #: execution metadata that is *not* part of the computation — e.g. the
    #: service scheduler's queueing/coalescing annotations (queued_ms,
    #: batch size, scheduling mode).  Ignored by export_script and replay:
    #: two runs of the same analysis are the same program regardless of how
    #: the scheduler happened to batch them.
    meta: Tuple[Tuple[str, Any], ...] = ()


# ---------------------------------------------------------------------------
# version tokens + record attachment (attribute first, weakref side table
# for objects that refuse attributes)
# ---------------------------------------------------------------------------

_LOCK = threading.RLock()
_NEXT_VERSION = 1
# Tokens are minted as "<kind><n>x<nonce>" with a per-process random nonce:
# two processes can never mint the same token, so a client-side token
# shipped over the wire (pack_object peeks, never mints — but locally
# tracked ops may have minted one) cannot collide with a server-side one.
# Adopted foreign tokens keep their exact string (bind_version); tokens
# stay valid Python identifiers for export_script.
_PROC_NONCE = secrets.token_hex(4)
_SIDE_VERSIONS: Dict[int, str] = {}
_SIDE_RECORDS: Dict[int, Tuple[ProvRecord, ...]] = {}
# version token -> weakref (or pinned object), for export_script root
# embedding; a small strong ring pins attr-less objects without weakref
# support (prevents id-reuse aliasing).
_BY_VERSION: Dict[str, Any] = {}
_PINNED = object()  # marker: object lives in _STRONG_RING
_STRONG_RING: "OrderedDict[int, Any]" = OrderedDict()
_STRONG_CAP = 4096
# pinned-object id -> version tokens bound to it: ring eviction must also
# drop the _BY_VERSION entries, which hold the object strongly (a pinned
# binding has no weakref death callback — without this reverse map every
# evicted pin leaked its object through _BY_VERSION forever)
_PIN_TOKENS: Dict[int, List[str]] = {}


def _try_setattr(obj: Any, name: str, value: Any) -> bool:
    try:
        object.__setattr__(obj, name, value)
        return True
    except (AttributeError, TypeError):
        return False


def _evict_pin_locked(key: int) -> None:
    """Drop every side-table and registry entry of an evicted pinned id."""
    _SIDE_VERSIONS.pop(key, None)
    _SIDE_RECORDS.pop(key, None)
    obj = _STRONG_RING.pop(key, None)
    for tok in _PIN_TOKENS.pop(key, ()):
        cur = _BY_VERSION.get(tok)
        if isinstance(cur, tuple) and cur[0] is _PINNED and cur[1] is obj:
            del _BY_VERSION[tok]


def _side_put(store: Dict[int, Any], obj: Any, value: Any) -> None:
    key = id(obj)
    with _LOCK:
        store[key] = value
        try:
            weakref.finalize(obj, store.pop, key, None)
        except TypeError:
            # no weakref support: pin the object so its id cannot be reused
            _STRONG_RING[key] = obj
            _STRONG_RING.move_to_end(key)
            while len(_STRONG_RING) > _STRONG_CAP:
                old_key = next(iter(_STRONG_RING))
                if old_key == key:
                    break              # never evict the entry being added
                _evict_pin_locked(old_key)


def set_pin_capacity(n: int) -> None:
    """Bound the strong-pin ring (weakref-less provenance subjects) to ``n``.

    Shrinking evicts oldest pins immediately — their versions/records are
    forgotten, exactly as if the objects had been garbage collected.
    """
    global _STRONG_CAP
    if n < 1:
        raise ValueError(f"pin capacity must be >= 1, got {n}")
    with _LOCK:
        _STRONG_CAP = int(n)
        while len(_STRONG_RING) > _STRONG_CAP:
            _evict_pin_locked(next(iter(_STRONG_RING)))


def pin_stats() -> Dict[str, int]:
    """Accounting for the strong-pin ring: count, capacity and bytes held
    (tensors charge ``numel() * element_size()``, other arrays
    ``size * itemsize``; everything else 0)."""
    with _LOCK:
        nbytes = 0
        for obj in _STRONG_RING.values():
            if torch.is_tensor(obj):
                nbytes += obj.numel() * obj.element_size()
            elif hasattr(obj, "dtype") and hasattr(obj, "size"):
                nbytes += int(obj.size) * int(np.dtype(obj.dtype).itemsize)
        return {"pinned": len(_STRONG_RING), "capacity": _STRONG_CAP,
                "bytes": nbytes}


def _kind_prefix(obj: Any) -> str:
    from .graph import Graph
    from .table import Table
    if isinstance(obj, Table):
        return "t"
    if isinstance(obj, Graph):
        return "g"
    if isinstance(obj, (np.ndarray,)) or hasattr(obj, "dtype"):
        return "a"
    return "v"


def version_of(obj: Any) -> str:
    """Stable version token for ``obj``, assigned on first use.

    Objects are immutable and updates are functional, so identity == version;
    a fresh object (e.g. from ``Graph.add_edges``) gets a fresh token — the
    provenance dual of the plan-cache invalidation-by-construction contract.
    """
    global _NEXT_VERSION
    with _LOCK:
        v = getattr(obj, "_prov_version", None)
        if v is None:
            v = _SIDE_VERSIONS.get(id(obj))
        if v is not None:
            return v
        v = f"{_kind_prefix(obj)}{_NEXT_VERSION}x{_PROC_NONCE}"
        _NEXT_VERSION += 1
        _register_locked(obj, v)
        return v


def _pop_version_if(v: str, ref: Any) -> None:
    """Weakref death callback: drop the registry entry only if it is still
    *this* reference — a token can be re-bound to a fresh object (wire
    adoption re-binding a decoded copy), and the old object's death must
    not evict the new binding."""
    with _LOCK:
        if _BY_VERSION.get(v) is ref:
            del _BY_VERSION[v]


def _register_locked(obj: Any, v: str) -> None:
    if not _try_setattr(obj, "_prov_version", v):
        _side_put(_SIDE_VERSIONS, obj, v)
    cur = _BY_VERSION.get(v)
    if cur is not None:
        alive = cur[1] if isinstance(cur, tuple) and cur[0] is _PINNED \
            else cur()
        if alive is not None:
            # first live binding wins: re-binding a token to a transient
            # decoded copy (wire adoption) must not evict the original —
            # both are the same value, and export roots need the one that
            # stays alive (e.g. in a workspace mirror)
            return
    try:
        _BY_VERSION[v] = weakref.ref(obj,
                                     lambda r, v=v: _pop_version_if(v, r))
    except TypeError:
        # no weakref support: the object is either attr-carrying (rare)
        # or already pinned in the strong ring by _side_put; remember the
        # token so ring eviction can drop this strong binding too
        _BY_VERSION[v] = (_PINNED, obj)
        _PIN_TOKENS.setdefault(id(obj), []).append(v)


def peek_version(obj: Any) -> Optional[str]:
    """``obj``'s version token if one was ever assigned, else None.

    Unlike :func:`version_of` this never mints: the wire layer uses it so a
    *client-side* root ships without a token (the server assigns one and the
    client binds to it) — a client-minted token could collide with tokens
    the server already handed out.
    """
    with _LOCK:
        v = getattr(obj, "_prov_version", None)
        if v is None:
            v = _SIDE_VERSIONS.get(id(obj))
        return v


def _token_num(token: str) -> Optional[int]:
    digits = token.lstrip("tgav")
    return int(digits) if digits.isdigit() else None


def bind_version(obj: Any, token: str) -> str:
    """Register ``obj`` under a version token minted in *another* process.

    A wire protocol ships objects together with their server-assigned
    version tokens; the receiving process binds its
    deserialized copy to the same token so the provenance chain stays
    self-consistent — ``object_for_version`` resolves chain roots to the
    local copies and :func:`export_script` works on remotely computed
    objects.  Minted tokens carry a per-process nonce so a foreign token
    can never collide with a local one; for legacy nonce-less tokens the
    counter is additionally advanced past the foreign token's number.
    """
    global _NEXT_VERSION
    with _LOCK:
        num = _token_num(token)
        if num is not None and num >= _NEXT_VERSION:
            _NEXT_VERSION = num + 1
        _register_locked(obj, token)
        return token


def adopt_records(obj: Any, records: Sequence["ProvRecord"],
                  token: Optional[str] = None) -> None:
    """Attach a provenance chain deserialized from another process.

    ``token`` is the producing process's version token for ``obj`` (defaults
    to the final record's last output); it is bound via :func:`bind_version`
    so downstream records referencing it keep resolving.  With no records
    and no token this is a no-op.
    """
    recs = tuple(records)
    if token is None and recs:
        token = recs[-1].outputs[-1]
    if token is not None:
        bind_version(obj, token)
    if recs:
        _attach_records(obj, recs)


def object_for_version(version: str) -> Optional[Any]:
    """Live object for a version token, if it is still alive."""
    ref = _BY_VERSION.get(version)
    if ref is None:
        return None
    if isinstance(ref, tuple) and ref[0] is _PINNED:
        return ref[1]
    return ref()


def records_of(obj: Any) -> Tuple[ProvRecord, ...]:
    """Full provenance chain of ``obj`` (empty tuple for root objects)."""
    recs = getattr(obj, "_prov_records", None)
    if recs is None:
        recs = _SIDE_RECORDS.get(id(obj), ())
    return recs


def _attach_records(obj: Any, records: Tuple[ProvRecord, ...]) -> None:
    if not _try_setattr(obj, "_prov_records", records):
        _side_put(_SIDE_RECORDS, obj, records)


def _is_tracked(obj: Any) -> bool:
    from .graph import Graph
    from .table import Table
    return isinstance(obj, (Table, Graph)) or bool(records_of(obj))


# ---------------------------------------------------------------------------
# parameter canonicalization (hashable literals -> cache keys + script text)
# ---------------------------------------------------------------------------

_MAX_EMBED = 256  # arrays up to this many elements become literals


def canonical_value(v: Any) -> Any:
    """Hashable canonical form of a parameter value.

    Scalars pass through; sequences/mappings become tagged tuples; small
    arrays become ``("array", dtype, shape, values)`` literals; everything
    else collapses to an :class:`Opaque` sentinel.
    """
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    from .graph import EdgeDelta  # lazy: graph imports this module at load
    if isinstance(v, EdgeDelta):
        # small deltas embed as literals (replayable, exportable update
        # chains); a larger column becomes Opaque, with no host copy
        return ("edge_delta",
                canonical_value(v.add_src), canonical_value(v.add_dst),
                canonical_value(v.del_src), canonical_value(v.del_dst))
    if torch.is_tensor(v):
        if v.numel() > _MAX_EMBED:
            # no host copy and no sync: the description needs only metadata
            dtype = str(v.dtype).removeprefix("torch.")
            return Opaque(f"array{tuple(v.shape)}:{dtype}")
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray) or (hasattr(v, "dtype") and hasattr(v, "shape")):
        arr = np.asarray(v)
        if arr.ndim == 0:
            return arr.item()
        if arr.size <= _MAX_EMBED:
            return ("array", str(arr.dtype), tuple(arr.shape),
                    tuple(arr.reshape(-1).tolist()))
        return Opaque(f"array{tuple(arr.shape)}:{arr.dtype}")
    if isinstance(v, (list, tuple)):
        return ("tuple", tuple(canonical_value(x) for x in v))
    if isinstance(v, Mapping):
        return ("dict", tuple((str(k), canonical_value(x)) for k, x in v.items()))
    return Opaque(type(v).__name__)


def canonical_params(params: Mapping[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    return tuple((k, canonical_value(v)) for k, v in params.items())


def contains_opaque(canon: Any) -> bool:
    if isinstance(canon, Opaque):
        return True
    if isinstance(canon, tuple):
        return any(contains_opaque(x) for x in canon)
    return False


# -- wire form (cross-process serving) --------------------------------------
# Canonical params are already plain data except Opaque, which has no literal
# form by definition; on the wire it becomes a tagged tuple and comes back as
# a fresh Opaque (identity lost — exactly the semantics Opaque promises).

_OPAQUE_TAG = "__opaque__"


def _wire_val(v: Any) -> Any:
    if isinstance(v, Opaque):
        return (_OPAQUE_TAG, v.desc)
    if isinstance(v, tuple):
        return tuple(_wire_val(x) for x in v)
    return v


def _unwire_val(v: Any) -> Any:
    if isinstance(v, tuple):
        if len(v) == 2 and v[0] == _OPAQUE_TAG:
            return Opaque(v[1])
        return tuple(_unwire_val(x) for x in v)
    return v


def records_to_wire(records: Sequence[ProvRecord]) -> list:
    """Provenance chain -> plain data (tuples/lists/scalars) for the codec."""
    return [{"op": r.op, "inputs": tuple(r.inputs),
             "params": _wire_val(r.params), "outputs": tuple(r.outputs),
             "meta": _wire_val(r.meta)} for r in records]


def records_from_wire(data: Iterable[Mapping[str, Any]]
                      ) -> Tuple[ProvRecord, ...]:
    return tuple(
        ProvRecord(op=d["op"],
                   inputs=tuple((n, v) for n, v in d["inputs"]),
                   params=_unwire_val(tuple(d["params"])),
                   outputs=tuple(d["outputs"]),
                   meta=_unwire_val(tuple(d["meta"]))) for d in data)


def _uncanonical(v: Any) -> Any:
    """Canonical literal -> live value (for replay)."""
    if isinstance(v, Opaque):
        raise ProvenanceError(f"cannot replay opaque parameter {v!r}")
    if isinstance(v, tuple) and v and v[0] == "array":
        _, dtype, shape, vals = v
        return torch.tensor(np.asarray(vals, dtype=dtype).reshape(shape))
    if isinstance(v, tuple) and v and v[0] == "edge_delta":
        from .graph import EdgeDelta
        return EdgeDelta(*(_uncanonical(x) for x in v[1:]))
    if isinstance(v, tuple) and v and v[0] == "tuple":
        return tuple(_uncanonical(x) for x in v[1])
    if isinstance(v, tuple) and v and v[0] == "dict":
        return {k: _uncanonical(x) for k, x in v[1]}
    return v


def _literal(v: Any) -> str:
    """Canonical literal -> python source text (for export_script)."""
    if isinstance(v, Opaque):
        raise ProvenanceError(f"cannot export opaque parameter {v!r}")
    if isinstance(v, tuple) and v and v[0] == "array":
        _, dtype, shape, vals = v
        return (f"torch.tensor(np.asarray({list(vals)!r}, "
                f"dtype={dtype!r}).reshape({tuple(shape)!r}))")
    if isinstance(v, tuple) and v and v[0] == "edge_delta":
        a_s, a_d, d_s, d_d = (_literal(x) for x in v[1:])
        return (f"EdgeDelta(add_src={a_s}, add_dst={a_d}, "
                f"del_src={d_s}, del_dst={d_d})")
    if isinstance(v, tuple) and v and v[0] == "tuple":
        inner = ", ".join(_literal(x) for x in v[1])
        comma = "," if len(v[1]) == 1 else ""
        return f"({inner}{comma})"
    if isinstance(v, tuple) and v and v[0] == "dict":
        inner = ", ".join(f"{k!r}: {_literal(x)}" for k, x in v[1])
        return "{" + inner + "}"
    return repr(v)


# ---------------------------------------------------------------------------
# op registry + tracking decorator
# ---------------------------------------------------------------------------

# op name -> (callable, script expression path e.g. "R.select")
_OPS: Dict[str, Tuple[Callable, str]] = {}
_LOCAL = threading.local()


def register_op(op: str, fn: Callable, script: str) -> None:
    _OPS[op] = (fn, script)


def record_call(op: str, tracked: Sequence[Tuple[str, Any]],
                params: Mapping[str, Any] | Tuple[Tuple[str, Any], ...],
                out: Any, multi_output: Optional[bool] = None,
                meta: Optional[Mapping[str, Any]] = None) -> ProvRecord:
    """Manually append a :class:`ProvRecord` for an executed op.

    ``tracked`` is (param_name, input_object) in call order; ``params`` holds
    the remaining literal parameters.  Input chains merge (deduplicated by
    output token, order-preserving) and the new record is appended to the
    chain attached to ``out`` (each element, if the op returns a tuple).
    ``meta`` attaches execution metadata (scheduler queueing/coalescing
    facts) that export/replay ignore.

    Used directly by the service's fusion scheduler, which executes one
    batched engine call but must give every per-request slice the provenance
    of the equivalent single-source call.
    """
    if multi_output is None:
        multi_output = isinstance(out, tuple)
    canon = params if isinstance(params, tuple) else canonical_params(params)
    inputs = tuple((name, version_of(objx)) for name, objx in tracked)
    outs = tuple(out) if multi_output else (out,)
    outputs = tuple(version_of(o) for o in outs)
    mcanon = () if meta is None else canonical_params(meta)
    rec = ProvRecord(op=op, inputs=inputs, params=canon, outputs=outputs,
                     meta=mcanon)
    chain: List[ProvRecord] = []
    seen: set = set()
    for _, objx in tracked:
        for r in records_of(objx):
            if r.outputs not in seen:
                seen.add(r.outputs)
                chain.append(r)
    chain.append(rec)
    for o in outs:
        _attach_records(o, tuple(chain))
    return rec


def annotate_last(obj: Any, meta: Mapping[str, Any]) -> bool:
    """Merge ``meta`` into the newest provenance record attached to ``obj``.

    The service scheduler uses this to stamp queueing/coalescing facts
    (queued_ms, batch size, scheduling mode) onto a result produced through
    a ``@track``-ed op — the record already exists by the time the
    scheduler knows what it cost.  Returns False (no-op) for objects
    without provenance, e.g. tuple-returning ops or roots.  Only call this
    on a freshly produced object: chains are shared by reference with
    cached copies of the same value.
    """
    recs = records_of(obj)
    if not recs:
        return False
    last = _dc_replace(recs[-1],
                       meta=recs[-1].meta + canonical_params(meta))
    _attach_records(obj, recs[:-1] + (last,))
    return True


def track(op: str, script: str) -> Callable:
    """Decorator: register ``fn`` as op ``op`` and record each top-level call.

    Nested tracked calls (one tracked op implemented via another) record
    nothing — the reentrancy guard keeps chains at user-call granularity.
    ``script`` is the expression path used by :func:`export_script`
    (e.g. ``"R.select"``); it must resolve under the standard script header.
    """
    def deco(fn: Callable) -> Callable:
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if getattr(_LOCAL, "depth", 0):
                return fn(*args, **kwargs)
            _LOCAL.depth = 1
            try:
                out = fn(*args, **kwargs)
            finally:
                _LOCAL.depth = 0
            try:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
            except TypeError:  # pragma: no cover - fn would have raised too
                return out
            tracked_in: List[Tuple[str, Any]] = []
            params: List[Tuple[str, Any]] = []
            for name, val in bound.arguments.items():
                if _is_tracked(val):
                    tracked_in.append((name, val))
                else:
                    params.append((name, canonical_value(val)))
            record_call(op, tracked_in, tuple(params), out)
            return out

        register_op(op, wrapper, script)
        return wrapper

    return deco


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


def roots_of(records: Sequence[ProvRecord]) -> Tuple[str, ...]:
    """Version tokens consumed but never produced by ``records`` (in order)."""
    produced = {v for r in records for v in r.outputs}
    roots: List[str] = []
    for r in records:
        for _, ver in r.inputs:
            if ver not in produced and ver not in roots:
                roots.append(ver)
    return tuple(roots)


def replay(records: Sequence[ProvRecord], inputs: Mapping[str, Any]):
    """Re-execute a record chain against fresh root inputs.

    ``inputs`` maps root version tokens (see :func:`roots_of`) to objects.
    Returns the value of the final record (a tuple if it had multiple
    outputs).  Replayed objects get fresh provenance of their own.
    """
    env: Dict[str, Any] = dict(inputs)
    out: Any = None
    for r in records:
        if r.op not in _OPS:
            raise ProvenanceError(f"unknown op {r.op!r} in record chain")
        fn, _ = _OPS[r.op]
        kwargs: Dict[str, Any] = {}
        for name, ver in r.inputs:
            if ver not in env:
                raise ProvenanceError(
                    f"replay missing input {ver!r} for op {r.op!r}; "
                    f"provide it via inputs= (roots: {roots_of(records)})")
            kwargs[name] = env[ver]
        for name, val in r.params:
            kwargs[name] = _uncanonical(val)
        out = fn(**kwargs)
        if len(r.outputs) > 1:
            for ver, o in zip(r.outputs, out):
                env[ver] = o
        else:
            env[r.outputs[0]] = out
    return out


# ---------------------------------------------------------------------------
# script export (the paper's §4 "export the analysis as a program")
# ---------------------------------------------------------------------------

_SCRIPT_HEADER = '''\
"""Auto-exported provenance script (Ringo §4: an interactive analysis,
replayable as a standalone program).  Run with PYTHONPATH=<repo>/src."""

import numpy as np
import torch

from repro_torch.core.table import Table
from repro_torch.core.graph import EdgeDelta, Graph
from repro_torch.core import relational as R
from repro_torch.core import algorithms as A
from repro_torch.core import convert as C
'''


def _embed_root(ver: str, obj: Any) -> str:
    """Literal construction code for a root object (Table/Graph/array)."""
    from .graph import Graph
    from .table import Table
    if isinstance(obj, Table):
        schema = {n: t for n, t in obj.schema.fields}
        data = obj.to_pydict()
        return (f"{ver} = Table.from_columns({schema!r}, {data!r}, "
                f"device={obj.device.type!r})")
    if isinstance(obj, Graph):
        s, d = obj.out_edges()
        src = obj.original_of(s).tolist()
        dst = obj.original_of(d).tolist()
        return (f"{ver} = Graph.from_edges(np.asarray({src!r}, np.int32), "
                f"np.asarray({dst!r}, np.int32), dedupe=False, "
                f"device={obj.device.type!r})")
    canon = canonical_value(obj)
    if contains_opaque(canon):
        raise ProvenanceError(
            f"root {ver!r} ({type(obj).__name__}) is too large to embed; "
            f"use embed_roots=False and pass it to the emitted function")
    return f"{ver} = {_literal(canon)}"


def export_script(obj: Any, *, embed_roots: bool = True,
                  func_name: str = "rebuild") -> str:
    """Emit a runnable Python script that rebuilds ``obj`` from its chain.

    With ``embed_roots=True`` root tables/graphs are embedded as literal
    constructors and the emitted ``rebuild()`` takes no arguments — a fully
    standalone program.  With ``embed_roots=False`` the roots become the
    function's parameters (named by version token), for re-running the same
    analysis against fresh data.
    """
    records = records_of(obj)
    if not records:
        raise ProvenanceError(
            "object has no provenance records (is it a root, or did it "
            "cross a jit boundary?)")
    target = version_of(obj)
    roots = roots_of(records)
    lines: List[str] = [_SCRIPT_HEADER, ""]

    if embed_roots:
        arg_list = ""
        body_roots: List[str] = []
        for ver in roots:
            root_obj = object_for_version(ver)
            if root_obj is None:
                raise ProvenanceError(
                    f"root object {ver!r} has been garbage-collected; "
                    f"keep roots alive (e.g. in a Workspace) or use "
                    f"embed_roots=False")
            body_roots.append("    " + _embed_root(ver, root_obj))
    else:
        arg_list = ", ".join(roots)
        body_roots = []

    lines.append(f"def {func_name}({arg_list}):")
    lines.extend(body_roots)
    for r in records:
        if r.op not in _OPS:
            raise ProvenanceError(f"unknown op {r.op!r} in record chain")
        _, path = _OPS[r.op]
        kwargs = [f"{name}={ver}" for name, ver in r.inputs]
        kwargs += [f"{name}={_literal(val)}" for name, val in r.params]
        targets = ", ".join(r.outputs)
        lines.append(f"    {targets} = {path}({', '.join(kwargs)})")
    lines.append(f"    return {target}")
    lines.append("")
    lines.append("")
    lines.append('if __name__ == "__main__":')
    if embed_roots:
        lines.append(f"    print({func_name}())")
    else:
        msg = f"pass roots {', '.join(roots)} to {func_name}()"
        lines.append(f"    raise SystemExit({msg!r})")
    lines.append("")
    return "\n".join(lines)
