"""Per-request trace spans with Chrome trace-event export.

A **trace id** names one logical request's journey through the stack — it
is minted at the edge (the remote client's ``submit``, or any caller of
:meth:`Tracer.new_trace_id`), rides the wire inside the request payload
(``serve/wire.py``), and every span recorded while serving that request
carries it.  Span *nesting* within a thread propagates through a
``contextvars.ContextVar``: a span opened inside a ``with tracer.span(...)``
block inherits the enclosing span's trace id and parent id automatically,
so the engine never needs to be told which request it is serving.

Cross-thread timing (a request's queued interval starts on the submitting
thread and ends on a scheduler worker) is recorded retroactively with
:meth:`Tracer.add_complete` from the two ``perf_counter`` stamps the
service already keeps — no live span object crosses threads.

Finished spans land in a bounded ring buffer (old spans fall off; tracing
never grows without bound) and :meth:`export_chrome_trace` renders them as
Chrome trace-event JSON (``{"traceEvents": [...]}``) viewable in
``chrome://tracing`` or https://ui.perfetto.dev — optionally filtered to a
single trace id, which is how a remote client fetches a trace of *its own*
requests.  Timestamps are ``perf_counter`` microseconds: monotonic and
shared by every thread in the process, which is all the viewer needs.

Disabled mode is allocation-free: :meth:`Tracer.span` returns a shared
no-op singleton and :meth:`instant`/:meth:`add_complete` return before
building anything.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import secrets
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Sequence, Tuple

__all__ = ["Tracer", "Span", "NOOP_SPAN"]

_CTX: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "repro_obs_span", default=None)

# per-process nonce: trace ids minted by a client process can never collide
# with ids minted by the server it talks to
_NONCE = secrets.token_hex(4)
_TRACE_SEQ = itertools.count(1)
_SPAN_SEQ = itertools.count(1)


class _NoopSpan:
    """Shared do-nothing span returned when tracing is disabled."""

    __slots__ = ()
    trace = None
    span_id = 0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **args: Any) -> None:
        pass

    def finish(self, **args: Any) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed interval; record by ``with`` (nests via contextvar) or by
    calling :meth:`finish` directly (no nesting side effects)."""

    __slots__ = ("_tracer", "name", "trace", "traces", "span_id",
                 "parent_id", "cat", "args", "_t0", "_tid", "_token",
                 "_done")

    def __init__(self, tracer: "Tracer", name: str, trace: Optional[str],
                 traces: Tuple[str, ...], parent_id: int, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.trace = trace
        self.traces = traces
        self.span_id = next(_SPAN_SEQ)
        self.parent_id = parent_id
        self.cat = cat
        self.args = args
        self._t0 = time.perf_counter()
        self._tid = threading.get_ident()
        self._token = None
        self._done = False

    def set(self, **args: Any) -> None:
        self.args.update(args)

    def __enter__(self) -> "Span":
        self._token = _CTX.set(self)
        return self

    def __exit__(self, et, ev, tb) -> bool:
        if self._token is not None:
            _CTX.reset(self._token)
            self._token = None
        if et is not None:
            self.args.setdefault("error", et.__name__)
        self.finish()
        return False

    def finish(self, **args: Any) -> None:
        if self._done:
            return
        self._done = True
        if args:
            self.args.update(args)
        self._tracer._append(
            (self.name, "X", self._t0, time.perf_counter() - self._t0,
             self.trace, self.traces, self._tid, self.span_id,
             self.parent_id, self.cat, self.args))


class Tracer:
    """Bounded ring buffer of finished spans + the context machinery.

    Ring overflow is *accounted*, not silent: every span evicted to make
    room bumps :attr:`dropped` (visible in :meth:`stats` and in the
    ``metadata`` block of :meth:`export_chrome_trace`), and the optional
    :attr:`drop_hook` callable fires once per drop — the obs package wires
    it to the ``trace.dropped`` registry counter so exports and dashboards
    can tell "quiet system" from "ring wrapped and ate the evidence".
    """

    def __init__(self, enabled: bool = True, capacity: int = 65536):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._dropped = 0
        #: optional zero-arg callable invoked (outside the ring lock) once
        #: per dropped span; wired to a registry counter by ``obs``
        self.drop_hook = None

    # -- ids / context ------------------------------------------------------
    def new_trace_id(self) -> str:
        return f"t{_NONCE}-{next(_TRACE_SEQ)}"

    def current(self) -> Optional[Span]:
        s = _CTX.get()
        return s if isinstance(s, Span) else None

    def current_trace(self) -> Optional[str]:
        s = _CTX.get()
        return s.trace if s is not None else None

    # -- recording ----------------------------------------------------------
    def span(self, name: str, *, trace: Optional[str] = None,
             traces: Sequence[str] = (), cat: str = "repro",
             **args: Any):
        """New span starting now.  ``with`` it to nest children under it;
        or keep the handle and :meth:`Span.finish` later (same thread or
        another — only ``with`` touches the context)."""
        if not self.enabled:
            return NOOP_SPAN
        parent = _CTX.get()
        if trace is None and parent is not None:
            trace = parent.trace
        return Span(self, name, trace, tuple(traces),
                    parent.span_id if parent is not None else 0, cat,
                    dict(args))

    def instant(self, name: str, *, trace: Optional[str] = None,
                traces: Sequence[str] = (), cat: str = "repro",
                **args: Any) -> None:
        """Zero-duration point event (admission reject, deadline drop)."""
        if not self.enabled:
            return
        parent = _CTX.get()
        if trace is None and parent is not None:
            trace = parent.trace
        self._append((name, "i", time.perf_counter(), 0.0, trace,
                      tuple(traces), threading.get_ident(), next(_SPAN_SEQ),
                      parent.span_id if parent is not None else 0, cat,
                      dict(args)))

    def add_complete(self, name: str, t0_s: float, t1_s: float, *,
                     trace: Optional[str] = None,
                     traces: Sequence[str] = (), cat: str = "repro",
                     **args: Any) -> None:
        """Record a span retroactively from two ``perf_counter`` stamps."""
        if not self.enabled:
            return
        self._append((name, "X", t0_s, max(t1_s - t0_s, 0.0), trace,
                      tuple(traces), threading.get_ident(), next(_SPAN_SEQ),
                      0, cat, dict(args)))

    def _append(self, ev: Tuple) -> None:
        with self._lock:
            dropped = (self._events.maxlen is not None
                       and len(self._events) == self._events.maxlen)
            if dropped:
                self._dropped += 1
            self._events.append(ev)
        if dropped and self.drop_hook is not None:
            self.drop_hook()

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def dropped(self) -> int:
        """Spans evicted by ring overflow since the last :meth:`clear`."""
        return self._dropped

    def stats(self) -> Dict[str, Any]:
        """Ring accounting: ``{enabled, capacity, buffered, dropped}``."""
        with self._lock:
            return {"enabled": bool(self.enabled),
                    "capacity": self._events.maxlen,
                    "buffered": len(self._events),
                    "dropped": self._dropped}

    # -- export -------------------------------------------------------------
    def export_chrome_trace(self, path: Optional[str] = None, *,
                            trace: Optional[str] = None) -> Dict[str, Any]:
        """Chrome trace-event JSON document for ``chrome://tracing``.

        ``trace=<id>`` keeps only events carrying that trace id (directly or
        in their ``traces`` membership list — a fused engine call belongs to
        every member request's trace).  Thread idents map to small stable
        ints with ``thread_name`` metadata so the viewer's rows are legible.
        ``path`` additionally writes the JSON to disk.
        """
        with self._lock:
            evs = list(self._events)
            dropped = self._dropped
        out, tids = self._render(evs, trace)
        pid = os.getpid()
        for ident, small in tids.items():
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": small,
                        "args": {"name": f"thread-{ident}"}})
        doc = {"traceEvents": out, "displayTimeUnit": "ms",
               "metadata": {"dropped_events": dropped,
                            "capacity": self._events.maxlen,
                            "buffered": len(evs)}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc

    def events_for_trace(self, trace: str,
                         limit: Optional[int] = None) -> list:
        """Chrome-style event dicts for one trace id, oldest first.

        The flight recorder calls this *at request completion time* to
        freeze a slow/failed request's span tree into an exemplar before
        ring wrap can evict it.  ``limit`` keeps only the newest N events.
        """
        with self._lock:
            evs = list(self._events)
        out, _ = self._render(evs, trace)
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def _render(self, evs, trace):
        """Event tuples -> Chrome event dicts (+ tid small-int mapping)."""
        pid = os.getpid()
        tids: Dict[int, int] = {}
        out = []
        for (name, ph, t0, dur, tr, trs, tid, sid, parent, cat,
             args) in evs:
            if trace is not None and tr != trace and trace not in trs:
                continue
            if tid not in tids:
                tids[tid] = len(tids) + 1
            a = {k: _jsonable(v) for k, v in args.items()}
            if tr is not None:
                a["trace"] = tr
            if trs:
                a["traces"] = list(trs)
            a["span_id"] = sid
            if parent:
                a["parent_id"] = parent
            ev: Dict[str, Any] = {"name": name, "ph": ph, "cat": cat,
                                  "ts": round(t0 * 1e6, 3),
                                  "pid": pid, "tid": tids[tid], "args": a}
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            else:
                ev["s"] = "t"
            out.append(ev)
        return out, tids


def _jsonable(v: Any) -> Any:
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)
