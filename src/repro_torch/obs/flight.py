"""Always-on flight recorder: exemplars of slow/failed requests + bundles.

The trace ring answers "what happened recently"; it cannot answer "why was
*that* request at 3 a.m. slow" once it wraps.  The flight recorder closes
that gap by capturing **exemplars at completion time**: when a request
finishes slower than its op's SLO threshold, or errors, or expires, its
full span tree (pulled from the ring *now*, before wrap can evict it),
the engine/sched/service counter deltas since the previous capture, the
current queue depth, and the sched metadata (queued/engine time, cached/
fused flags) are frozen into a bounded per-op store.  Healthy requests
cost one enabled-check plus an SLO window update — nothing is captured.

Feeds (both off the hot submit path, both called with the request already
resolved):

* :meth:`record_completion` — every scheduler completion
  (``Scheduler._done``): ok, error, and expired outcomes;
* :meth:`record_pending` — submit-time resolutions that never reach the
  scheduler (cache hits resolved at submit, input-resolution errors).

:meth:`debug_bundle` assembles the postmortem artifact: metrics snapshot,
Chrome trace, exemplars, SLO health/report, profile report, structured-log
tail, config/env/versions — one JSON-safe dict, optionally written to
disk.  The bundle is pure plain data (scalars/lists/dicts), so it ships
over the wire codec unchanged and ``json.load(json.dump(bundle)) ==
bundle`` holds exactly.
"""

from __future__ import annotations

import os
import platform
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import profile as _profile
from .log import tail as _log_tail
from .metrics import Registry
from .slo import SLOTracker
from .trace import Tracer, _jsonable

__all__ = ["FlightRecorder"]

#: counter prefixes whose deltas ride along in every exemplar
_COUNTER_PREFIXES = ("engine.", "sched.", "service.", "trace.")


def _versions() -> Dict[str, str]:
    """Python, torch, its CUDA, numpy and the card's name (or "cpu")."""
    import numpy
    import torch
    return {"python": platform.python_version(), "torch": torch.__version__,
            "cuda": torch.version.cuda or "none", "numpy": numpy.__version__,
            "device": (torch.cuda.get_device_name(0)
                       if torch.cuda.is_available() else "cpu")}


class FlightRecorder:
    """Bounded per-op exemplar store + debug-bundle assembly."""

    def __init__(self, tracer: Tracer, registry: Registry,
                 slo: Optional[SLOTracker] = None, *,
                 per_op_capacity: int = 8, span_limit: int = 160,
                 min_capture_interval_s: float = 0.25):
        self._tracer = tracer
        self._registry = registry
        self._slo = slo
        self.per_op_capacity = int(per_op_capacity)
        self.span_limit = int(span_limit)
        #: floor between captures of merely-*slow* (successful) requests,
        #: per op: a sustained breach means every completion qualifies, and
        #: freezing a span tree costs a ring scan — rate-limiting keeps the
        #: recorder's completion-path cost bounded under exactly the load
        #: that triggers it.  Errors and expiries are exempt (rare, and the
        #: evidence matters most).
        self.min_capture_interval_s = float(min_capture_interval_s)
        self._lock = threading.Lock()
        self._store: Dict[str, deque] = {}
        self._last_counters: Dict[str, float] = {}
        self._last_slow_capture: Dict[str, float] = {}
        self._c_seen = registry.counter("flight.completions")
        self._c_captured = registry.counter("flight.exemplars")
        self._c_throttled = registry.counter("flight.throttled")

    # -- feeds --------------------------------------------------------------
    def record_completion(self, q: Any, *, engine_ms: float = 0.0,
                          expired: bool = False) -> None:
        """Scheduler completion feed; ``q`` is duck-typed as a
        ``QueuedRequest`` (``.op``, ``.session``, ``.pending``) whose
        pending is already resolved."""
        if not self._registry.enabled:
            return
        p = q.pending
        outcome = ("expired" if expired
                   else "error" if p.error is not None else "ok")
        self._record(op=q.op, session=q.session, trace=p.trace,
                     latency_ms=p.latency_ms, queued_ms=p.queued_ms,
                     engine_ms=engine_ms, outcome=outcome, error=p.error,
                     cached=p.cached, fused=p.fused)

    def record_pending(self, pending: Any, *, op: str,
                       session: str) -> None:
        """Submit-time resolutions that bypass the scheduler entirely
        (cache hits resolved at submit, input-resolution errors)."""
        if not self._registry.enabled or not pending.done:
            return
        outcome = "error" if pending.error is not None else "ok"
        self._record(op=op, session=session, trace=pending.trace,
                     latency_ms=pending.latency_ms, queued_ms=None,
                     engine_ms=0.0, outcome=outcome, error=pending.error,
                     cached=pending.cached, fused=pending.fused)

    def _record(self, *, op: str, session: str, trace: Optional[str],
                latency_ms: Optional[float], queued_ms: Optional[float],
                engine_ms: float, outcome: str, error: Any,
                cached: bool, fused: bool) -> None:
        self._c_seen.inc()
        threshold = float("inf")
        if self._slo is not None:
            self._slo.observe(op, latency_ms or 0.0,
                              error=outcome == "error",
                              expired=outcome == "expired")
            threshold = self._slo.objective_for(op).latency_ms
        slow = latency_ms is not None and latency_ms > threshold
        if outcome == "ok" and not slow:
            return
        if outcome == "ok":
            # slow-but-successful: rate-limited per op (see __init__)
            now_m = time.monotonic()
            with self._lock:
                last = self._last_slow_capture.get(op)
                if (last is not None and
                        now_m - last < self.min_capture_interval_s):
                    throttled = True
                else:
                    throttled = False
                    self._last_slow_capture[op] = now_m
            if throttled:
                self._c_throttled.inc()
                return
        # -- exemplar path: rare by construction, so snapshot cost is fine
        spans = (self._tracer.events_for_trace(trace, limit=self.span_limit)
                 if trace else [])
        snap = self._registry.snapshot()
        counters = {name: s["value"] for name, s in snap.items()
                    if s.get("type") == "counter"
                    and name.startswith(_COUNTER_PREFIXES)}
        depth = (snap.get("sched.queue_depth") or {}).get("value", 0)
        exemplar = {
            "op": op, "session": session, "trace": trace,
            "outcome": outcome, "slow": bool(slow),
            "captured_unix": time.time(),
            "latency_ms": None if latency_ms is None
            else round(float(latency_ms), 3),
            "queued_ms": None if queued_ms is None
            else round(float(queued_ms), 3),
            "engine_ms": round(float(engine_ms), 3),
            "cached": bool(cached), "fused": bool(fused),
            "error": None if error is None
            else f"{type(error).__name__}: {error}",
            "slo_latency_ms": None if threshold == float("inf")
            else float(threshold),
            "queue_depth": int(depth),
            "spans": spans,
        }
        with self._lock:
            delta = {name: v - self._last_counters.get(name, 0)
                     for name, v in counters.items()
                     if v != self._last_counters.get(name, 0)}
            self._last_counters = counters
            exemplar["counters_delta"] = delta
            dq = self._store.get(op)
            if dq is None:
                dq = self._store[op] = deque(maxlen=self.per_op_capacity)
            dq.append(_jsonable(exemplar))
        self._c_captured.inc()

    # -- queries ------------------------------------------------------------
    def exemplars(self, op: Optional[str] = None):
        """Exemplars for one op (a list, oldest first) or all ops (a dict
        of lists)."""
        with self._lock:
            if op is not None:
                return list(self._store.get(op, ()))
            return {o: list(d) for o, d in sorted(self._store.items())}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            per_op = {op: len(d) for op, d in sorted(self._store.items())}
        return {"completions": self._c_seen.value,
                "exemplars": self._c_captured.value,
                "throttled": self._c_throttled.value,
                "per_op": per_op,
                "per_op_capacity": self.per_op_capacity}

    # -- postmortem artifact ------------------------------------------------
    def debug_bundle(self, path: Optional[str] = None, *,
                     trace: Optional[str] = None) -> Dict[str, Any]:
        """One JSON artifact with everything a postmortem needs.

        ``trace`` optionally narrows the embedded Chrome trace to a single
        trace id; exemplars/metrics/SLO state are always global.  ``path``
        additionally writes the JSON to disk.  The returned dict is
        JSON-round-trip exact (tuples already normalized to lists).
        """
        metrics = self._registry.snapshot()
        bundle: Dict[str, Any] = {
            "kind": "repro-debug-bundle", "version": 1,
            "created_unix": time.time(),
            "host": {"pid": os.getpid(),
                     "platform": platform.platform()},
            "versions": _versions(),
            "config": {
                "obs_enabled": bool(self._registry.enabled),
                "tracing_enabled": bool(self._tracer.enabled),
                "env": {k: os.environ[k] for k in sorted(os.environ)
                        if k.startswith("REPRO_")}},
            "health": self._slo.health() if self._slo is not None else None,
            "slo": self._slo.report() if self._slo is not None else None,
            "metrics": metrics,
            "profile": _profile.profile_report(metrics),
            "trace": self._tracer.export_chrome_trace(trace=trace),
            "tracer": self._tracer.stats(),
            "flight": self.stats(),
            "exemplars": self.exemplars(),
            "log_tail": _log_tail(),
        }
        bundle = _jsonable(bundle)
        if path is not None:
            import json
            with open(path, "w") as f:
                json.dump(bundle, f)
        return bundle

    def reset(self) -> None:
        """Test hygiene: drop stored exemplars and the counter baseline."""
        with self._lock:
            self._store.clear()
            self._last_counters = {}
            self._last_slow_capture = {}
