"""Observability for the port: metrics, traces, logs, SLOs, flight recorder.

The reference's ``obs`` package with a registry, tracer, SLO tracker and
flight recorder of the port's own: one module-level
:class:`~repro_torch.obs.metrics.Registry` and one
:class:`~repro_torch.obs.trace.Tracer` serve the process, and every layer
(engine, scheduler, service, server) records into them::

    from repro_torch import obs

    obs.counter("service.requests").inc()
    obs.histogram("sched.engine_ms").observe(dt_ms)
    with obs.span("engine.bfs", trace=tid, batch=4):
        ...                       # children opened here nest automatically

    obs.dump_metrics()            # {"name": {"type": ..., ...}} snapshot
    obs.dump_metrics("prom")      # Prometheus text exposition
    obs.export_chrome_trace("trace.json")   # open in chrome://tracing

The metric names are the reference's (``engine.*``, ``sched.*``,
``service.*``, ``mem.*``): the registry is a separate object, so nothing
mixes, and the flight recorder's counter prefixes and the report renderer
read both the same way.  Both planes are enabled by default; set
``REPRO_OBS=0`` in the environment, or call :func:`disable`, for the
zero-cost path: counter updates return on one attribute check, ``span()``
hands back a shared no-op singleton, nothing allocates.
``REPRO_OBS_LOG=<level>`` configures the structured logger
(:mod:`repro_torch.obs.log`; default ``warning``).  No instrument reads the
device: each records what the host already holds.

Trace ids (:func:`new_trace_id`) are minted at the request edge and ride
the wire (``serve/wire.py``), so a remote client's id shows up on the
server's spans, on result provenance (``ProvRecord.meta``), and filters
:func:`export_chrome_trace` down to that client's own requests.

On top of the raw instruments sits the judgment layer:

* :data:`SLO` (:class:`~repro_torch.obs.slo.SLOTracker`) — rolling-window
  latency objectives, error budgets, burn rates; :func:`health` is the
  ``ok|degraded|breaching`` verdict, :func:`slo_report` the full window;
* :data:`FLIGHT` (:class:`~repro_torch.obs.flight.FlightRecorder`) —
  exemplars of slow/errored/expired requests frozen at completion time
  (they survive trace-ring wrap) and :func:`debug_bundle` postmortem
  artifacts;
* :mod:`repro_torch.obs.profile` — ``engine.profile.*`` instruments (first
  call vs later calls per backend, frontier round phases) and
  :func:`profile_report`; ``python -m repro_torch.obs.report`` renders the
  dashboard against a live server or a saved bundle.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

from . import log as _log
from .log import StructLogger, format_event, get_logger
from .metrics import (BYTE_BUCKETS, COUNT_BUCKETS, DEFAULT_BUCKETS_MS,
                      Counter, Gauge, Histogram, Registry,
                      quantile_from_snapshot)
from .trace import NOOP_SPAN, Span, Tracer
from .slo import Objective, SLOTracker
from .flight import FlightRecorder
from . import profile

__all__ = [
    "REGISTRY", "TRACER", "SLO", "FLIGHT",
    "Registry", "Tracer", "Span", "NOOP_SPAN",
    "Counter", "Gauge", "Histogram", "StructLogger",
    "Objective", "SLOTracker", "FlightRecorder", "profile",
    "DEFAULT_BUCKETS_MS", "COUNT_BUCKETS", "BYTE_BUCKETS",
    "enable", "disable", "enabled",
    "counter", "gauge", "histogram", "quantile_from_snapshot",
    "span", "instant", "add_complete", "new_trace_id", "current_trace",
    "dump_metrics", "export_chrome_trace", "reset",
    "health", "slo_report", "debug_bundle", "profile_report",
    "get_logger", "format_event", "log",
]


def _env_flag(name: str, default: bool = True) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.strip().lower() not in ("0", "false", "no", "off")


_ON = _env_flag("REPRO_OBS", True)

REGISTRY = Registry(enabled=_ON)
TRACER = Tracer(enabled=_ON)

#: process-global SLO tracker and flight recorder (the judgment layer);
#: both follow REGISTRY.enabled — no separate switch
SLO = SLOTracker(REGISTRY)
FLIGHT = FlightRecorder(TRACER, REGISTRY, slo=SLO)

# account trace-ring overflow in the metrics plane (wired here rather than
# inside trace.py to keep that module free of a metrics import)
TRACER.drop_hook = REGISTRY.counter("trace.dropped").inc

# bind the engine-profiling instruments to the global registry
profile.bind(REGISTRY)


def enable(*, metrics: bool = True, tracing: bool = True) -> None:
    if metrics:
        REGISTRY.enabled = True
    if tracing:
        TRACER.enabled = True


def disable(*, metrics: bool = True, tracing: bool = True) -> None:
    if metrics:
        REGISTRY.enabled = False
    if tracing:
        TRACER.enabled = False


def enabled() -> bool:
    return REGISTRY.enabled or TRACER.enabled


# bound-method shortcuts: obs.counter("x").inc() etc.
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram

span = TRACER.span
instant = TRACER.instant
add_complete = TRACER.add_complete
new_trace_id = TRACER.new_trace_id
current_trace = TRACER.current_trace


def dump_metrics(fmt: str = "json") -> Union[Dict[str, Any], str]:
    """Metrics snapshot: ``"json"`` -> plain dict (wire/JSON-friendly),
    ``"prom"`` -> Prometheus text exposition."""
    if fmt == "json":
        return REGISTRY.snapshot()
    if fmt == "prom":
        return REGISTRY.to_prometheus()
    raise ValueError(f"unknown metrics format {fmt!r}; want 'json' or 'prom'")


def export_chrome_trace(path: Optional[str] = None, *,
                        trace: Optional[str] = None) -> Dict[str, Any]:
    """Chrome trace-event JSON of the span ring buffer (see
    :meth:`repro_torch.obs.trace.Tracer.export_chrome_trace`)."""
    return TRACER.export_chrome_trace(path, trace=trace)


def health() -> Dict[str, Any]:
    """Rolling-window SLO verdict: ``ok|degraded|breaching`` overall and
    per op (see :meth:`repro_torch.obs.slo.SLOTracker.health`)."""
    return SLO.health()


def slo_report() -> Dict[str, Any]:
    """Full SLO window: per-op rates, burn, quantiles, objectives."""
    return SLO.report()


def debug_bundle(path: Optional[str] = None, *,
                 trace: Optional[str] = None) -> Dict[str, Any]:
    """Postmortem artifact: metrics, trace, exemplars, SLO state, profile
    report, log tail, config/versions (see
    :meth:`repro_torch.obs.flight.FlightRecorder.debug_bundle`)."""
    return FLIGHT.debug_bundle(path, trace=trace)


def profile_report() -> str:
    """Text table of the ``engine.profile.*`` instruments."""
    return profile.profile_report(REGISTRY.snapshot())


def reset() -> None:
    """Zero all metric values, drop buffered spans, and clear SLO windows,
    flight-recorder exemplars, and the log tail (test hygiene)."""
    REGISTRY.reset()
    TRACER.clear()
    SLO.reset()
    FLIGHT.reset()
    _log.clear_tail()


#: module-level structured logger for ad-hoc events
log = get_logger("repro_torch")
