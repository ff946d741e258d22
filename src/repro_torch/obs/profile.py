"""Engine profiling: where fixpoint time actually goes.

The spans say *that* an engine call took 80 ms; this layer says *why*:

* **first call vs later calls per backend** — the reference splits each
  jitted fixpoint runner call into trace+compile and execute by a
  signature set keyed on the runner and its argument shapes/dtypes.  The
  port has no jit, and keeps the rule: the first call of a signature (the
  loop mode, the body, the backend's Exec type and the state's and
  arguments' shapes and dtypes) lands in
  ``engine.profile.<backend>.compile_ms``, every later one in
  ``engine.profile.<backend>.execute_ms``.  In the port that first call
  carries what a first use costs: the lazy load of the kernels' shared
  library, the caching allocator's first blocks, the first launch of each
  kernel.  Both are host wall times from dispatch to return, not device
  times: the fixpoint loop syncs only where its stopping rule reads the
  device, so a fixed-round loop's time is mostly dispatch (the
  authoritative per-request engine time is ``sched.engine_ms``, which the
  service takes after a device sync).
* **per-round frontier phase timing** — the frontier host loop's dense /
  sparse step durations land in ``engine.profile.frontier.{dense,sparse}_ms``
  (one observation per round, measured from the step's dispatch to the
  next round's host read of the frontier size, which waits for it).
* **sharded halo traffic** — per sharded fixpoint loop, the per-round halo
  *bytes* (``d * halo_width * 4``, the figure of
  ``ShardPlan.halo_bytes_per_round``) and the loop's host wall time in
  ``engine.profile.sharded.{halo_bytes_per_round,loop_ms}``, plus the
  exchanged bytes and the rounds in ``engine.profile.sharded.
  {halo_bytes_total,rounds}`` when the round count is known (``n_iter`` and
  ``tol`` modes), under the reference's names.

Everything lands in ordinary registry instruments under
``engine.profile.*`` — snapshot/Prometheus/wire exposition come for free —
and :func:`profile_report` renders any snapshot (live, remote, or from a
saved debug bundle) as a text table.

The module is bound to a registry by ``obs/__init__`` (:func:`bind`); all
record calls are no-ops until then and the engine additionally guards them
with ``obs.REGISTRY.enabled``, preserving the zero-cost disabled path.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from .metrics import (BYTE_BUCKETS, DEFAULT_BUCKETS_MS, Registry,
                      quantile_from_snapshot)

__all__ = ["bind", "record_runner", "record_frontier_round",
           "record_sharded", "profile_report"]

_REG: Optional[Registry] = None
_lock = threading.Lock()
_cache: Dict[str, Any] = {}


def bind(registry: Registry) -> None:
    """Attach the profiling instruments to a registry (done once by the
    ``obs`` package for the process-global one)."""
    global _REG
    with _lock:
        _REG = registry
        _cache.clear()


def _hist(name: str, buckets=DEFAULT_BUCKETS_MS):
    h = _cache.get(name)
    if h is None:
        if _REG is None:
            return None
        with _lock:
            h = _cache.get(name)
            if h is None and _REG is not None:
                h = _cache[name] = _REG.histogram(name, buckets)
    return h


def _counter(name: str):
    c = _cache.get(name)
    if c is None:
        if _REG is None:
            return None
        with _lock:
            c = _cache.get(name)
            if c is None and _REG is not None:
                c = _cache[name] = _REG.counter(name)
    return c


def record_runner(backend: str, compiled: bool, dt_ms: float) -> None:
    """One fixpoint runner invocation: ``compiled`` means this was the
    first call of its signature (the first-use costs; see the module
    docstring)."""
    kind = "compile_ms" if compiled else "execute_ms"
    h = _hist(f"engine.profile.{backend}.{kind}")
    if h is not None:
        h.observe(dt_ms)


def record_frontier_round(mode: str, dt_ms: float) -> None:
    """One frontier round's step duration; ``mode`` is ``dense`` or
    ``sparse``."""
    h = _hist(f"engine.profile.frontier.{mode}_ms")
    if h is not None:
        h.observe(dt_ms)


def record_sharded(d: int, halo_bytes_per_round: int, dt_ms: float,
                   rounds: Optional[int] = None) -> None:
    """One sharded fixpoint loop: shard count, per-round halo bytes and
    the loop's wall time; the total bytes when the round count is known."""
    h = _hist("engine.profile.sharded.loop_ms")
    if h is not None:
        h.observe(dt_ms)
    hb = _hist("engine.profile.sharded.halo_bytes_per_round", BYTE_BUCKETS)
    if hb is not None:
        hb.observe(float(halo_bytes_per_round))
    if rounds is not None:
        c = _counter("engine.profile.sharded.halo_bytes_total")
        if c is not None:
            c.inc(int(rounds) * int(halo_bytes_per_round))
        cr = _counter("engine.profile.sharded.rounds")
        if cr is not None:
            cr.inc(int(rounds))


# -- reporting --------------------------------------------------------------

def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v >= 100:
        return f"{v:,.0f}"
    return f"{v:.2f}"


def _hist_row(name: str, snap: Dict[str, Any]) -> tuple:
    n = int(snap.get("count", 0))
    total = float(snap.get("sum", 0.0))
    p50 = quantile_from_snapshot(snap, 0.5) if n else None
    p99 = quantile_from_snapshot(snap, 0.99) if n else None
    mean = (total / n) if n else None
    return (name, n, mean, p50, p99, total)


def profile_report(snapshot: Optional[Dict[str, Any]] = None) -> str:
    """Text table of every ``engine.profile.*`` instrument in a registry
    snapshot (defaults to the bound registry's live snapshot).

    Works identically against a remote server's shipped snapshot or the
    ``metrics`` block of a saved debug bundle — the renderer only needs
    the plain snapshot dict.
    """
    if snapshot is None:
        if _REG is None:
            return "engine profile: no registry bound\n"
        snapshot = _REG.snapshot()
    rows = []
    counters = []
    for name in sorted(snapshot):
        if not name.startswith("engine.profile."):
            continue
        snap = snapshot[name]
        short = name[len("engine.profile."):]
        if snap.get("type") == "histogram":
            rows.append(_hist_row(short, snap))
        else:
            counters.append((short, snap.get("value", 0)))
    lines = ["engine profile"]
    if not rows and not counters:
        lines.append("  (no engine.profile.* samples recorded)")
        return "\n".join(lines) + "\n"
    if rows:
        w = max(len(r[0]) for r in rows)
        lines.append(f"  {'phase':<{w}}  {'count':>7}  {'mean':>10}  "
                     f"{'p50':>10}  {'p99':>10}  {'total':>12}")
        for name, n, mean, p50, p99, total in rows:
            lines.append(f"  {name:<{w}}  {n:>7}  {_fmt(mean):>10}  "
                         f"{_fmt(p50):>10}  {_fmt(p99):>10}  "
                         f"{_fmt(total):>12}")
    for name, v in counters:
        lines.append(f"  {name} = {v:g}")
    # companion engine counters that contextualize the phases
    extras = [n for n in ("engine.frontier.rounds",
                          "engine.frontier.dense_rounds",
                          "engine.frontier.direction_switches",
                          "engine.exec_cache.hits",
                          "engine.exec_cache.misses")
              if n in snapshot]
    if extras:
        lines.append("  --")
        for n in extras:
            lines.append(f"  {n} = {snapshot[n].get('value', 0):g}")
    return "\n".join(lines) + "\n"
