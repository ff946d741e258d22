"""Low-overhead metrics registry: counters, gauges, fixed-bucket histograms.

Design constraints (this sits on the service/engine hot paths):

* **zero-cost when disabled** — every mutating method starts with a plain
  attribute check on the owning registry and returns before touching a lock
  or allocating anything (asserted by ``tests/test_obs.py`` with
  ``sys.getallocatedblocks``);
* **lock-cheap when enabled** — one tiny per-instrument lock held only for
  the couple of integer additions of one update; instrument *lookup*
  (:meth:`Registry.counter` etc.) is a lock-free dict hit after the first
  call, so call sites may either cache the instrument in a module global
  (the engine does) or just look it up each time;
* **snapshot isolation** — :meth:`Registry.snapshot` copies every value
  under its instrument's lock; later updates never mutate a snapshot.

Histograms use **fixed bucket edges** (Prometheus ``le`` semantics: bucket
``i`` counts observations ``<= edges[i]``, with a final +Inf bucket), so
merging/exporting never re-bins and :meth:`Histogram.quantile` can serve
p50/p99 directly from the counts with linear interpolation inside the
bucket — what ``benchmarks/bench_service.py`` reads instead of keeping
private sample lists.  Exposition: :meth:`Registry.snapshot` (plain dict,
wire-friendly) and :meth:`Registry.to_prometheus` (text format).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

__all__ = ["Registry", "Counter", "Gauge", "Histogram",
           "DEFAULT_BUCKETS_MS", "COUNT_BUCKETS", "BYTE_BUCKETS",
           "quantile_from_snapshot"]

# latency-ish buckets (milliseconds): sub-0.1ms cache hits up to multi-second
# cold engine calls
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)

# size/iteration buckets (powers of two): frontier sizes, batch sizes,
# solver iteration counts
COUNT_BUCKETS: Tuple[float, ...] = tuple(
    float(1 << i) for i in range(0, 21))

# byte-size buckets (powers of four, 64 B .. 1 GiB): result-cache entry and
# plan-family sizes span five orders of magnitude, so quarter-decade steps
# keep the histogram small without flattening the distribution
BYTE_BUCKETS: Tuple[float, ...] = tuple(
    float(1 << i) for i in range(6, 31, 2))


class Counter:
    """Monotonically increasing integer (or float) counter."""

    __slots__ = ("name", "_reg", "_lock", "_v")
    kind = "counter"

    def __init__(self, name: str, reg: "Registry"):
        self.name = name
        self._reg = reg
        self._lock = threading.Lock()
        self._v = 0

    def inc(self, n: int = 1) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v

    def _snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"type": "counter", "value": self._v}

    def _reset(self) -> None:
        with self._lock:
            self._v = 0


class Gauge:
    """Last-written value (queue depth, deficit, resident entries)."""

    __slots__ = ("name", "_reg", "_lock", "_v")
    kind = "gauge"

    def __init__(self, name: str, reg: "Registry"):
        self.name = name
        self._reg = reg
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._v = v

    def add(self, n: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v

    def _snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"type": "gauge", "value": self._v}

    def _reset(self) -> None:
        with self._lock:
            self._v = 0.0


class Histogram:
    """Fixed-bucket histogram with Prometheus ``le`` bucket semantics.

    ``counts[i]`` counts observations ``<= edges[i]``; ``counts[-1]`` is the
    +Inf overflow bucket.  Designed for non-negative measurements (latency
    ms, sizes, iteration counts): :meth:`quantile` interpolates from a lower
    edge of 0 for the first bucket.
    """

    __slots__ = ("name", "_reg", "_lock", "edges", "_counts", "_sum", "_n")
    kind = "histogram"

    def __init__(self, name: str, reg: "Registry",
                 buckets: Sequence[float] = DEFAULT_BUCKETS_MS):
        edges = tuple(float(b) for b in buckets)
        if not edges or list(edges) != sorted(edges):
            raise ValueError(f"histogram {name!r} needs sorted, non-empty "
                             f"bucket edges; got {buckets!r}")
        self.name = name
        self._reg = reg
        self._lock = threading.Lock()
        self.edges = edges
        self._counts = [0] * (len(edges) + 1)
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float) -> None:
        if not self._reg.enabled:
            return
        i = bisect_left(self.edges, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """Interpolated quantile from bucket counts; None when degenerate.

        Returns None when the histogram is empty, when every observation
        sits in the zero-anchored first bucket, or when every observation
        overflowed into +Inf — in all three cases no real pair of edges
        brackets the data and any interpolated number (a misleading
        0-adjacent value, or the clamped last edge) would be fabricated.
        Callers fall back to their sample lists (``bench_service.py``) or
        report the absence.  Values in the +Inf bucket of an otherwise
        populated histogram still clamp to the last finite edge — pick the
        bucket layout so the tail you care about is inside it.
        """
        with self._lock:
            counts = list(self._counts)
            n = self._n
        return _quantile(self.edges, counts, n, q)

    def _snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"type": "histogram", "buckets": list(self.edges),
                    "counts": list(self._counts),
                    "sum": self._sum, "count": self._n}

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.edges) + 1)
            self._sum = 0.0
            self._n = 0


def _quantile(edges: Sequence[float], counts: Sequence[int], n: int,
              q: float) -> Optional[float]:
    if n <= 0:
        return None
    if counts[0] >= n or counts[-1] >= n:
        # Degenerate mass: everything in the zero-anchored first bucket or
        # everything in the +Inf overflow.  Neither has a real edge pair
        # around the data, so interpolation would fabricate a value (a
        # misleading near-zero, or the clamped last edge).  A single
        # interior bucket keeps interpolating — both its edges are real.
        return None
    target = max(min(float(q), 1.0), 0.0) * n
    cum = 0
    lo = 0.0
    for i, c in enumerate(counts):
        hi = edges[i] if i < len(edges) else edges[-1]
        if c and cum + c >= target:
            frac = (target - cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += c
        if i < len(edges):
            lo = edges[i]
    return float(edges[-1])


def quantile_from_snapshot(snap: Dict[str, Any], q: float
                           ) -> Optional[float]:
    """Quantile from one histogram entry of a :meth:`Registry.snapshot`.

    Lets a *remote* consumer (``bench_service.py`` reading a server's
    metrics over the wire) compute p50/p99 from the shipped bucket counts
    without holding the live instrument.
    """
    if snap.get("type") != "histogram":
        raise TypeError(f"not a histogram snapshot: {snap!r}")
    return _quantile(list(snap["buckets"]), list(snap["counts"]),
                     int(snap["count"]), q)


_KINDS: Dict[str, Type] = {"counter": Counter, "gauge": Gauge,
                           "histogram": Histogram}


class Registry:
    """Named instruments with one shared on/off switch.

    ``counter/gauge/histogram`` create-or-return by name (the same name
    always yields the same instrument; asking for a different kind under an
    existing name raises).  ``enabled`` is read unlocked on every update —
    flipping it mid-flight is safe, at worst an update lands a moment after
    ``disable()``.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._by_name: Dict[str, Any] = {}

    # -- switches -----------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    # -- instrument access --------------------------------------------------
    def _get(self, name: str, cls: Type, *args) -> Any:
        inst = self._by_name.get(name)
        if inst is None:
            with self._lock:
                inst = self._by_name.get(name)
                if inst is None:
                    inst = cls(name, self, *args)
                    self._by_name[name] = inst
        if type(inst) is not cls:
            raise TypeError(f"metric {name!r} is a {type(inst).__name__}, "
                            f"not a {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS_MS) -> Histogram:
        return self._get(name, Histogram, buckets)

    # -- exposition ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Isolated point-in-time copy: ``{name: {type, value|buckets...}}``.

        Flat dicts of scalars and lists only, so the wire codec ships it
        unchanged and JSON serialization is direct.
        """
        with self._lock:
            insts = list(self._by_name.items())
        return {name: inst._snapshot() for name, inst in sorted(insts)}

    def to_prometheus(self) -> str:
        """Prometheus text exposition of :meth:`snapshot` (stdlib only)."""
        lines: List[str] = []
        for name, snap in self.snapshot().items():
            mname = _prom_name(name)
            lines.append(f"# TYPE {mname} {snap['type']}")
            if snap["type"] == "histogram":
                cum = 0
                for edge, c in zip(snap["buckets"], snap["counts"]):
                    cum += c
                    lines.append(f'{mname}_bucket{{le="{edge:g}"}} {cum}')
                cum += snap["counts"][-1]
                lines.append(f'{mname}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{mname}_sum {snap['sum']:g}")
                lines.append(f"{mname}_count {snap['count']}")
            else:
                lines.append(f"{mname} {snap['value']:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Zero every instrument's value (instruments stay registered, so
        module-global references held by call sites remain valid)."""
        with self._lock:
            insts = list(self._by_name.values())
        for inst in insts:
            inst._reset()


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return ("repro_" + out) if not out.startswith("repro") else out
