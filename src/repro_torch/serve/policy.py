"""Scheduling policy objects for the interactive service (Ringo §2.1/§4).

Ringo's contract is *interactivity under sharing*: many analysts iterate
trial-and-error on one big-memory machine, and the system must stay
responsive when one of them floods it — not just be fast when idle.  The
policies here parameterize the three levers the scheduler
(:mod:`repro_torch.serve.scheduler`) pulls:

* **admission control** (:class:`AdmissionPolicy`) — bounded per-session
  in-flight quota and global queue-depth backpressure.  Over-quota submits
  raise :class:`RejectedError` carrying a ``retry_after`` estimate derived
  from the observed service rate, so a well-behaved client backs off for
  about as long as the queue needs to drain its share.
* **fair share** (:class:`FairSharePolicy`) — deficit-round-robin across
  sessions, charged in *measured engine milliseconds*.  Every scheduling
  pass tops each waiting session up by ``quantum_ms * weight``; an executed
  request (or a session's slice of a coalesced batch) is charged back at its
  actual cost.  A scan-heavy session therefore overdraws its deficit and
  waits out the debt while interactive sessions, whose cheap queries barely
  dent theirs, keep flowing.  ``floor_ms`` bounds the debt (old sins decay),
  ``burst_ms`` bounds the credit (idle sessions cannot hoard a burst).
* **batching windows** (:class:`BatchPolicy`) — the generalized fusion
  scheduler.  Under load, compatible single-source requests accumulate for a
  bounded window before one coalesced engine call; with an empty queue the
  window collapses to zero so idle latency is unchanged.

:class:`SchedulerPolicy` bundles the three plus the scheduling ``mode``
(``"fair"`` deficit-round-robin vs ``"fifo"`` global arrival order — the
baseline the overload benchmark compares against) and an optional default
request deadline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

__all__ = [
    "ServiceError",
    "RejectedError",
    "DeadlineExpired",
    "RemoteError",
    "error_to_wire",
    "error_from_wire",
    "AdmissionPolicy",
    "FairSharePolicy",
    "BatchPolicy",
    "MemoryPolicy",
    "SchedulerPolicy",
]


class ServiceError(RuntimeError):
    """Base error for declarative-request execution."""


class RejectedError(ServiceError):
    """Admission control refused the request (quota or queue depth).

    ``retry_after`` (seconds) estimates when capacity frees up: the
    session's queued share divided by the scheduler's observed service
    rate.  Clients should back off at least that long before resubmitting.
    """

    def __init__(self, msg: str, retry_after: float):
        super().__init__(f"{msg} (retry after {retry_after:.3f}s)")
        self.retry_after = float(retry_after)


class DeadlineExpired(ServiceError):
    """The request's deadline passed while it sat in the queue.

    Stale interactive work is dropped *before* reaching the engine — by the
    time it would run, the analyst has moved on, and executing it anyway
    only delays everyone else's fresh queries.
    """


class RemoteError(ServiceError):
    """A server-side failure of a type the wire cannot reconstruct.

    The original exception type name is preserved in the message; the
    client-visible contract is only that the request failed server-side.
    """


# ---------------------------------------------------------------------------
# typed error frames: the service's error vocabulary knows its own wire form,
# so admission-control semantics (RejectedError.retry_after, DeadlineExpired)
# survive a cross-process hop intact and clients back off exactly as an
# in-process caller would.
# ---------------------------------------------------------------------------


def error_to_wire(exc: BaseException) -> Dict[str, Any]:
    """Typed-error payload for an exception crossing the wire."""
    if isinstance(exc, KeyError) and len(exc.args) == 1 \
            and isinstance(exc.args[0], str):
        # str(KeyError) is the repr of its argument; ship the argument
        # itself so the client-side KeyError has identical args
        message = exc.args[0]
    else:
        message = str(exc)
    payload: Dict[str, Any] = {"etype": type(exc).__name__,
                               "message": message}
    if isinstance(exc, RejectedError):
        payload["retry_after"] = exc.retry_after
    return payload


def error_from_wire(payload: Dict[str, Any]) -> BaseException:
    """Rebuild the client-side exception for a typed error payload.

    Service errors come back as their own types (``RejectedError`` keeps its
    ``retry_after``; ``DeadlineExpired`` stays catchable as such); lookup
    failures stay ``KeyError`` so remote sessions mirror in-process ones.
    Anything else becomes :class:`RemoteError` with the original type name
    in the message.
    """
    etype = payload.get("etype", "Exception")
    msg = str(payload.get("message", ""))
    if etype == "RejectedError":
        exc = RejectedError.__new__(RejectedError)
        ServiceError.__init__(exc, msg)
        exc.retry_after = float(payload.get("retry_after", 0.01))
        return exc
    if etype == "DeadlineExpired":
        return DeadlineExpired(msg)
    if etype == "ServiceError":
        return ServiceError(msg)
    if etype == "KeyError":
        return KeyError(msg)   # error_to_wire shipped args[0] verbatim
    if etype == "TimeoutError":
        return TimeoutError(msg)
    return RemoteError(f"{etype}: {msg}")


@dataclass
class AdmissionPolicy:
    """Per-session in-flight quota + global queue-depth backpressure."""

    #: queued + executing requests a session may have before submits reject
    max_inflight: int = 64
    #: per-session overrides of :attr:`max_inflight` (session name -> quota)
    inflight_overrides: Dict[str, int] = field(default_factory=dict)
    #: total queued requests across all sessions before any submit rejects
    max_queue_depth: int = 1024
    #: floor for the retry-after estimate (seconds)
    min_retry_after_s: float = 0.01
    #: opt-in SLO-aware shedding: while ``obs.SLO`` reports the submitted
    #: op (or the service overall) as *breaching*, both admission bounds
    #: shrink by :attr:`shed_factor` so backlog drains instead of piling up
    #: behind an objective that is already blown.  Off by default — turning
    #: observability into admission behavior is a deliberate choice.
    slo_shed: bool = False
    #: multiplier applied to ``max_inflight``/``max_queue_depth`` while
    #: shedding (floored at 1 so the service never fully closes)
    shed_factor: float = 0.5

    def quota_for(self, session: str) -> int:
        return int(self.inflight_overrides.get(session, self.max_inflight))


@dataclass
class FairSharePolicy:
    """Deficit-round-robin parameters, denominated in engine milliseconds."""

    #: per-pass top-up: engine-ms of service each waiting session earns
    quantum_ms: float = 5.0
    #: per-session weight overrides (session name -> relative share)
    weights: Dict[str, float] = field(default_factory=dict)
    default_weight: float = 1.0
    #: deficit floor — the deepest debt a session can carry; bounds how long
    #: a formerly-greedy session is locked out once it turns interactive
    floor_ms: float = 2000.0
    #: deficit ceiling — unspent credit an idle session can bank
    burst_ms: float = 50.0
    #: EMA factor for the per-session recent-engine-ms consumption stat
    decay: float = 0.9

    def weight_for(self, session: str) -> float:
        return float(self.weights.get(session, self.default_weight))


@dataclass
class BatchPolicy:
    """Load-tiered coalescing window for compatible single-source requests."""

    #: longest a dequeued fusable request waits for companions (milliseconds)
    window_ms: float = 5.0
    #: widest coalesced batch (one batched engine call)
    max_batch: int = 64
    #: queued requests (beyond the dequeued one) at which the window opens
    #: fully; below it the window scales down, reaching zero on an empty
    #: queue — idle single requests never wait
    load_full_at: int = 8

    def effective_window_s(self, queued_behind: int) -> float:
        """Seconds to hold a fusable request open, given current load.

        Zero when nothing else is queued (the idle path executes
        immediately); scales linearly up to :attr:`window_ms` as the backlog
        approaches :attr:`load_full_at`.
        """
        if queued_behind <= 0 or self.window_ms <= 0:
            return 0.0
        frac = min(1.0, queued_behind / max(1, self.load_full_at))
        return (self.window_ms * frac) / 1e3


@dataclass
class MemoryPolicy:
    """Byte budget + eviction knobs for a long-lived serving process.

    The budget governs the service's *tracked* bytes: the result cache plus
    the re-derivable plan families of every live graph the service has
    served (see ``GraphPlan.nbytes_by_family``).  When tracked bytes exceed
    ``budget_bytes`` the service evicts, cheapest-to-restore first:

    1. **result-cache entries**, LRU order — recomputing a query is the
       ordinary cache-miss path and costs one engine call;
    2. **plan families** of graphs with no in-flight batch, largest first —
       re-deriving sorted/blocked arrays is cheaper than an engine call but
       dearer than nothing, so these go only when the result cache alone
       cannot get under budget.

    The base CSR of a live graph (and the plan's eager sorted-edge arrays)
    is never evicted: it is the object the workspace serves, not a cache.
    """

    #: tracked-bytes ceiling (result cache + evictable plan members);
    #: None = unbounded, the pre-budget behavior
    budget_bytes: Optional[int] = None
    #: delta-ancestry links kept per live graph for retention/warm starts;
    #: ancestors beyond this are cut so a delta stream cannot pin every
    #: historical graph version (see ``Graph.prune_lineage``)
    max_lineage_depth: int = 4
    #: capacity of the provenance strong-pin ring for weakref-less objects
    max_provenance_pins: int = 4096

    def __post_init__(self):
        if self.budget_bytes is not None and self.budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0 or None, "
                             f"got {self.budget_bytes}")
        if self.max_lineage_depth < 1:
            raise ValueError(f"max_lineage_depth must be >= 1, "
                             f"got {self.max_lineage_depth}")
        if self.max_provenance_pins < 1:
            raise ValueError(f"max_provenance_pins must be >= 1, "
                             f"got {self.max_provenance_pins}")


@dataclass
class SchedulerPolicy:
    """Everything the request scheduler needs to make its decisions."""

    #: "fair" = deficit-round-robin across sessions; "fifo" = global
    #: arrival order (the baseline the overload benchmark measures against)
    mode: str = "fair"
    admission: AdmissionPolicy = field(default_factory=AdmissionPolicy)
    fair: FairSharePolicy = field(default_factory=FairSharePolicy)
    batch: BatchPolicy = field(default_factory=BatchPolicy)
    memory: MemoryPolicy = field(default_factory=MemoryPolicy)
    #: deadline applied to requests that don't carry their own
    #: ``"deadline_ms"``; None = requests never expire by default
    default_deadline_ms: Optional[float] = None

    def __post_init__(self):
        if self.mode not in ("fair", "fifo"):
            raise ValueError(f"unknown scheduler mode {self.mode!r}; "
                             f"expected 'fair' or 'fifo'")
