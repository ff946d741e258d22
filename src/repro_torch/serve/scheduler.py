"""Load-aware request scheduler for the interactive service.

The queue between :class:`~repro_torch.serve.graph_service.GraphService` and the
engine — and, per the ROADMAP, the seam where a wire protocol attaches for
cross-process serving later.  Everything that decides *when* and *in what
order* a declarative request reaches the engine lives here; everything that
decides *what the request computes* (input resolution, result cache, fusion
semantics, provenance) stays in the service, which hands this module an
already-prepared :class:`QueuedRequest` and exposes three callbacks
(`_cache_lookup`, `_finish_cached`, `_run_group`).

Three mechanisms, configured by :class:`~repro_torch.serve.policy.SchedulerPolicy`:

* **Admission control** — :meth:`Scheduler.submit` rejects a request whose
  session is at its in-flight quota, or when the global backlog hits the
  queue-depth bound, raising :class:`~repro_torch.serve.policy.RejectedError` with
  a ``retry_after`` derived from the EMA of observed per-request engine
  time.  Requests carrying a deadline are dropped at dispatch (never
  reaching the engine) once it has passed.
* **Fair share** — deficit round robin across sessions, denominated in
  *measured engine milliseconds*.  Each pick tops every waiting session up
  by ``quantum_ms * weight`` and serves the first session in rotation whose
  deficit is in credit; executed work is charged back at its actual cost
  (a coalesced batch splits its cost across the member requests'
  sessions).  A session that recently burned lots of engine time is deep in
  debt and waits it out, so a scan-heavy flood cannot starve interactive
  sessions — yet with the machine otherwise idle the flood runs at full
  speed (top-ups fast-forward when nobody else is waiting; the scheduler is
  work-conserving).
* **Batching windows** — when the popped request is coalescible, compatible
  requests are gathered from *every* session's queue into one engine call.
  In the worker loop (``allow_wait=True``) a loaded scheduler additionally
  holds the batch open for a bounded window so near-simultaneous arrivals
  coalesce too; the window scales with backlog and is exactly zero when the
  queue is empty, leaving idle latency untouched.

Synchronous use (:meth:`drain`, what ``GraphService.flush`` calls) runs the
same decision loop inline with windows disabled — everything fusable is
already queued, so waiting could only lose.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

from .. import obs
from .policy import DeadlineExpired, RejectedError, SchedulerPolicy

__all__ = ["QueuedRequest", "Scheduler"]

# scheduler-level instruments: admission outcomes, backlog depth, the
# queued-vs-engine split every request pays, and batch composition
_C_ADMIT = obs.counter("sched.admitted")
_C_REJECT = obs.counter("sched.rejected")
_C_EXPIRE = obs.counter("sched.expired")
_C_WINDOWS = obs.counter("sched.batch_windows")
_G_DEPTH = obs.gauge("sched.queue_depth")
_H_QUEUED = obs.histogram("sched.queued_ms")
_H_ENGINE = obs.histogram("sched.engine_ms")
_H_BATCH = obs.histogram("sched.batch_size", buckets=obs.COUNT_BUCKETS)


@dataclass
class QueuedRequest:
    """A prepared request waiting for dispatch.

    The service resolves names, canonicalizes params and computes the fusion
    / cache keys at submit time (pinning the object versions the request
    names); the scheduler only ever compares keys and moves these records
    between queues.
    """

    pending: Any                      # graph_service.Pending
    session: str
    op: str
    cache_key: Optional[Tuple] = None
    fuse_key: Optional[Tuple] = None  # None: never coalesced
    payload: Dict[str, Any] = field(default_factory=dict)
    deadline: Optional[float] = None  # absolute perf_counter seconds
    seq: int = 0                      # global arrival order (FIFO mode)


class _SessionState:
    """Queue + deficit + accounting for one session."""

    __slots__ = ("name", "queue", "inflight", "deficit_ms", "recent_ms",
                 "completed", "engine_ms", "rejected", "expired")

    def __init__(self, name: str):
        self.name = name
        self.queue: Deque[QueuedRequest] = deque()
        self.inflight = 0          # queued + executing, admission-bounded
        self.deficit_ms = 0.0      # DRR credit (+) / debt (-)
        self.recent_ms = 0.0       # decayed engine-ms consumption
        self.completed = 0
        self.engine_ms = 0.0
        self.rejected = 0
        self.expired = 0

    def snapshot(self) -> Dict[str, Any]:
        return {"queued": len(self.queue), "inflight": self.inflight,
                "deficit_ms": round(self.deficit_ms, 3),
                "recent_ms": round(self.recent_ms, 3),
                "completed": self.completed,
                "engine_ms": round(self.engine_ms, 3),
                "rejected": self.rejected, "expired": self.expired}


class Scheduler:
    """Admission, ordering and coalescing between submit and the engine."""

    def __init__(self, service: Any, policy: SchedulerPolicy):
        self.service = service
        self.policy = policy
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._sessions: Dict[str, _SessionState] = {}
        self._order: List[str] = []       # session insertion order (RR ring)
        self._ended: set = set()          # forgotten-while-busy, reap later
        self._rr_last: Optional[str] = None
        self._seq = 0
        self._total_queued = 0
        self._est_ms = 50.0               # EMA of per-request engine ms

    # -- introspection ------------------------------------------------------
    def _state(self, name: str) -> _SessionState:
        st = self._sessions.get(name)
        if st is None:
            st = self._sessions[name] = _SessionState(name)
            self._order.append(name)
        return st

    def queued_count(self, session: Optional[str] = None) -> int:
        with self._lock:
            if session is None:
                return self._total_queued
            st = self._sessions.get(session)
            return len(st.queue) if st else 0

    def session_stats(self, session: str) -> Dict[str, Any]:
        """Accounting snapshot; never *creates* state (an unknown name —
        e.g. a remote client probing — must not grow the DRR ring)."""
        with self._lock:
            st = self._sessions.get(session)
            return st.snapshot() if st is not None \
                else _SessionState(session).snapshot()

    def forget_session(self, session: str) -> bool:
        """Drop a session's scheduler state (connection teardown).

        Returns False while the session still has queued or executing work
        — accounting for in-flight requests must survive until
        :meth:`_done` runs for them; the state is marked ended and reaped
        by the final :meth:`_done` instead, so churned connections never
        leak ring entries.
        """
        with self._lock:
            return self._forget_locked(session, mark=True)

    def _forget_locked(self, session: str, mark: bool = False) -> bool:
        st = self._sessions.get(session)
        if st is None:
            self._ended.discard(session)
            return True
        if st.queue or st.inflight:
            if mark:
                self._ended.add(session)
            return False
        del self._sessions[session]
        self._order.remove(session)
        self._ended.discard(session)
        if self._rr_last == session:
            self._rr_last = None
        return True

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until nothing is queued *or executing*; False on timeout.

        :meth:`drain` only runs queued work inline — in worker mode a
        request may be mid-engine on another thread when the queue empties.
        Graceful server shutdown needs both gone before closing sockets,
        so streamed results are never cut off.
        """
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        with self._cond:
            while True:
                busy = self._total_queued or any(
                    st.inflight for st in self._sessions.values())
                if not busy:
                    return True
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=0.1 if remaining is None
                                else min(remaining, 0.1))

    # -- admission ----------------------------------------------------------
    def submit(self, q: QueuedRequest) -> None:
        """Enqueue or reject; rejection raises before the queue is touched."""
        adm = self.policy.admission
        # opt-in SLO shedding: while the op (or the service overall) is
        # breaching its burn-rate threshold, tighten both admission bounds
        # so backlog drains instead of growing — observability closing the
        # loop into serving.  should_shed() is a cached verdict read, not a
        # health computation, so the common healthy case stays cheap.
        shed = adm.slo_shed and obs.SLO.should_shed(q.op)
        quota = adm.quota_for(q.session)
        depth_bound = adm.max_queue_depth
        if shed:
            quota = max(1, int(quota * adm.shed_factor))
            depth_bound = max(1, int(depth_bound * adm.shed_factor))
        with self._cond:
            st = self._state(q.session)
            if st.inflight >= quota:
                st.rejected += 1
                retry = max(adm.min_retry_after_s,
                            st.inflight * self._est_ms / 1e3)
                self._reject(q, "slo_shed" if shed else "quota", retry)
                raise RejectedError(
                    f"session {q.session!r} is at its in-flight quota "
                    f"({quota})" + (" [slo shedding active]" if shed
                                    else ""), retry)
            if self._total_queued >= depth_bound:
                st.rejected += 1
                retry = max(adm.min_retry_after_s,
                            self._total_queued * self._est_ms / 1e3)
                self._reject(q, "slo_shed" if shed else "queue_depth",
                             retry)
                raise RejectedError(
                    f"service backlog is at its queue-depth bound "
                    f"({depth_bound})" + (" [slo shedding active]" if shed
                                          else ""), retry)
            q.seq = self._seq
            self._seq += 1
            st.inflight += 1
            st.queue.append(q)
            self._total_queued += 1
            _C_ADMIT.inc()
            _G_DEPTH.set(self._total_queued)
            self._cond.notify_all()

    def _reject(self, q: QueuedRequest, reason: str, retry: float) -> None:
        """Admission-reject accounting: service counter + trace instant."""
        self.service._bump("rejected")
        _C_REJECT.inc()
        obs.TRACER.instant("sched.reject", trace=q.pending.trace,
                           op=q.op, session=q.session, reason=reason,
                           retry_after=round(retry, 3))

    # -- selection ----------------------------------------------------------
    def _waiting_locked(self) -> List[_SessionState]:
        return [self._sessions[n] for n in self._order
                if self._sessions[n].queue]

    def _pick_locked(self) -> Optional[QueuedRequest]:
        waiting = self._waiting_locked()
        if not waiting:
            return None
        if self.policy.mode == "fifo":
            st = min(waiting, key=lambda s: s.queue[0].seq)
        else:
            st = self._pick_fair_locked(waiting)
        q = st.queue.popleft()
        self._total_queued -= 1
        _G_DEPTH.set(self._total_queued)
        self._rr_last = st.name
        return q

    def _pick_fair_locked(self, waiting: List[_SessionState]) -> _SessionState:
        """Deficit round robin over the sessions that have queued work."""
        fair = self.policy.fair
        names = [s.name for s in waiting]
        if self._rr_last in names:         # resume rotation after last pick
            i = names.index(self._rr_last)
            waiting = waiting[i + 1:] + waiting[:i + 1]
        # one top-up per pick (≈ one DRR visit of every waiting session)...
        for s in waiting:
            w = max(fair.weight_for(s.name), 1e-6)
            s.deficit_ms = min(s.deficit_ms + fair.quantum_ms * w,
                               fair.burst_ms)
        for s in waiting:
            if s.deficit_ms > 0:
                return s
        # ...and when every session is in debt (nothing dispatchable), fast-
        # forward the idle top-up rounds in closed form instead of spinning:
        # the scheduler stays work-conserving without a busy loop.
        passes = []
        for s in waiting:
            w = max(fair.weight_for(s.name), 1e-6)
            passes.append(int(-s.deficit_ms // (fair.quantum_ms * w)) + 1)
        k = max(1, min(passes))
        for s in waiting:
            w = max(fair.weight_for(s.name), 1e-6)
            s.deficit_ms = min(s.deficit_ms + k * fair.quantum_ms * w,
                               fair.burst_ms)
        for s in waiting:
            if s.deficit_ms > 0:
                return s
        return waiting[0]                  # float-fuzz fallback

    # -- coalescing ---------------------------------------------------------
    def _collect_locked(self, q: QueuedRequest, cap: int
                        ) -> List[QueuedRequest]:
        """Pull every queued request sharing ``q.fuse_key`` (up to cap)."""
        out: List[QueuedRequest] = []
        for name in self._order:
            st = self._sessions[name]
            if not st.queue:
                continue
            kept: Deque[QueuedRequest] = deque()
            while st.queue:
                item = st.queue.popleft()
                if len(out) < cap and item.fuse_key == q.fuse_key:
                    out.append(item)
                    self._total_queued -= 1
                else:
                    kept.append(item)
            st.queue = kept
        if out:
            with self._lock:
                _G_DEPTH.set(self._total_queued)
        return out

    def _gather(self, q: QueuedRequest, allow_wait: bool
                ) -> List[QueuedRequest]:
        """Coalesce compatible requests; optionally hold a batching window.

        The window only opens from the worker loop (``allow_wait``) and only
        under load: with an empty residual queue it is zero, so an idle
        single request executes immediately.  Synchronous drains never wait
        — every coalescible request is already queued.
        """
        bp = self.policy.batch
        group = [q]
        with self._cond:
            group += self._collect_locked(q, bp.max_batch - len(group))
            if allow_wait and len(group) < bp.max_batch:
                window = bp.effective_window_s(self._total_queued)
                if window > 0:
                    self.service._bump("batch_windows")
                    _C_WINDOWS.inc()
                    deadline = time.perf_counter() + window
                    while True:
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0 or len(group) >= bp.max_batch:
                            break
                        self._cond.wait(timeout=remaining)
                        group += self._collect_locked(
                            q, bp.max_batch - len(group))
        return group

    # -- accounting ---------------------------------------------------------
    def _done(self, q: QueuedRequest, engine_ms: float,
              completed: bool = True) -> None:
        # every caller resolves q.pending before calling _done (cache hits,
        # group execution, error paths, expiry), so this is the single
        # completion seam: the flight recorder sees each request exactly
        # once with its final latency/outcome, feeds the SLO window, and
        # captures an exemplar if the request was slow, errored, or expired
        obs.FLIGHT.record_completion(q, engine_ms=engine_ms,
                                     expired=not completed)
        fair = self.policy.fair
        with self._cond:
            st = self._state(q.session)
            st.inflight -= 1
            if completed:            # expired drops resolve but don't count
                st.completed += 1
            st.engine_ms += engine_ms
            st.recent_ms = st.recent_ms * fair.decay + engine_ms
            if engine_ms > 0:
                st.deficit_ms = max(st.deficit_ms - engine_ms, -fair.floor_ms)
                self._est_ms = 0.8 * self._est_ms + 0.2 * engine_ms
            if q.session in self._ended:   # connection gone: reap when idle
                self._forget_locked(q.session)
            self._cond.notify_all()

    def _expire(self, q: QueuedRequest) -> None:
        with self._lock:
            self._state(q.session).expired += 1
        self.service._bump("expired")
        _C_EXPIRE.inc()
        obs.TRACER.instant("sched.expired", trace=q.pending.trace,
                           op=q.op, session=q.session)
        q.pending._resolve(error=DeadlineExpired(
            f"request {q.op!r} from session {q.session!r} spent its "
            f"deadline in the queue; dropped before execution"))
        self._done(q, 0.0, completed=False)

    # -- the decision loop --------------------------------------------------
    def step(self, *, allow_wait: bool = False) -> bool:
        """Dispatch one scheduling decision; False when nothing is queued.

        One decision is one of: an expired request dropped, a cache hit
        served, or one engine call (single request or coalesced batch).
        """
        with self._cond:
            q = self._pick_locked()
        if q is None:
            return False
        self._process(q, allow_wait)
        return True

    def _process(self, q: QueuedRequest, allow_wait: bool) -> None:
        now = time.perf_counter()
        if q.deadline is not None and now > q.deadline:
            self._expire(q)
            return
        q.pending.dispatched_at = now
        self._queued_span(q)
        hit, found = self.service._cache_lookup(q)
        if found:
            self.service._finish_cached(q, hit)
            self._done(q, 0.0)
            return
        group = [q]
        if q.fuse_key is not None:
            group = self._filter_group(self._gather(q, allow_wait))
        if not group:
            return                       # every member expired or hit cache
        _H_BATCH.observe(len(group))
        with self._lock:                 # DRR state that won this pick
            deficit_ms = round(self._state(q.session).deficit_ms, 3)
        t0 = time.perf_counter()
        sp = obs.TRACER.span(
            "sched.execute", trace=q.pending.trace,
            traces=[m.pending.trace for m in group
                    if m.pending.trace is not None],
            op=q.op, batch=len(group),
            sessions=sorted({m.session for m in group}),
            deficit_ms=deficit_ms)
        # memory-manager bracket: the group's graphs are pinned against plan
        # eviction while the engine call is in flight (an evicted member
        # re-derives transparently, but never out from under a running
        # batch); the end hook runs the accounting/eviction pass.
        self.service._mem_begin(group)
        try:
            with sp:
                engine_ms = self.service._run_group(group)
                sp.set(engine_ms=round(engine_ms, 3))
        except Exception as e:           # resolve, don't poison the loop
            engine_ms = (time.perf_counter() - t0) * 1e3
            for m in group:
                if not m.pending.done:
                    m.pending._resolve(error=e)
        finally:
            self.service._mem_end(group)
        _H_ENGINE.observe(engine_ms)
        for m in group:
            self._done(m, engine_ms / max(len(group), 1))

    def _queued_span(self, q: QueuedRequest) -> None:
        """Record the dispatch wait retroactively from the two stamps the
        Pending already keeps (submit happened on another thread)."""
        p = q.pending
        if p.dispatched_at is None:
            return
        _H_QUEUED.observe((p.dispatched_at - p.submitted_at) * 1e3)
        obs.TRACER.add_complete("sched.queued", p.submitted_at,
                                p.dispatched_at, trace=p.trace, op=q.op,
                                session=q.session)

    def _filter_group(self, group: List[QueuedRequest]
                      ) -> List[QueuedRequest]:
        """Deadline + cache screening for gathered batch members."""
        now = time.perf_counter()
        out = []
        for m in group:
            if m.deadline is not None and now > m.deadline:
                self._expire(m)
                continue
            if m is not group[0]:
                m.pending.dispatched_at = now
                self._queued_span(m)
                hit, found = self.service._cache_lookup(m)
                if found:
                    self.service._finish_cached(m, hit)
                    self._done(m, 0.0)
                    continue
            out.append(m)
        return out

    def drain(self) -> None:
        """Run queued work to completion, inline, windows closed."""
        while self.step(allow_wait=False):
            pass

    def run_loop(self, stop: threading.Event) -> None:
        """Worker loop: serve until ``stop`` is set, sleeping when idle."""
        while not stop.is_set():
            if not self.step(allow_wait=True):
                with self._cond:
                    if self._total_queued == 0 and not stop.is_set():
                        self._cond.wait(timeout=0.02)
