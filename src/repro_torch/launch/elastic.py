"""Elastic / fault-tolerant coordination logic (see ``repro.launch.elastic``).

Pure, unit-testable decision logic for a 1000+-node deployment:

* **heartbeats** — workers report per-step wall time; a worker silent for
  ``dead_after`` seconds is declared dead;
* **straggler mitigation** — workers slower than ``straggler_factor × p50``
  over a sliding window are flagged; the planner first reroutes their data
  shards (skip-and-rebalance), then evicts persistent offenders;
* **re-mesh planning** — on a capacity change the planner picks the largest
  data-parallel degree that divides the surviving host count while keeping
  the model axis intact (TP groups must stay whole — a dead host kills its
  whole TP group), and signals a checkpoint-restore boundary.

The runtime side (launch/train.py) consumes plans: it checkpoints on
``plan.restart_required`` and restarts with ``plan.mesh_shape``.  The
coordinator is pure Python; the tests drive it with simulated heartbeats.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["ElasticCoordinator", "RemeshPlan"]


@dataclass
class RemeshPlan:
    restart_required: bool
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    dropped_workers: Tuple[int, ...] = ()
    reason: str = ""


@dataclass
class WorkerState:
    last_seen: Optional[float] = None   # None = never heard from
    step_times: List[float] = field(default_factory=list)
    flagged: int = 0


class ElasticCoordinator:
    """Tracks worker health; plans meshes for the survivors."""

    def __init__(self, n_workers: int, hosts_per_tp_group: int,
                 dead_after: float = 60.0, straggler_factor: float = 1.5,
                 window: int = 20, evict_after_flags: int = 3):
        self.n_workers = n_workers
        self.tp = hosts_per_tp_group
        self.dead_after = dead_after
        self.straggler_factor = straggler_factor
        self.window = window
        self.evict_after_flags = evict_after_flags
        self.workers: Dict[int, WorkerState] = {
            i: WorkerState() for i in range(n_workers)}

    # -- ingestion ---------------------------------------------------------
    def heartbeat(self, worker: int, step_time: float,
                  now: Optional[float] = None) -> None:
        w = self.workers.get(worker)
        if w is None:
            return
        w.last_seen = time.monotonic() if now is None else now
        w.step_times.append(step_time)
        if len(w.step_times) > self.window:
            w.step_times.pop(0)

    # -- analysis -----------------------------------------------------------
    def dead_workers(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [i for i, w in self.workers.items()
                if w.last_seen is not None
                and now - w.last_seen > self.dead_after]

    def stragglers(self) -> List[int]:
        med = self._median_step_time()
        if med is None:
            return []
        out = []
        for i, w in self.workers.items():
            if len(w.step_times) >= 3:
                mine = sorted(w.step_times)[len(w.step_times) // 2]
                if mine > self.straggler_factor * med:
                    w.flagged += 1
                    out.append(i)
        return out

    def _median_step_time(self) -> Optional[float]:
        all_t = [sorted(w.step_times)[len(w.step_times) // 2]
                 for w in self.workers.values() if len(w.step_times) >= 3]
        if not all_t:
            return None
        return sorted(all_t)[len(all_t) // 2]

    # -- planning -----------------------------------------------------------
    def plan(self, now: Optional[float] = None) -> RemeshPlan:
        dead = set(self.dead_workers(now))
        evict = {i for i, w in self.workers.items()
                 if w.flagged >= self.evict_after_flags}
        dropped = sorted(dead | evict)
        alive = self.n_workers - len(dropped)
        if not dropped:
            return RemeshPlan(False, self._shape(self.n_workers),
                              self._axes(), (), "healthy")
        # keep TP groups whole: a lost worker drops its whole group
        groups_lost = {d // self.tp for d in dropped}
        alive_groups = self.n_workers // self.tp - len(groups_lost)
        if alive_groups < 1:
            return RemeshPlan(True, (0,), ("data",), tuple(dropped),
                              "no surviving TP group")
        # largest power-of-two data degree that fits the surviving groups
        dp = 1
        while dp * 2 <= alive_groups:
            dp *= 2
        for d in dropped:
            self.workers.pop(d, None)
        self.n_workers = alive
        return RemeshPlan(True, (dp, self.tp), ("data", "model"),
                          tuple(dropped),
                          f"lost {len(dropped)} workers; dp -> {dp}")

    def _shape(self, n: int) -> Tuple[int, ...]:
        return (n // self.tp, self.tp)

    def _axes(self) -> Tuple[str, ...]:
        return ("data", "model")
