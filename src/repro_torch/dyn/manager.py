"""DynamicSparsityManager: the dyn control loop, end to end (port of
``repro.dyn.manager``).

One manager owns one live plan lineage and its matrix. Every
:meth:`apply` takes a :class:`~repro_torch.dyn.delta.PatternDelta` and either

* **patches in place** (O(delta), same kernels) and pushes the new plan to
  an attached ``PlanExecutor`` so serving stays exact, or
* **defers** it (out of capacity): the old plan keeps serving its old
  pattern while an urgent background re-search compiles the target
  pattern, or
* additionally **escalates to a drift re-search** when the live pattern's
  statistics (``DriftPolicy``) have walked too far from the plan's birth
  statistics — the patched plan stays exact, it just probably stopped
  being the format the search would design today.

Re-searches run on a daemon thread through the public
``repro_torch.compile(matrix, target, deadline_s=..., warm_start=[graph])``
path (per-candidate deadlines are cooperative monotonic checkpoints, so
they fire on the daemon thread too). The search shares the card with
the serving thread's launches, so its candidate timings are noisier than
a search alone. A landed plan is adopted by
:meth:`poll` — catch-up patched when the pattern moved while searching —
then *published through the existing hot-swap admission gate*:
``PlanStore.put`` under the birth key wakes the serving ``PlanWatch``,
and ``PlanExecutor.maybe_reload`` admits it (version-checked +
oracle-spot-checked against the manager's current matrix).

Watchdog: a failed or silently-dead re-search thread is no longer
invisible. The failure traceback lands in ``stats()["last_error"]``, the
owner-thread pump (:meth:`watchdog_tick`, called from :meth:`poll` and
from an attached executor's ``maybe_reload``) restarts the search with
exponential backoff, and after ``max_research_strikes`` consecutive
failures the manager stops retrying and escalates to the ``ft`` health
machine (``report_component("dyn-research", healthy=False)``) instead of
going dark.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Optional

from repro_torch.core.matrices import SparseMatrix

from .delta import PatternDelta, same_pattern
from .drift import DriftPolicy, pattern_stats
from .update import CapacityError, PlanPatcher

__all__ = ["DynamicSparsityManager"]


class DynamicSparsityManager:
    """Patch-in-place + drift-triggered background re-search for one plan.

    Thread model: :meth:`apply` and :meth:`poll` are called from the
    owner's (serving) thread; the re-search runs on a daemon thread and
    only hands its result back under the manager lock. The attached
    executor/store are only touched from the owner's thread.
    """

    def __init__(self, matrix: SparseMatrix, plan, *,
                 policy: Optional[DriftPolicy] = None,
                 executor=None, store=None,
                 store_budget=None, store_graph=None, store_strategy=None,
                 research_budget=None, research_deadline_s: float = 20.0,
                 ft=None, max_research_strikes: int = 3,
                 research_backoff_s: float = 0.5):
        self.matrix = matrix.canonical()    # pattern the live plan encodes
        self.birth_matrix = self.matrix     # the store/watch key
        self.plan = plan
        self.policy = policy or DriftPolicy()
        self.executor = executor
        self.store = store
        # key args the serving watch was created with — publications must
        # land on the same store entry to wake it
        self._store_key = (store_budget, store_graph, store_strategy)
        self.research_budget = research_budget
        self.research_deadline_s = research_deadline_s
        # watchdog policy: restart a failed re-search with exponential
        # backoff; after max_research_strikes consecutive failures stop
        # retrying and escalate to the ft health machine (if attached)
        self.ft = ft
        self.max_research_strikes = max_research_strikes
        self.research_backoff_s = research_backoff_s

        self.birth_stats = pattern_stats(self.matrix)
        self._patcher = PlanPatcher(plan)
        self.pending_matrix: Optional[SparseMatrix] = None
        self._landed = None                 # (snapshot_matrix, plan)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.RLock()

        self.updates_applied = 0
        self.deferred = 0
        self.out_of_capacity = 0
        self.drift_events = 0
        self.researches_started = 0
        self.researches_landed = 0
        self.researches_failed = 0
        self.last_drift = None
        self.last_research_reason = None
        # -- watchdog state --
        self.last_error: Optional[str] = None   # traceback of last failure
        self.research_strikes = 0               # consecutive failures
        self.research_dead = False              # struck out; escalated
        self.watchdog_restarts = 0
        self._retry_pending = None              # (snapshot, reason) | None
        self._retry_at: Optional[float] = None  # monotonic restart time
        self._research_outcome: Optional[str] = None  # None while running
        self._current_research = None           # (snapshot, reason) | None

        if executor is not None and hasattr(executor,
                                            "attach_research_monitor"):
            executor.attach_research_monitor(self)

    # -- views -------------------------------------------------------------
    @property
    def target_matrix(self) -> SparseMatrix:
        """The pattern the system is converging to: the deferred target
        while serving stale, else the live matrix."""
        return (self.pending_matrix if self.pending_matrix is not None
                else self.matrix)

    def research_active(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for an active re-search thread; True when none remains."""
        t = self._thread
        if t is not None:
            t.join(timeout)
        return not self.research_active()

    def quiesce(self, timeout: float = 60.0) -> bool:
        """Drain all background work: join + adopt until nothing remains.

        A catch-up restart inside :meth:`poll` can spawn a follow-on
        search, so one join+poll is not always enough. Call this before
        tearing the manager down — a daemon thread still inside a
        compile at interpreter exit crashes the process."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.join(timeout=max(deadline - time.monotonic(), 0.0))
            self.poll()
            with self._lock:
                if (not self.research_active() and self._landed is None
                        and self._retry_pending is None):
                    return True
            time.sleep(0.01)   # a backoff retry is armed; let it fire
        return False

    # -- the control loop --------------------------------------------------
    def apply(self, delta: PatternDelta) -> dict:
        """Route one mutation; returns ``{"action": ..., ...}``."""
        with self._lock:
            if delta.is_empty:
                return {"action": "noop"}
            if self.pending_matrix is not None:
                # already serving stale: fold into the re-search target
                self.pending_matrix = delta.apply_to(self.pending_matrix)
                self.deferred += 1
                return {"action": "deferred"}
            try:
                new_plan = self._patcher.apply(delta)
            except CapacityError as e:
                self.pending_matrix = delta.apply_to(self.matrix)
                self.out_of_capacity += 1
                self._start_research(self.pending_matrix,
                                     f"out_of_capacity: {e}")
                return {"action": "research", "reason": str(e)}
            self.matrix = delta.apply_to(self.matrix)
            self.plan = new_plan
            self.updates_applied += 1
            if self.executor is not None:
                self.executor.apply_update(new_plan, self.matrix)
            report = self.policy.assess(self.birth_stats,
                                        pattern_stats(self.matrix))
            self.last_drift = report
            if report.drifted and not self.research_active() \
                    and self._landed is None:
                self.drift_events += 1
                self._start_research(
                    self.matrix, "drift: " + "; ".join(report.reasons))
                return {"action": "update+research", "drift": report}
            return {"action": "update", "drift": report}

    def poll(self) -> Optional[dict]:
        """Adopt a landed re-search, if any (owner-thread only).

        The landed plan is catch-up patched when the pattern advanced
        past the research snapshot (restarting the search when the gap
        itself is out of capacity), version-bumped past the live plan,
        adopted as the new lineage, and published: ``PlanStore.put``
        under the birth key (waking the serving watch) and/or a direct
        ``PlanExecutor.swap_plan`` when no store is attached.
        """
        self.watchdog_tick()
        with self._lock:
            if self._landed is None:
                return None
            snapshot, plan = self._landed
            self._landed = None
            target = self.target_matrix
            if not same_pattern(snapshot, target):
                gap = PatternDelta.from_matrices(snapshot, target)
                try:
                    plan = PlanPatcher(plan).apply(gap)
                except CapacityError:
                    self._start_research(target, "catch_up")
                    return {"action": "research_restart"}
            plan = dataclasses.replace(
                plan, plan_version=int(getattr(self.plan, "plan_version", 0))
                + 1)
            self.researches_landed += 1
            # a landing clears the strike count: the watchdog policy is
            # about *consecutive* failures, and the component is healthy
            if self.research_strikes or self.research_dead:
                self.research_strikes = 0
                self.research_dead = False
                self._retry_pending = None
                if self.ft is not None:
                    self.ft.report_component("dyn-research", healthy=True)
            self.plan = plan
            self.matrix = target
            self.pending_matrix = None
            self._patcher = PlanPatcher(plan)
            # re-anchor the drift baseline on the pattern this plan was
            # actually designed for
            self.birth_stats = pattern_stats(target)
            self.last_drift = None
            if self.executor is not None:
                # admission for the incoming swap must judge against the
                # pattern it encodes
                self.executor.set_reference_matrix(target)
            published = False
            if self.store is not None:
                budget, graph, strategy = self._store_key
                self.store.put(self.birth_matrix, plan.target, budget,
                               graph, plan, strategy=strategy)
                published = True
            elif self.executor is not None:
                self.executor.swap_plan(plan)
                published = True
            return {"action": "adopted", "published": published,
                    "plan_version": plan.plan_version}

    # -- background re-search ----------------------------------------------
    def _start_research(self, snapshot: SparseMatrix, reason: str) -> None:
        if self.research_active() or self.research_dead:
            return
        self.researches_started += 1
        self.last_research_reason = reason
        self._research_outcome = None
        self._current_research = (snapshot, reason)
        graph = getattr(self.plan, "graph", None)
        warm = (graph,) if graph is not None else None
        target = self.plan.target
        budget = self.research_budget
        deadline = self.research_deadline_s

        def work():
            from repro_torch.api import compile as _compile  # lazy: no cycle
            try:
                plan = _compile(snapshot, target, budget,
                                warm_start=warm, deadline_s=deadline)
            except Exception:
                # (a CUDA error raised on this thread is a RuntimeError and
                # lands here like any other failure)
                # the traceback must be observable even before the
                # watchdog acts: a dead background search that looks like
                # a slow one is the failure mode this exists to kill
                tb = traceback.format_exc()
                with self._lock:
                    self.researches_failed += 1
                    self.last_error = tb
                    self._research_outcome = "failed"
                    self._schedule_retry_locked(snapshot, reason)
                return
            with self._lock:
                self._research_outcome = "landed"
                self._landed = (snapshot, plan)

        t = threading.Thread(target=work, name="repro-torch-dyn-research",
                             daemon=True)
        self._thread = t
        t.start()

    def _schedule_retry_locked(self, snapshot, reason) -> None:
        """Strike accounting + restart scheduling (call with lock held).

        Strike < limit: arm a backoff-delayed retry for the owner-thread
        pump. Strike == limit: stop retrying (research_dead) and escalate
        to the ft health machine so the degradation is fleet-visible."""
        self.research_strikes += 1
        if self.research_strikes >= self.max_research_strikes:
            self.research_dead = True
            self._retry_pending = None
            self._retry_at = None
            if self.ft is not None:
                self.ft.report_component("dyn-research", healthy=False,
                                         error=self.last_error)
            return
        delay = self.research_backoff_s * (2 ** (self.research_strikes - 1))
        self._retry_at = time.monotonic() + delay
        self._retry_pending = (snapshot, reason)

    def watchdog_tick(self) -> Optional[dict]:
        """Owner-thread watchdog pump: detect a silently-dead re-search
        thread and fire any due backoff restart. Called from :meth:`poll`
        and from ``PlanExecutor.maybe_reload`` via the attached monitor,
        so a serving loop keeps the watchdog beating for free."""
        with self._lock:
            t = self._thread
            if (t is not None and not t.is_alive()
                    and self._research_outcome is None):
                # the thread died without reporting (killed, or an exit
                # path outside the try) — record it as a failure
                self.researches_failed += 1
                self.last_error = ("re-search thread died without "
                                   "reporting an outcome")
                self._research_outcome = "failed"
                if self._current_research is not None:
                    self._schedule_retry_locked(*self._current_research)
            if (self._retry_pending is not None
                    and not self.research_active()
                    and self._landed is None
                    and time.monotonic() >= (self._retry_at or 0.0)):
                snapshot, reason = self._retry_pending
                self._retry_pending = None
                self._retry_at = None
                self.watchdog_restarts += 1
                self._start_research(snapshot,
                                     f"{reason} (watchdog retry "
                                     f"{self.research_strikes})")
                return {"action": "research_restarted",
                        "strikes": self.research_strikes}
        return None

    # -- reporting ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {"updates_applied": self.updates_applied,
                    "deferred": self.deferred,
                    "out_of_capacity": self.out_of_capacity,
                    "drift_events": self.drift_events,
                    "researches_started": self.researches_started,
                    "researches_landed": self.researches_landed,
                    "researches_failed": self.researches_failed,
                    "research_active": self.research_active(),
                    "plan_version": int(getattr(self.plan,
                                                "plan_version", 0)),
                    "serving_stale": self.pending_matrix is not None,
                    "last_research_reason": self.last_research_reason,
                    "last_error": self.last_error,
                    "research_strikes": self.research_strikes,
                    "research_dead": self.research_dead,
                    "watchdog_restarts": self.watchdog_restarts,
                    "retry_pending": self._retry_pending is not None}
