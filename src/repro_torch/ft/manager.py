"""Fault tolerance: heartbeats, straggler detection, restart policy.

Copy of ``repro.ft.manager`` (pure Python), kept in the port so that it
imports nothing of ``repro``. The serving engine (``repro_torch.serve``)
feeds it one heartbeat per scheduling step.

At 1000+ nodes the failure model is: (a) hard node loss — detected by
heartbeat timeout, handled by checkpoint/restart (optionally *elastic*:
restore onto fewer pods, the ckpt layout is mesh-agnostic); (b) stragglers
— detected by per-step-time z-score against an EWMA baseline, handled by
flagging the slow host for the scheduler to drain/replace (on TPU pods a
single slow chip gates every collective, so mitigation is replacement,
not work-stealing).

The manager is deliberately runtime-agnostic: the training driver reports
``heartbeat(node, step, step_time)`` and polls ``should_restart()`` /
``stragglers()``. Tests inject synthetic failures; on a real cluster the
same interface is fed from per-host agents.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

__all__ = ["ComponentHealth", "FaultToleranceConfig",
           "FaultToleranceManager", "NodeFailure", "StragglerReport"]


class NodeFailure(RuntimeError):
    """Raised (or injected in tests) when a node dies mid-step."""


@dataclasses.dataclass(frozen=True)
class StragglerReport:
    node: str
    step_time: float
    baseline: float
    z_score: float


@dataclasses.dataclass
class FaultToleranceConfig:
    heartbeat_timeout_s: float = 60.0
    straggler_z: float = 3.0          # z-score threshold
    straggler_min_ratio: float = 1.3  # and at least 30% slower than EWMA
    ewma_alpha: float = 0.1
    max_restarts: int = 10


@dataclasses.dataclass
class _NodeState:
    last_seen: float = 0.0
    ewma: Optional[float] = None
    var: float = 0.0


@dataclasses.dataclass(frozen=True)
class ComponentHealth:
    """Last reported health of one software component (vs. a *node*,
    which is hardware and heartbeat-tracked)."""
    name: str
    healthy: bool
    error: Optional[str]      # traceback / message when unhealthy
    since: float              # clock() of the report
    reports: int              # total reports for this component


class FaultToleranceManager:
    def __init__(self, cfg: FaultToleranceConfig = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg or FaultToleranceConfig()
        self.clock = clock
        self.nodes: dict[str, _NodeState] = {}
        self.restarts = 0
        self._straggler_log: list[StragglerReport] = []
        # software-component health (e.g. "dyn-research"): reporters may
        # live on background threads, so this map has its own lock
        self._components: dict[str, ComponentHealth] = {}
        self._component_lock = threading.Lock()

    # ------------------------------ inputs --------------------------------

    def register(self, node: str) -> None:
        self.nodes.setdefault(node, _NodeState(last_seen=self.clock()))

    def heartbeat(self, node: str, step: int, step_time: float) -> None:
        st = self.nodes.setdefault(node, _NodeState())
        st.last_seen = self.clock()
        a = self.cfg.ewma_alpha
        if st.ewma is None:
            st.ewma, st.var = step_time, 0.0
        else:
            delta = step_time - st.ewma
            st.ewma += a * delta
            st.var = (1 - a) * (st.var + a * delta * delta)

    def observe_step(self, node: str, step: int, step_time: float
                     ) -> Optional["StragglerReport"]:
        """One-call driver hook: straggler-check this step against the
        node's baseline *before* folding it into the EWMA (so a stuck
        step can't dilute the very baseline that should flag it), then
        record the heartbeat. Serving engines call this per scheduling
        step; the training driver per training step."""
        rep = self.check_straggler(node, step_time)
        self.heartbeat(node, step, step_time)
        return rep

    def report_component(self, name: str, healthy: bool,
                         error: Optional[str] = None) -> None:
        """Record a software component's health transition (thread-safe).

        The dyn watchdog escalates here after striking out on re-search
        restarts: a degraded component is fleet-visible the same way a
        dead node is, without conflating software state with hardware
        heartbeats."""
        with self._component_lock:
            prev = self._components.get(name)
            self._components[name] = ComponentHealth(
                name=name, healthy=healthy,
                error=None if healthy else error,
                since=self.clock(),
                reports=(prev.reports + 1) if prev else 1)

    def component_health(self) -> dict[str, ComponentHealth]:
        with self._component_lock:
            return dict(self._components)

    def degraded_components(self) -> list[str]:
        with self._component_lock:
            return sorted(n for n, c in self._components.items()
                          if not c.healthy)

    # ----------------------------- detection ------------------------------

    def dead_nodes(self) -> list[str]:
        now = self.clock()
        return [n for n, st in self.nodes.items()
                if now - st.last_seen > self.cfg.heartbeat_timeout_s]

    def check_straggler(self, node: str, step_time: float
                        ) -> Optional[StragglerReport]:
        st = self.nodes.get(node)
        if st is None or st.ewma is None or st.var <= 0:
            return None
        z = (step_time - st.ewma) / (st.var ** 0.5 + 1e-9)
        if z > self.cfg.straggler_z and \
                step_time > self.cfg.straggler_min_ratio * st.ewma:
            rep = StragglerReport(node, step_time, st.ewma, z)
            self._straggler_log.append(rep)
            return rep
        return None

    def stragglers(self) -> list[StragglerReport]:
        return list(self._straggler_log)

    # ------------------------------ policy ---------------------------------

    def should_restart(self) -> bool:
        return bool(self.dead_nodes()) and self.restarts < self.cfg.max_restarts

    def record_restart(self) -> None:
        self.restarts += 1
        for st in self.nodes.values():
            st.last_seen = self.clock()

    def elastic_plan(self, n_pods_alive: int, n_pods_total: int) -> dict:
        """Restart plan when pods are lost: shrink the pod (pure-DP) axis.
        The per-pod program is unchanged (DESIGN.md §6), so an elastic
        restart only re-shards the checkpoint onto the surviving mesh."""
        return {
            "mesh": ("pod", n_pods_alive) if n_pods_alive > 1 else None,
            "global_batch_scale": n_pods_alive / n_pods_total,
            "action": "reshard_restore",
        }
