"""Dynamic magnitude pruning over a live compiled plan (port of
``repro.train.dynamic``; drives ``repro_torch.dyn``).

The train-a-sparse-LLM scenario the ROADMAP contracts for: a weight
matrix evolves under training updates, magnitude pruning re-selects the
top-k pattern every step, and instead of paying a full ``compile``
per step the serving plan is *patched in place* while the mutation fits
its capacity; statistical drift escalates to a background re-search
(``DynamicSparsityManager``).

``run_pruning_loop`` is both the train/ integration point and a
self-contained simulation (random walk standing in for gradient noise)
used by the tests and ``chip_smoke.py``. Compile with
``capacity_graph()`` — a ``LANE_PAD``-provisioned ELL design — so lanes
carry slack for pattern churn; an unpadded design still works, it just
defers more mutations to re-searches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.graph import OperatorGraph
from repro_torch.design.registry import OpSpec
from repro_torch.dyn import DynamicSparsityManager, PatternDelta
from repro_torch.serve.sparse_linear import prune_magnitude

__all__ = ["capacity_graph", "run_pruning_loop", "PruningLoopReport"]


def capacity_graph(rows: int = 8, pad_to: int = 8) -> OperatorGraph:
    """An ELL design with built-in update headroom.

    ``LANE_PAD`` rounds every tile width up to a multiple of ``pad_to``,
    so most lanes carry free slots — the capacity the in-place updater
    spends when pruning moves an entry into a row that was previously at
    its width."""
    return OperatorGraph.chain(
        OpSpec.make("COMPRESS"),
        OpSpec.make("TILE_ROW_BLOCK", rows=rows),
        OpSpec.make("SORT_TILE", window=rows),
        OpSpec.make("LANE_PAD", pad_to=pad_to),
        OpSpec.make("LANE_ROW_BLOCK"),
        OpSpec.make("LANE_TOTAL_RED", combine="scatter"))


@dataclasses.dataclass
class PruningLoopReport:
    steps: int
    updates_applied: int
    deferred: int
    out_of_capacity: int
    researches_started: int
    researches_landed: int
    oracle_max_rel_err: float
    history: list                   # per-step manager actions
    manager: DynamicSparsityManager


def run_pruning_loop(w: np.ndarray, density: float, n_steps: int, *,
                     manager: Optional[DynamicSparsityManager] = None,
                     lr: float = 0.01, seed: int = 0,
                     check_every: int = 1) -> PruningLoopReport:
    """Simulated training loop: perturb -> re-prune -> patch in place.

    When no ``manager`` is given, one is built from a capacity-provisioned
    compile of the initial pruned pattern on the default ``Target()``
    (the GPU; pass a manager built on ``Target(backend="torch")`` to run
    on the CPU). Every
    ``check_every`` steps the *served* plan is verified against the dense
    oracle of the matrix the manager says it encodes — the loop's whole
    claim is that in-place patching never trades away exactness.
    """
    rng = np.random.default_rng(seed)
    w = np.array(w, np.float32)
    if manager is None:
        from repro_torch.api import Target, compile as _compile
        from repro_torch.core.search import SearchConfig
        m0 = prune_magnitude(w, density)
        plan = _compile(m0, Target(), graph=capacity_graph())
        # snappy re-searches: a pruning loop mutates every step, so a
        # long search would just pile deferrals behind it
        manager = DynamicSparsityManager(
            m0, plan,
            research_budget=SearchConfig(max_seconds=2, max_structures=2),
            research_deadline_s=8.0)
    history = []
    max_rel_err = 0.0
    for step in range(n_steps):
        w += lr * rng.standard_normal(w.shape).astype(np.float32)
        new_m = prune_magnitude(w, density)
        delta = PatternDelta.from_matrices(manager.target_matrix, new_m)
        out = manager.apply(delta)
        manager.poll()
        history.append(out["action"])
        if check_every and step % check_every == 0:
            x = rng.standard_normal(w.shape[1]).astype(np.float32)
            got = manager.plan(x).cpu().numpy().astype(np.float64)
            want = manager.matrix.spmv_dense_oracle(x)
            scale = float(np.abs(want).max()) + 1e-30
            err = float(np.abs(got - want).max()) / scale
            max_rel_err = max(max_rel_err, err)
    manager.quiesce(timeout=manager.research_deadline_s * 2 + 30.0)
    return PruningLoopReport(
        steps=n_steps,
        updates_applied=manager.updates_applied,
        deferred=manager.deferred,
        out_of_capacity=manager.out_of_capacity,
        researches_started=manager.researches_started,
        researches_landed=manager.researches_landed,
        oracle_max_rel_err=max_rel_err,
        history=history, manager=manager)
