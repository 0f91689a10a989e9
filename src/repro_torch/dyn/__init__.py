"""repro_torch.dyn — incremental recompilation for dynamic sparsity (port
of ``repro.dyn``).

The pattern changes; the machine-designed format survives as long as it
can. Three layers:

* :class:`PatternDelta` — added/removed/revalued nonzeros between two
  ``SparseMatrix`` states (from matrices or prune masks).
* capacity + patching — :func:`capacity_report`/:func:`check_capacity`
  prove a delta fits the plan's packed tensors in place;
  :func:`update_plan` / :class:`PlanPatcher` (the ``SpmvPlan.update``
  backend) patch vals/cols into new tensors under the same kernel spec,
  so the patched plan runs the same kernels through the same dispatch.
* :class:`DriftPolicy` + :class:`DynamicSparsityManager` — statistical
  drift of the live pattern escalates to a background re-search
  published through the ``PlanStore``/``PlanExecutor`` hot-swap
  admission gate.
"""
from .capacity import capacity_lines, capacity_report  # noqa: F401
from .delta import PatternDelta, same_pattern  # noqa: F401
from .drift import DriftPolicy, DriftReport, pattern_stats  # noqa: F401
from .manager import DynamicSparsityManager  # noqa: F401
from .update import (CapacityCheck, CapacityError,  # noqa: F401
                     PlanPatcher, check_capacity, update_plan)

__all__ = [
    "PatternDelta", "same_pattern",
    "capacity_report", "capacity_lines",
    "CapacityError", "CapacityCheck", "PlanPatcher", "check_capacity",
    "update_plan",
    "DriftPolicy", "DriftReport", "pattern_stats",
    "DynamicSparsityManager",
]
