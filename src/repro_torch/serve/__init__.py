"""The matvec serving plane on PyTorch (port of ``repro.serve``).

``SparseLinear`` wraps a compiled plan as a layer, ``PlanExecutor`` pads
ragged batches to buckets and hot-swaps plans, ``SpmvEngine`` schedules
requests. The token-serving half of the reference (``ModelExecutor``,
``ServingEngine``, ``Request``, ``ServeConfig``) waits for the LLM stack
(ROADMAP queue 1, item 13), and ``sparsify_linear_sharded`` for dist
(item 12).
"""
from .engine import MatvecRequest, SpmvEngine  # noqa: F401
from .executor import PlanExecutor, SwapRejected, decode_buckets  # noqa: F401
from .sparse_linear import (SparseLinear, prune_magnitude,  # noqa: F401
                            sparsify_linear)

__all__ = ["MatvecRequest", "SpmvEngine", "PlanExecutor", "SwapRejected",
           "decode_buckets", "SparseLinear", "prune_magnitude",
           "sparsify_linear"]
