"""The serving plane on PyTorch (port of ``repro.serve``).

Token serving: ``ServingEngine`` schedules ``Request``s (continuous
batching, per-slot positions, mid-flight joins) over a ``ModelExecutor``
that runs a ``CausalLM`` on a device; ``ServeConfig`` sets its limits.
On the CPU: ``ServingEngine(cfg.reduced(), ServeConfig(...),
device="cpu")``; without ``device`` it runs on the GPU and raises where
there is none.

The matvec plane: ``SparseLinear`` wraps a compiled plan as a layer,
``PlanExecutor`` pads ragged batches to buckets and hot-swaps plans,
``SpmvEngine`` schedules requests.
"""
from .engine import (MatvecRequest, Request, ServeConfig,  # noqa: F401
                     ServingEngine, SpmvEngine)
from .executor import (ModelExecutor, PlanExecutor,  # noqa: F401
                       SwapRejected, decode_buckets)
from .sparse_linear import (SparseLinear, prune_magnitude,  # noqa: F401
                            sparsify_linear, sparsify_linear_sharded)

__all__ = ["ServeConfig", "Request", "ServingEngine", "ModelExecutor",
           "MatvecRequest", "SpmvEngine", "PlanExecutor", "SwapRejected",
           "decode_buckets", "SparseLinear", "prune_magnitude",
           "sparsify_linear", "sparsify_linear_sharded"]
