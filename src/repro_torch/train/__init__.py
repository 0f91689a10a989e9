"""Training (port of ``repro.train``): AdamW, gradient compression, the
train step and the dynamic pruning loop."""
from .optimizer import AdamWConfig, adamw_init, adamw_update, lr_schedule  # noqa: F401
from .step import TrainConfig, make_train_step  # noqa: F401
from .dynamic import (PruningLoopReport, capacity_graph,  # noqa: F401
                      run_pruning_loop)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_schedule",
           "TrainConfig", "make_train_step", "PruningLoopReport",
           "capacity_graph", "run_pruning_loop"]
