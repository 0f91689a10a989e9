"""Training-side drivers (port of ``repro.train``). Only the dynamic
pruning loop is ported; the optimizer, train step and compression wait
for the LLM stack (ROADMAP queue 1, item 7)."""
from .dynamic import (PruningLoopReport, capacity_graph,  # noqa: F401
                      run_pruning_loop)
