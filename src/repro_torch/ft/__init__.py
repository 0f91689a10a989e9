"""Fault tolerance for the serving plane (copy of ``repro.ft``)."""
from .manager import (ComponentHealth, FaultToleranceConfig,  # noqa: F401
                      FaultToleranceManager, NodeFailure, StragglerReport)
