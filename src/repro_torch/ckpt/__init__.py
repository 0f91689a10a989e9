"""Checkpointing (port of ``repro.ckpt``)."""
from .checkpoint import CheckpointManager  # noqa: F401

__all__ = ["CheckpointManager"]
