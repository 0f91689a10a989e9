"""Synthetic training data (port of ``repro.data``)."""
from .pipeline import DataConfig, SyntheticTokenPipeline  # noqa: F401

__all__ = ["DataConfig", "SyntheticTokenPipeline"]
