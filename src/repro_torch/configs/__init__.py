"""Assigned-architecture registry: ``get_config(arch_id)`` / ``--arch`` ids.

A copy of ``repro.configs`` (plain dataclasses, no jax): the port keeps
its own so that it never imports the reference package. ``n_params()``,
``reduced()``, ``cells_for`` and ``REGISTRY`` give the reference's values.
"""
from __future__ import annotations

from .base import ArchConfig, MoECfg, SSMCfg, ShapeCell, SHAPE_CELLS, cells_for  # noqa: F401

from . import (granite_3_2b, starcoder2_7b, llama3_405b, qwen3_8b,
               phi_3_vision_4_2b, jamba_v0_1_52b, mamba2_1_3b,
               deepseek_moe_16b, granite_moe_3b_a800m, musicgen_large)

_MODULES = (granite_3_2b, starcoder2_7b, llama3_405b, qwen3_8b,
            phi_3_vision_4_2b, jamba_v0_1_52b, mamba2_1_3b,
            deepseek_moe_16b, granite_moe_3b_a800m, musicgen_large)

REGISTRY: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

ARCH_IDS = tuple(REGISTRY)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]
