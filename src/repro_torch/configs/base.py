"""Architecture configuration schema + input-shape cells.

One ``ArchConfig`` per assigned architecture (exact public config) plus a
``reduced()`` smoke variant exercised on CPU. Full configs are only ever
lowered via ShapeDtypeStruct in the dry-run (no allocation).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

__all__ = ["MoECfg", "SSMCfg", "ArchConfig", "ShapeCell", "SHAPE_CELLS",
           "cells_for"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0          # expert FFN hidden size
    every: int = 1             # MoE layer every N layers (1 = all)
    impl: str = "onehot"       # 'onehot' (GShard dispatch) | 'sorted' (AlphaSparse-style)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 256           # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | vlm | hybrid | ssm | moe | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    mlp_kind: str = "swiglu"   # 'swiglu' | 'gelu'
    norm: str = "rms"          # 'rms' | 'layer'
    qk_norm: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    # hybrid layer pattern, repeated to n_layers: 'A'=attention, 'M'=mamba
    pattern: Optional[tuple[str, ...]] = None
    window: Optional[int] = None        # sliding-window attention size
    n_prefix: int = 0                   # stubbed modality prefix tokens (vlm/audio)
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kinds(self) -> tuple[str, ...]:
        if self.pattern is None:
            return ("A",) * self.n_layers
        reps = math.ceil(self.n_layers / len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]

    def is_attention_free(self) -> bool:
        return all(k == "M" for k in self.layer_kinds())

    def supports_long_context(self) -> bool:
        """long_500k needs sub-quadratic attention: SSM/hybrid(-windowed)."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, L = self.d_model, self.n_layers
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        kinds = self.layer_kinds()
        moe_every = self.moe.every if self.moe else 1
        for i, kind in enumerate(kinds):
            if kind == "A":
                q = d * self.n_heads * self.hd
                kv = 2 * d * self.n_kv_heads * self.hd
                o = self.n_heads * self.hd * d
                total += q + kv + o
            else:  # mamba2 block
                s = self.ssm
                d_in = s.expand * d
                n_h = d_in // s.head_dim
                g_bc = 2 * s.d_state
                total += d * (2 * d_in + g_bc + n_h)   # in_proj
                total += d_in * d                       # out_proj
                total += (d_in + g_bc) * s.conv_width   # conv
                total += 2 * n_h                        # A, dt_bias
            if self.moe and (i % moe_every == moe_every - 1):
                e = self.moe
                n_mats = 3 if self.mlp_kind == "swiglu" else 2
                total += (e.n_experts + e.n_shared) * n_mats * d * e.d_expert
                total += d * e.n_experts               # router
            else:
                n_mats = 3 if self.mlp_kind == "swiglu" else 2
                total += n_mats * d * self.d_ff
            total += 2 * d                             # norms
        return total

    def active_params_per_token(self) -> int:
        """MoE-aware active parameter count (for MODEL_FLOPS = 6*N_active*D)."""
        if self.moe is None:
            return self.n_params()
        full = self.n_params()
        e = self.moe
        n_mats = 3 if self.mlp_kind == "swiglu" else 2
        moe_layers = len([i for i in range(self.n_layers)
                          if i % e.every == e.every - 1])
        routed_total = e.n_experts * n_mats * self.d_model * e.d_expert
        routed_active = e.top_k * n_mats * self.d_model * e.d_expert
        return full - moe_layers * (routed_total - routed_active)

    def reduced(self) -> "ArchConfig":
        """CI-scale config of the same family for CPU smoke tests."""
        pattern = self.pattern
        n_layers = 2 if pattern is None else len(self.pattern)
        moe = None
        if self.moe:
            moe = dataclasses.replace(self.moe, n_experts=4, top_k=2,
                                      n_shared=min(self.moe.n_shared, 1),
                                      d_expert=32)
        ssm = None
        if self.ssm:
            ssm = SSMCfg(d_state=16, expand=2, head_dim=16, conv_width=4,
                         chunk=16)
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=64,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2), head_dim=16,
            d_ff=128, vocab=256, moe=moe, ssm=ssm,
            window=min(self.window, 32) if self.window else None,
            n_prefix=min(self.n_prefix, 4))


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # 'train' | 'prefill' | 'decode'


SHAPE_CELLS: tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def cells_for(cfg: ArchConfig) -> list[ShapeCell]:
    """The shape cells an architecture runs (long_500k needs sub-quadratic
    attention -> skipped for pure full-attention archs, see DESIGN.md §5)."""
    cells = []
    for c in SHAPE_CELLS:
        if c.name == "long_500k" and not cfg.supports_long_context():
            continue
        cells.append(c)
    return cells
