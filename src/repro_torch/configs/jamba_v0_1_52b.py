"""jamba-v0.1-52b [arXiv:2403.19887] — hybrid Mamba+attention 1:7, MoE.

Layer pattern per paper: blocks of 8 with 1 attention layer (index 4);
MoE replaces the MLP every 2 layers; 16 experts top-2.
"""
from .base import ArchConfig, MoECfg, SSMCfg

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, mlp_kind="swiglu", norm="rms",
    moe=MoECfg(n_experts=16, top_k=2, n_shared=0, d_expert=14336, every=2),
    ssm=SSMCfg(d_state=16, expand=2, head_dim=64, conv_width=4, chunk=256),
    pattern=("M", "M", "M", "M", "A", "M", "M", "M"),
    window=4096,
    notes="Mamba:attention 1:7 interleave; attention layers use a 4096 "
          "sliding window at long context so long_500k RUNS (documented "
          "deviation: paper uses full attention at 256k, DESIGN.md §5).",
)
