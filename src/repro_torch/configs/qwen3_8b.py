"""qwen3-8b [hf:Qwen/Qwen3-8B] — dense GQA with qk_norm."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab=151936, mlp_kind="swiglu", norm="rms",
    qk_norm=True, rope_theta=1_000_000.0,
    notes="qk RMSNorm per head before RoPE; GQA kv=8.",
)
