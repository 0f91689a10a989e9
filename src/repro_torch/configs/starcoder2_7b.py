"""starcoder2-7b [arXiv:2402.19173] — dense GQA, RoPE, GELU MLP, LayerNorm."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152, mlp_kind="gelu", norm="layer",
    rope_theta=100_000.0,
    notes="GQA kv=4; standard (non-gated) MLP and LayerNorm per paper.",
)
