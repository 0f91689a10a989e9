"""llama3-405b [arXiv:2407.21783] — dense GQA, 128k vocab."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256, mlp_kind="swiglu", norm="rms",
    rope_theta=500_000.0,
    notes="GQA kv=8. long_500k skipped: pure full attention (DESIGN.md §5).",
)
