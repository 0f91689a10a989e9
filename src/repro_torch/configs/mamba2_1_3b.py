"""mamba2-1.3b [arXiv:2405.21060] — attention-free SSM (SSD algorithm)."""
from .base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,  # heads unused (attn-free)
    d_ff=0, vocab=50280, mlp_kind="swiglu", norm="rms",
    ssm=SSMCfg(d_state=128, expand=2, head_dim=64, conv_width=4, chunk=256),
    pattern=("M",),
    notes="Pure SSD blocks, no attention and no separate MLP (d_ff=0). "
          "long_500k RUNS (O(L) scan, O(1) decode state).",
)
