"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0 family] — 40 experts
top-8."""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155, mlp_kind="swiglu", norm="rms",
    tie_embeddings=True,
    moe=MoECfg(n_experts=40, top_k=8, n_shared=0, d_expert=512, every=1),
    notes="GQA kv=8; 40 routed experts top-8, d_expert=512.",
)
