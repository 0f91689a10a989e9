"""deepseek-moe-16b [arXiv:2401.06066] — fine-grained MoE, 2 shared + 64
routed top-6."""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, mlp_kind="swiglu", norm="rms",
    moe=MoECfg(n_experts=64, top_k=6, n_shared=2, d_expert=1408, every=1),
    notes="Fine-grained expert segmentation: 64 routed experts (top-6) + 2 "
          "always-on shared experts, d_expert=1408. Deviation: the public "
          "model keeps layer 0 dense; we apply MoE to all layers per the "
          "assignment config line.",
)
