"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct] — VLM.

Backbone only (phi3-mini); the CLIP vision frontend is a STUB:
``input_specs()`` provides precomputed patch embeddings as a prefix
(n_prefix tokens of d_model), per the assignment brief.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064, mlp_kind="swiglu", norm="rms",
    rope_theta=10_000.0, n_prefix=576,
    notes="GQA kv=32 (full MHA); 576 stubbed CLIP patch-embedding prefix "
          "tokens (24x24 grid). long_500k skipped (full attention).",
)
