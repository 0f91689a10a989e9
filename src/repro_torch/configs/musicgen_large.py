"""musicgen-large [arXiv:2306.05284] — decoder-only over EnCodec tokens.

Backbone only; the EnCodec tokenizer/delay-pattern frontend is a STUB:
``input_specs()`` provides codec token ids plus precomputed conditioning
frame embeddings as a prefix.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, mlp_kind="gelu", norm="layer", vocab=2048,
    rope_theta=10_000.0, n_prefix=64,
    notes="Decoder over EnCodec codebook tokens (vocab 2048); 64 stubbed "
          "conditioning-embedding prefix tokens. long_500k skipped "
          "(full attention).",
)
