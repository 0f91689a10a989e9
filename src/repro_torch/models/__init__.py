"""Assigned-architecture model zoo on PyTorch (port of ``repro.models``):
plain functions over parameter trees, and ``CausalLM``, the same as an
``nn.Module``."""
from .model import (CausalLM, cache_spec, cast_params,  # noqa: F401
                    decode_step, fill_caches, forward, init_params, loss_fn,
                    n_blocks, padded_vocab, pattern_specs, prefill)

__all__ = ["CausalLM", "cache_spec", "cast_params", "decode_step",
           "fill_caches", "forward", "init_params", "loss_fn", "n_blocks",
           "padded_vocab", "pattern_specs", "prefill"]
