"""Gradient compression with error feedback (port of
``repro.train.compression``).

Gradients are quantised to int8 with one float32 scale per chunk of 256
values; the residual of the quantisation is kept and added back the next
step, so the scheme is unbiased over time (1-bit-Adam style). In the
reference the dequantised tensor stands for the int8 payload of a
cross-pod all-reduce; the port applies the same arithmetic to the
gradients the step has summed. ``torch.round`` rounds half to even, as
``jnp.round`` does.

The chunks are those of the whole leaf flattened. In a sharded step
(``layout``) a slice cut along a non-leading dim holds pieces of many
chunks, so each value takes its chunk's scale from the max |.| of the
whole chunk (``Layout.chunk_amax``: each slice's maxima, reduced with a
max over the mesh, 1/256 of the leaf's values): the result is the one
device's, value for value.
"""
from __future__ import annotations

import dataclasses

import torch

from .optimizer import _map

__all__ = ["CompressionConfig", "compress_decompress", "init_error_state"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    chunk: int = 256          # values per scale
    bits: int = 8


def init_error_state(params):
    """Zero residuals, float32, shaped like the parameter tree."""
    return _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _quantize_leaf(g: torch.Tensor, chunk: int, bits: int):
    """Symmetric per-chunk int quantisation of ``g`` (zero-padded to a
    whole chunk): returns (dequantised, residual), each shaped like g."""
    flat = g.to(torch.float32).reshape(-1)
    n = flat.numel()
    pad = (-n) % chunk
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    c = flat.reshape(-1, chunk)
    qmax = float(2 ** (bits - 1) - 1)
    scale = c.abs().amax(dim=1, keepdim=True) / qmax + 1e-12
    q = torch.clamp(torch.round(c / scale), -qmax, qmax)
    deq = q * scale
    resid = (c - deq).reshape(-1)[:n].reshape(g.shape)
    return deq.reshape(-1)[:n].reshape(g.shape), resid


def _quantize_slice(g: torch.Tensor, spec, layout, chunk: int, bits: int):
    """``_quantize_leaf`` of the whole leaf, on this position's slice
    ``g`` of it (laid out by ``spec``)."""
    g = g.to(torch.float32)
    amax, ids = layout.chunk_amax(g, spec, chunk)
    qmax = float(2 ** (bits - 1) - 1)
    scale = (amax / qmax + 1e-12)[ids]
    q = torch.clamp(torch.round(g / scale), -qmax, qmax)
    deq = q * scale
    return deq, g - deq


@torch.no_grad()
def compress_decompress(cfg: CompressionConfig, grads, error_state,
                        layout=None):
    """Error-feedback quantisation of a gradient tree: returns
    ``(dequantised grads, new error state)``; both unchanged when
    compression is off. ``layout``: the trees hold slices of a sharded
    state."""
    if not cfg.enabled:
        return grads, error_state
    if layout is None:
        out = _map(lambda g, e: _quantize_leaf(g + e, cfg.chunk, cfg.bits),
                   grads, error_state)
    else:
        from repro_torch.dist.sharding import map_specs
        out = map_specs(lambda s, g, e: _quantize_slice(
            g + e, s, layout, cfg.chunk, cfg.bits), layout.specs, grads,
            error_state)
    return _part(out, 0), _part(out, 1)


def _part(tree, i):
    """Element i of each (deq, resid) leaf pair of ``tree``."""
    if isinstance(tree, dict):
        return {k: _part(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_part(v, i) for v in tree]
    return tree[i]
