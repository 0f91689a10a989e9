"""Transformer building blocks on PyTorch (port of ``repro.models.layers``):
norms, RoPE, GQA attention (train and cached decode), gated and plain MLPs.
Plain functions over parameter trees (nested dicts of tensors) with the
reference's names and shapes.

Projection weights keep the reference's flattened head dims
(d_model, n_heads * head_dim). Parameters may be float32 while the
activations are bfloat16: every projection is cast to the activations'
dtype at its use (``.to`` is free when the leaf already has it), and
norm scales and ``q_norm``/``k_norm`` are applied in float32, as the
reference does. Attention is the reference's einsum arithmetic, not a
fused attention kernel, so that the port computes what it computes.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

__all__ = ["init_norm", "apply_norm", "rms_head_norm", "rope_freqs",
           "apply_rope", "init_attention", "causal_mask", "attention_train",
           "attention_decode", "init_mlp", "apply_mlp", "gelu"]

NEG_INF = -1e30          # the reference's additive mask value


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: its default is the tanh approximation, not the
    exact erf form that ``F.gelu`` takes by default."""
    return F.gelu(x, approximate="tanh")


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


# ------------------------------- norms ------------------------------------

def init_norm(cfg: ArchConfig, d: int, device=None, lead=()) -> dict:
    p = {"scale": torch.ones(lead + (d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layer":
        p["bias"] = torch.zeros(lead + (d,), dtype=torch.float32,
                                device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, or LayerNorm when ``p`` has a bias; computed in float32
    with the float32 scale, cast back to x's dtype."""
    xf = x.float()
    if "bias" in p:  # LayerNorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:            # RMSNorm
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """qk-norm (qwen3): RMSNorm over the head_dim of (B,S,H,hd)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# -------------------------------- RoPE -------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    ang = positions[..., None].float() * freqs           # (B,S,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    cos = cos[:, :, None, :] if cos.ndim == 3 else cos[None, :, None, :]
    sin = sin[:, :, None, :] if sin.ndim == 3 else sin[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ------------------------------ attention ----------------------------------

def init_attention(cfg: ArchConfig, gen: torch.Generator, lead=()) -> dict:
    d, hd = cfg.d_model, cfg.hd
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(gen, lead + (d, cfg.n_heads * hd), s),
        "wk": _normal(gen, lead + (d, cfg.n_kv_heads * hd), s),
        "wv": _normal(gen, lead + (d, cfg.n_kv_heads * hd), s),
        "wo": _normal(gen, lead + (cfg.n_heads * hd, d),
                      1.0 / math.sqrt(cfg.n_heads * hd)),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=torch.float32,
                                 device=gen.device)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=torch.float32,
                                 device=gen.device)
    return p


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def _qkv(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    hd = cfg.hd
    q = _split_heads(x @ p["wq"].to(x.dtype), cfg.n_heads, hd)
    k = _split_heads(x @ p["wk"].to(x.dtype), cfg.n_kv_heads, hd)
    v = _split_heads(x @ p["wv"].to(x.dtype), cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores_softmax_v(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,T,KV,hd); mask: (B,1,S,T) additive."""
    groups = cfg.n_heads // cfg.n_kv_heads
    b, s, h, hd = q.shape
    qg = q.reshape(b, s, cfg.n_kv_heads, groups, hd)
    # the reference divides by ``np.sqrt(hd)``, a numpy float64 that jax
    # takes as float32: bf16 scores become float32 before the division
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() / math.sqrt(hd)
    scores = scores + mask[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, s, h * hd)


def causal_mask(s: int, dtype=torch.float32, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    allow = j <= i
    if window is not None:
        allow &= (i - j) < window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(allow, zero, NEG_INF).to(dtype)[None, None]


def _gqa_blockwise(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, block_kv: int,
                   window: Optional[int]) -> torch.Tensor:
    """Flash-style online-softmax attention over KV chunks (the
    reference's ``lax.scan``, as a loop): peak memory per chunk is
    O(B*H*S*block_kv) instead of O(B*H*S*S)."""
    b, s, h, hd = q.shape
    kvh = cfg.n_kv_heads
    groups = h // kvh
    qg = q.reshape(b, s, kvh, groups, hd)
    scale = 1.0 / math.sqrt(hd)
    n_chunks = s // block_kv
    kc = k.reshape(b, n_chunks, block_kv, kvh, hd)
    vc = v.reshape(b, n_chunks, block_kv, kvh, hd)
    qi = torch.arange(s, device=q.device)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    m = torch.full((b, kvh, groups, s), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, groups, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, groups, s, hd), dtype=q.dtype, device=q.device)
    for j in range(n_chunks):
        kj, vj = kc[:, j], vc[:, j]
        kv_pos = j * block_kv + torch.arange(block_kv, device=q.device)[None]
        allow = kv_pos <= qi
        if window is not None:
            allow &= (qi - kv_pos) < window
        sc = torch.einsum("bskgh,btkh->bkgst", qg, kj).float() * scale
        sc = sc + torch.where(allow, zero, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        pr = torch.exp(sc - m_new[..., None])
        l = l * alpha + pr.sum(-1)
        acc = (acc * alpha[..., None].to(acc.dtype)
               + torch.einsum("bkgst,btkh->bkgsh", pr.to(q.dtype), vj)
               ).to(acc.dtype)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None].to(q.dtype)
    return out.movedim(3, 1).reshape(b, s, h * hd)


def attention_train(cfg: ArchConfig, p: dict, x: torch.Tensor,
                    positions: torch.Tensor,
                    block_kv: Optional[int] = None) -> torch.Tensor:
    q, k, v = _qkv(cfg, p, x, positions)
    if block_kv is not None and x.shape[1] % block_kv == 0 \
            and x.shape[1] > block_kv:
        out = _gqa_blockwise(cfg, q, k, v, block_kv, cfg.window)
    else:
        mask = causal_mask(x.shape[1], window=cfg.window, device=x.device)
        mask = mask.expand((x.shape[0],) + mask.shape[1:])
        out = _gqa_scores_softmax_v(cfg, q, k, v, mask)
    return out @ p["wo"].to(x.dtype)


def attention_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, pos,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     rows: Optional[torch.Tensor] = None):
    """One-token decode. x: (B,1,D); pos: a scalar (all rows at the same
    position) or (B,) per-slot positions (continuous batching: each batch
    row advances at its own cache depth); caches: (B, S_c, KV, hd). With a
    sliding window the cache is a ring buffer of size S_c == window.

    The new K/V are written **in place** into the caches at each row's
    slot, ``min(pos, S_c - 1)`` without a window and ``pos % S_c`` with
    one, for the rows in ``rows`` (all rows when None). The reference
    selects over the whole cache with ``where`` and returns new arrays;
    the written rows end with the same values, and a row left out keeps
    its cache as the reference's ``live`` commit does. Its own attention
    output then reads its old entry at the slot, which the reference's
    would not; the caller discards those rows. Returns
    (out, k_cache, v_cache)."""
    b = x.shape[0]
    s_c = k_cache.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    per_slot = pos.ndim == 1
    positions = pos[:, None] if per_slot else pos.expand(b, 1)
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    slot = pos % s_c if cfg.window else torch.clamp(pos, max=s_c - 1)
    posv = pos.expand(b)
    slotv = slot.expand(b)
    ar = torch.arange(b, device=x.device) if rows is None else rows
    # one slot per row: no two writes land on one entry, so the scatter is
    # deterministic
    k_cache[ar, slotv[ar]] = k_new[ar, 0].to(k_cache.dtype)
    v_cache[ar, slotv[ar]] = v_new[ar, 0].to(v_cache.dtype)
    j = torch.arange(s_c, device=x.device)
    if cfg.window:
        # ring buffer: entry j holds absolute position p_j with p_j % s_c == j
        age = (slotv[:, None] - j[None, :]) % s_c
        valid = age <= torch.clamp(posv, max=s_c - 1)[:, None]
    else:
        valid = j[None, :] <= posv[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mask = torch.where(valid, zero, NEG_INF)[:, None, None, :]
    out = _gqa_scores_softmax_v(cfg, q, k_cache.to(x.dtype),
                                v_cache.to(x.dtype), mask)
    return out @ p["wo"].to(x.dtype), k_cache, v_cache


# --------------------------------- MLP --------------------------------------

def init_mlp(cfg: ArchConfig, gen: torch.Generator, lead=()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"w_up": _normal(gen, lead + (d, f), s_in),
         "w_down": _normal(gen, lead + (f, d), s_out)}
    if cfg.mlp_kind == "swiglu":
        p["w_gate"] = _normal(gen, lead + (d, f), s_in)
    return p


def apply_mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    up = x @ p["w_up"].to(x.dtype)
    if cfg.mlp_kind == "swiglu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * up
    else:
        h = gelu(up)
    return h @ p["w_down"].to(x.dtype)
