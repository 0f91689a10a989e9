"""Model assembly on PyTorch (port of ``repro.models.model``): init, train
forward, prefill and decode for every assigned architecture, from one
``ArchConfig``-driven block machine.

Layers are grouped into *pattern blocks* (one repetition of
``cfg.pattern``, e.g. jamba's 8-layer Mamba/attention super-block). The
parameters of each pattern position are stacked over blocks, (n_blocks,
...), as in the reference, so parameter trees and caches keep its
layout: caches are (n_blocks, batch, ...). Where the reference scans over
blocks with ``lax.scan``, the port loops over views of the stacked
leaves.

Training: ``forward`` and ``loss_fn`` are differentiable with autograd
over the parameter tree (``train.step`` takes gradients of ``loss_fn``).
``remat=True`` (the reference's default) wraps each pattern block in
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, as the
reference wraps its scan body in ``jax.checkpoint``, when autograd is
recording. The reference's ``unroll`` (``lax.scan`` unrolling),
``act_dp`` and ``seq_shard`` (activation sharding constraints over a
mesh) have no meaning on one card: their defaults are accepted and any
other value raises ``NotImplementedError``. Block views are
``unbind``s of the stacked leaves, so a backward pass writes each
stacked gradient once, not once a block.

Parameters stay float32 by default; ``cast_params`` casts, once, the
leaves the reference casts to the compute dtype at each use (embedding,
head and projections) and keeps norm scales, ``q_norm``/``k_norm``, the
router, ``A_log``, ``dt_bias`` and ``gate_norm`` float32. The values the
functions compute are the same either way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ArchConfig

from . import layers as L
from . import moe as MOE
from . import ssm as SSM

__all__ = ["VOCAB_PAD", "PositionSpec", "padded_vocab", "pattern_specs",
           "n_blocks", "init_params", "cast_params", "forward", "loss_fn",
           "cache_spec", "decode_step", "prefill", "resolve_device",
           "CausalLM"]

VOCAB_PAD = 256  # pad embedding tables so vocab shards evenly (MaxText-style)

# leaves the reference casts to the activations' dtype at every use ...
CAST_LEAVES = frozenset({
    "embed", "lm_head", "wq", "wk", "wv", "wo", "w_up", "w_down", "w_gate",
    "sh_up", "sh_down", "sh_gate", "in_proj", "conv_w", "conv_b", "D",
    "out_proj"})
# ... and leaves it applies in float32 (a bf16 norm scale changes answers)
FLOAT32_LEAVES = frozenset({
    "scale", "bias", "q_norm", "k_norm", "router", "A_log", "dt_bias",
    "gate_norm"})


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the current GPU, and
    raises without one: nothing falls back to the CPU unless asked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the model runs on a CUDA device by default and none is "
            "available; ask for the CPU explicitly with device='cpu'")
    return torch.device("cuda", torch.cuda.current_device())


def padded_vocab(cfg: ArchConfig) -> int:
    return int(np.ceil(cfg.vocab / VOCAB_PAD) * VOCAB_PAD)


@dataclasses.dataclass(frozen=True)
class PositionSpec:
    kind: str            # 'A' | 'M'
    ffn: Optional[str]   # 'mlp' | 'moe' | None


def pattern_specs(cfg: ArchConfig) -> tuple[PositionSpec, ...]:
    pattern = cfg.pattern or ("A",)
    plen = len(pattern)
    if cfg.n_layers % plen:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is not a "
                         f"multiple of the pattern length {plen}")
    specs = []
    for p, kind in enumerate(pattern):
        if cfg.d_ff == 0 and cfg.moe is None:
            ffn = None                     # mamba2: mixer-only blocks
        elif cfg.moe is not None:
            every = cfg.moe.every
            if not (plen % every == 0 or every == 1):
                raise ValueError(f"{cfg.name}: MoE every {every} does not "
                                 f"divide the pattern length {plen}")
            ffn = "moe" if (p % every == every - 1) else "mlp"
        else:
            ffn = "mlp"
        specs.append(PositionSpec(kind, ffn))
    return tuple(specs)


def n_blocks(cfg: ArchConfig) -> int:
    return cfg.n_layers // len(cfg.pattern or ("A",))


# ------------------------------ trees --------------------------------------

def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _cast_tree(tree, dtype, key=None):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast_tree(v, dtype, key) for v in tree]
    if key in CAST_LEAVES:
        return tree.to(dtype)
    if key in FLOAT32_LEAVES:
        return tree
    raise KeyError(f"parameter leaf {key!r} is in neither CAST_LEAVES nor "
                   "FLOAT32_LEAVES")


def cast_params(params: dict, dtype) -> dict:
    """A tree whose projection, embedding and head leaves are cast to
    ``dtype`` once (the reference casts them at every use); the float32
    leaves stay float32."""
    return _cast_tree(params, dtype)


def _split(tree, nb: int) -> list:
    """``nb`` trees, tree b holding block b's view of every stacked leaf
    (one ``unbind`` a leaf, whose backward stacks the blocks' gradients
    once)."""
    if isinstance(tree, dict):
        parts = {k: _split(v, nb) for k, v in tree.items()}
        return [{k: parts[k][b] for k in tree} for b in range(nb)]
    if isinstance(tree, (list, tuple)):
        parts = [_split(v, nb) for v in tree]
        return [[q[b] for q in parts] for b in range(nb)]
    return list(tree.unbind(0))


def block_views(params: dict) -> list[list[dict]]:
    """Per block, per pattern position, the views of the stacked leaves."""
    blocks = params["blocks"]
    nb = next(iter(_leaves(blocks[0]))).shape[0]
    per_pos = [_split(pos, nb) for pos in blocks]
    return [[pos[b] for pos in per_pos] for b in range(nb)]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------- init ------------------------------------

def _init_position(cfg: ArchConfig, spec: PositionSpec, gen, nb: int) -> dict:
    lead = (nb,)
    dev = gen.device
    p = {"ln1": L.init_norm(cfg, cfg.d_model, dev, lead)}
    if spec.kind == "A":
        p["attn"] = L.init_attention(cfg, gen, lead)
    else:
        p["mamba"] = SSM.init_mamba(cfg, gen, lead)
    if spec.ffn is not None:
        p["ln2"] = L.init_norm(cfg, cfg.d_model, dev, lead)
        p["ffn"] = (MOE.init_moe(cfg, gen, lead) if spec.ffn == "moe"
                    else L.init_mlp(cfg, gen, lead))
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Random float32 parameters with the reference's tree, names, shapes,
    dtypes and scales, drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (default the GPU). The bits are not
    ``jax.random``'s: to compute on the reference's weights, convert them
    with ``weights.params_from_numpy``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    vp = padded_vocab(cfg)
    params = {
        "embed": L._normal(gen, (vp, cfg.d_model), 0.02),
        "final_norm": L.init_norm(cfg, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._normal(gen, (cfg.d_model, vp),
                                      1.0 / np.sqrt(cfg.d_model))
    nb = n_blocks(cfg)
    params["blocks"] = [_init_position(cfg, spec, gen, nb)
                        for spec in pattern_specs(cfg)]
    return params


# ------------------------------ forward ------------------------------------

def _ffn(cfg: ArchConfig, spec: PositionSpec, p: dict, h: torch.Tensor):
    """The position's MLP or MoE on ln2(h): (y, aux)."""
    xn = L.apply_norm(p["ln2"], h)
    if spec.ffn == "moe":
        return MOE.apply_moe(cfg, p["ffn"], xn)
    return L.apply_mlp(cfg, p["ffn"], xn), None


def _block_body(cfg: ArchConfig, specs, block_params: list[dict],
                h: torch.Tensor, positions: torch.Tensor, block_kv=None):
    """One pattern block (train path). Returns (h, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for spec, p in zip(specs, block_params):
        xn = L.apply_norm(p["ln1"], h)
        if spec.kind == "A":
            h = h + L.attention_train(cfg, p["attn"], xn, positions,
                                      block_kv=block_kv)
        else:
            h = h + SSM.mamba_train(cfg, p["mamba"], xn)
        if spec.ffn is not None:
            y, a = _ffn(cfg, spec, p, h)
            if a is not None:
                aux = aux + a
            h = h + y
    return h, aux


def _embed(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
           prefix_embeds: Optional[torch.Tensor], dtype) -> torch.Tensor:
    h = params["embed"][tokens.long()].to(dtype)
    if cfg.n_prefix:
        if prefix_embeds is None:
            raise ValueError(f"{cfg.name} needs prefix embeds")
        h = torch.cat([prefix_embeds.to(dtype), h], dim=1)
    return h


def _logits(cfg: ArchConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """The head on final-normed h (tied: the embedding's transpose)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head.to(h.dtype)


def _check_knobs(unroll, act_dp, seq_shard) -> None:
    if unroll != 1 or act_dp is not None or seq_shard:
        raise NotImplementedError(
            "unroll, act_dp and seq_shard are XLA scan and mesh-sharding "
            "knobs of the reference with no meaning on one card; leave "
            "them at their defaults (1, None, False)")


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            compute_dtype=torch.bfloat16, block_kv: Optional[int] = None,
            *, remat: bool = True, unroll: int = 1,
            act_dp: Optional[tuple] = None, seq_shard: bool = False):
    """tokens: (B, S) -> (logits (B, S, vocab_padded), aux_loss).

    Logits cover token positions only (the stubbed modality prefix is
    consumed but not predicted). ``remat`` recomputes each pattern block
    in the backward pass instead of keeping its activations."""
    _check_knobs(unroll, act_dp, seq_shard)
    specs = pattern_specs(cfg)
    h = _embed(cfg, params, tokens, prefix_embeds, compute_dtype)
    positions = torch.arange(h.shape[1], device=h.device)[None]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    ckpt = remat and torch.is_grad_enabled()
    for block in block_views(params):
        if ckpt:
            h, a = torch.utils.checkpoint.checkpoint(
                _block_body, cfg, specs, block, h, positions, block_kv,
                use_reentrant=False)
        else:
            h, a = _block_body(cfg, specs, block, h, positions, block_kv)
        aux = aux + a
    h = L.apply_norm(params["final_norm"], h)
    if cfg.n_prefix:
        h = h[:, cfg.n_prefix:]
    return _logits(cfg, params, h), aux


def loss_fn(cfg: ArchConfig, params: dict, batch: dict,
            compute_dtype=torch.bfloat16, block_kv: Optional[int] = None,
            *, remat: bool = True, unroll: int = 1,
            act_dp: Optional[tuple] = None, seq_shard: bool = False):
    """Next-token cross entropy + MoE aux + z-loss: (total, {"ce", "aux",
    "z"}). batch: tokens, labels (+ prefix_embeds for vlm/audio). labels
    < 0 are masked."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          batch.get("prefix_embeds"), compute_dtype,
                          block_kv, remat=remat, unroll=unroll,
                          act_dp=act_dp, seq_shard=seq_shard)
    logits = logits.float()
    labels = batch["labels"].long()
    mask = (labels >= 0) & (labels < cfg.vocab)
    safe = torch.where(mask, labels, 0)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - ll) * mask
    denom = torch.clamp(mask.sum(), min=1)
    ce = nll.sum() / denom
    z_loss = 1e-4 * ((lse * mask) ** 2).sum() / denom
    total = ce + z_loss + 1e-2 * aux
    return total, {"ce": ce, "aux": aux, "z": z_loss}


# --------------------------- prefill / decode -------------------------------

def cache_spec(cfg: ArchConfig, batch: int, s_cache: int,
               dtype=torch.bfloat16, device=None) -> list[dict]:
    """Zero-initialised caches (one entry per pattern position), each
    leaf (n_blocks, batch, ...)."""
    dev = resolve_device(device)
    nb = n_blocks(cfg)
    caches = []
    for spec in pattern_specs(cfg):
        if spec.kind == "A":
            sc = min(s_cache, cfg.window) if cfg.window else s_cache
            shape = (nb, batch, sc, cfg.n_kv_heads, cfg.hd)
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                           "v": torch.zeros(shape, dtype=dtype, device=dev)})
        else:
            d_in, H, P, N, ch = SSM._dims(cfg)
            w = cfg.ssm.conv_width
            caches.append({
                "conv": torch.zeros((nb, batch, w - 1, ch), dtype=dtype,
                                    device=dev),
                "ssm": torch.zeros((nb, batch, H, P, N), dtype=dtype,
                                   device=dev),
            })
    return caches


def _commit(dst: torch.Tensor, new: torch.Tensor,
            rows: Optional[torch.Tensor]) -> None:
    if rows is None:
        dst.copy_(new)
    else:
        dst[rows] = new[rows].to(dst.dtype)


def decode_step(cfg: ArchConfig, params: dict, token: torch.Tensor, pos,
                caches: list[dict], compute_dtype=torch.bfloat16,
                rows: Optional[torch.Tensor] = None, views=None):
    """One-token decode. token: (B, 1); pos: current position
    (prefix-inclusive), a scalar when every row is at the same depth, or
    a (B,) vector of per-slot positions (continuous batching: rows that
    joined mid-flight decode at their own cache depth); caches as from
    ``cache_spec``. Returns (logits float32 (B, 1, vocab_padded), caches).

    The caches are updated **in place** (the returned list is the one
    passed) and hold the reference's values after the step. ``rows``
    (indices) limits the writes to those batch rows, the reference
    executor's ``live`` commit; the other rows' logits are then not the
    reference's and are for the caller to discard. ``views`` are
    ``block_views(params)``, made once by a caller that decodes many
    steps."""
    specs = pattern_specs(cfg)
    h = params["embed"][token.long()].to(compute_dtype)
    for b, block in enumerate(views or block_views(params)):
        for i, (spec, p) in enumerate(zip(specs, block)):
            c = caches[i]
            xn = L.apply_norm(p["ln1"], h)
            if spec.kind == "A":
                out, _, _ = L.attention_decode(cfg, p["attn"], xn, pos,
                                               c["k"][b], c["v"][b], rows)
            else:
                out, conv, ssm_st = SSM.mamba_decode(
                    cfg, p["mamba"], xn, c["conv"][b], c["ssm"][b])
                _commit(c["conv"][b], conv, rows)
                _commit(c["ssm"][b], ssm_st, rows)
            h = h + out
            if spec.ffn is not None:
                h = h + _ffn(cfg, spec, p, h)[0]
    h = L.apply_norm(params["final_norm"], h)
    return _logits(cfg, params, h).float(), caches


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            compute_dtype=torch.bfloat16, block_kv: Optional[int] = None):
    """Full-sequence prefill producing the last position's logits and
    populated caches. Attention caches hold the processed sequence
    (window-truncated, in ring-buffer order, with a sliding window); mamba
    positions hold the final conv/ssm states."""
    specs = pattern_specs(cfg)
    h = _embed(cfg, params, tokens, prefix_embeds, compute_dtype)
    s_total = h.shape[1]
    positions = torch.arange(s_total, device=h.device)[None]
    per_block = []
    for block in block_views(params):
        cache_out = []
        for spec, p in zip(specs, block):
            xn = L.apply_norm(p["ln1"], h)
            if spec.kind == "A":
                q, k, v = L._qkv(cfg, p["attn"], xn, positions)
                if block_kv is not None and s_total % block_kv == 0 \
                        and s_total > block_kv:
                    out = L._gqa_blockwise(cfg, q, k, v, block_kv, cfg.window)
                else:
                    mask = L.causal_mask(s_total, window=cfg.window,
                                         device=h.device)
                    mask = mask.expand((h.shape[0],) + mask.shape[1:])
                    out = L._gqa_scores_softmax_v(cfg, q, k, v, mask)
                h = h + out @ p["attn"]["wo"].to(h.dtype)
                if cfg.window and s_total > cfg.window:
                    # ring-buffer layout: slot j holds position p, p%W == j
                    w = cfg.window
                    start = s_total - w
                    k = torch.roll(k[:, start:], shifts=start % w, dims=1)
                    v = torch.roll(v[:, start:], shifts=start % w, dims=1)
                cache_out.append({"k": k.to(compute_dtype),
                                  "v": v.to(compute_dtype)})
            else:
                out, (conv, ssm_st) = SSM.mamba_train(cfg, p["mamba"], xn,
                                                      return_state=True)
                h = h + out
                cache_out.append({"conv": conv.to(compute_dtype),
                                  "ssm": ssm_st.to(compute_dtype)})
            if spec.ffn is not None:
                h = h + _ffn(cfg, spec, p, h)[0]
        per_block.append(cache_out)
    caches = [{key: torch.stack([blk[i][key] for blk in per_block])
               for key in per_block[0][i]} for i in range(len(specs))]
    h = L.apply_norm(params["final_norm"], h)
    logits = _logits(cfg, params, h[:, -1:]).float()
    return logits, caches


# ------------------------------ the module ---------------------------------

class _Node(nn.Module):
    """A dict of a parameter tree as a module: dict children become
    submodules, lists ``nn.ModuleList``s and tensors parameters, so that
    ``state_dict`` keys are the reference's pytree paths
    (``blocks.0.attn.wq``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Node(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(_Node(x) for x in v))
            else:
                # serving builds no autograd graph; training takes
                # gradients on the parameter tree (train.step), not here
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def tree(self):
        out = {}
        for k, v in self._parameters.items():
            out[k] = v
        for k, m in self._modules.items():
            out[k] = ([x.tree() for x in m] if isinstance(m, nn.ModuleList)
                      else m.tree())
        return out


class CausalLM(_Node):
    """A decoder of any assigned architecture as an ``nn.Module``.

    Holds the parameters under the reference's pytree names, the
    per-position blocks stacked (n_blocks, ...), on ``device`` (default
    the GPU; raises without one). ``params`` (a tree of tensors, e.g. from
    ``weights.params_from_numpy``) or ``init_params(cfg, seed, device)``;
    ``dtype`` casts the leaves the reference casts at each use
    (``cast_params``) and is the methods' compute and cache dtype (default
    float32). The methods delegate to the module's plain functions."""

    def __init__(self, cfg: ArchConfig, params: Optional[dict] = None, *,
                 seed: int = 0, device=None, dtype=None):
        dev = resolve_device(device)
        if params is None:
            params = init_params(cfg, seed, dev)
        else:
            from .weights import to_tensor
            params = tree_map(lambda t: t.to(dev) if isinstance(
                t, torch.Tensor) else to_tensor(t, dev), params)
        if dtype is not None:
            params = cast_params(params, dtype)
        super().__init__(params)
        self.cfg = cfg
        self.device = dev
        self.dtype = dtype or torch.float32
        self.params = self.tree()
        self._views = block_views(self.params)

    def forward(self, tokens, prefix_embeds=None, block_kv=None):
        return forward(self.cfg, self.params, tokens, prefix_embeds,
                       self.dtype, block_kv)

    def loss(self, batch: dict, block_kv=None):
        return loss_fn(self.cfg, self.params, batch, self.dtype, block_kv)

    def cache_spec(self, batch: int, s_cache: int):
        return cache_spec(self.cfg, batch, s_cache, self.dtype, self.device)

    def decode_step(self, token, pos, caches, rows=None):
        return decode_step(self.cfg, self.params, token, pos, caches,
                           self.dtype, rows, self._views)

    def prefill(self, tokens, prefix_embeds=None, block_kv=None):
        return prefill(self.cfg, self.params, tokens, prefix_embeds,
                       self.dtype, block_kv)
