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
recording. Block views are ``unbind``s of the stacked leaves, so a
backward pass writes each stacked gradient once, not once a block.

Sharded training: with ``layout`` (a ``dist.collectives.Layout``) the
parameter tree holds this process's slices of a state laid out over a
mesh of processes. The embedding, head and final norm are gathered for
use once; each block's leaves are gathered for use one block at a time,
inside the remat region (so a block's whole weights live only while it
runs, and are gathered again for the backward). Attention, the dense
MLP, MoE's experts and Mamba's heads run tensor-parallel over ``model``
where the layout's specs split them (``Layout``'s flags; ``layers``,
``moe``, ``ssm``). With the vocabulary split (``Layout.vocab_tp``) each
model position looks up the tokens of its vocabulary rows (zeros
elsewhere, summed over ``model``), ``forward`` returns its columns of
the logits only and ``loss_fn`` takes the log-sum-exp over the split
(``TensorParallel.vocab_lse``). ``loss_fn`` takes the global masked
mean (the sums of nll, lse^2 and the mask summed over the data axes)
and MoE's aux loss the global batch's statistics. The reference's
``act_dp`` is accepted when it names the mesh's data axes (the batch is
split that way already); ``unroll`` (``lax.scan`` unrolling) raises
``NotImplementedError``, as ``act_dp`` does without a layout.

``seq_shard`` (sequence parallelism) keeps the reference's meaning: the
residual stream's sequence is split over ``model`` only where
``act_dp`` is given, that is with a layout and ``act_dp`` naming its
data axes (``dist.collectives.SequenceParallel``). Each model position
then holds ``ceil(S' / m)`` rows of the stream (``S'`` the sequence with
its prefix); the norms and the residual adds run on them, and each
sub-layer gathers the whole sequence before it computes and scatters it
back after: a split region through ``TensorParallel.over(seq)``, a
region whose leaves are gathered whole through the gather / split pair.
MoE gathers the normed tokens, not an all-to-all of each position's
own: capacity, drops and the router's aux loss are defined over a row's
whole sequence. Its router takes the gather whose backward is the
position's own rows (its gates' gradient is made whole by
``enter_whole``), its experts the one whose backward is summed. Without
``act_dp`` (or without a layout) ``seq_shard`` computes exactly what
``seq_shard=False`` does, as in the reference.

Sharded serving: ``prefill`` and ``decode_step`` take the same
``layout`` (and the reference's ``act_dp``, accepted where it names the
layout's data axes). ``params`` are this process's slices by
``param_specs``; ``tokens``, ``token``, ``pos`` (a scalar, or a
per-row vector) and ``rows`` are its rows of the global batch
(``dist.sharding.shard_serve``); the caches are its slices by
``cache_specs`` (``cache_spec(..., layout=)`` allocates only those).
Leaves are gathered for use as in ``forward``, the same blocks run
tensor-parallel (attention on its KV-head slice of the cache, Mamba on
its SSM heads, the conv cache gathered over ``model`` where it is cut
into chunks: ``ssm``'s docstring), MoE routes every token whole on
every position, and the logits come back whole: where the vocabulary is
split they are all-gathered over ``model``. Both calls need a process
group: a ``Layout`` refuses a mesh without one.

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
           "cache_spec", "fill_caches", "decode_step", "prefill",
           "resolve_device", "CausalLM"]

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

def _ffn(cfg: ArchConfig, spec: PositionSpec, p: dict, h: torch.Tensor,
         tp=None, dp=None, seq=None):
    """The position's MLP or MoE on ln2(h): (y, aux). ``tp``: the MLP's
    or the experts' tensor parallelism; ``dp``: the layout whose data
    axes MoE's aux loss sums over; ``seq``: ``h`` is this position's
    rows of the sequence."""
    xn = L.apply_norm(p["ln2"], h)
    if spec.ffn == "moe":
        return _region(seq, tp, lambda x, t: MOE.apply_moe(
            cfg, p["ffn"], x, dp=dp, tp=t), xn)
    return _region(seq, tp, lambda x, t: (L.apply_mlp(
        cfg, p["ffn"], x, tp=t), None), xn)


def _region(seq, tp, fn, x):
    """``fn(x, tp) -> (y, aux)``, a sub-layer on the residual stream's
    ``x``. With the sequence split (``seq``) a split region's ``tp``
    gathers and scatters the sequence itself; a region whose leaves are
    whole (``tp`` None) gathers it before and keeps its own rows after."""
    if seq is None or tp is not None:
        return fn(x, tp)
    y, aux = fn(seq.gather(x), None)
    return seq.split(y), aux


def _tps(layout, i: int, tp) -> tuple:
    """``(mixer tp, ffn tp)`` of pattern position ``i``: ``tp`` where the
    layout splits that sub-layer over ``model``, else None."""
    if layout is None:
        return None, None
    return (tp if (layout.attn_tp[i] or layout.ssm_tp[i]) else None,
            tp if (layout.mlp_tp[i] or layout.moe_tp[i]) else None)


def _block_body(cfg: ArchConfig, specs, block_params: list[dict],
                h: torch.Tensor, positions: torch.Tensor, block_kv=None,
                layout=None, seq=None):
    """One pattern block (train path). Returns (h, aux_loss). With
    ``layout`` the block's slices are gathered for use here; with
    ``seq`` (a ``SequenceParallel``) ``h`` is this position's rows."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    tp = None
    if layout is not None:
        block_params = layout.block(block_params, seq is not None)
        tp = layout.tp if seq is None else layout.tp.over(seq)
    for i, (spec, p) in enumerate(zip(specs, block_params)):
        mix_tp, ffn_tp = _tps(layout, i, tp)
        xn = L.apply_norm(p["ln1"], h)
        if spec.kind == "A":
            y, _ = _region(seq, mix_tp, lambda x, t: (L.attention_train(
                cfg, p["attn"], x, positions, block_kv=block_kv, tp=t),
                None), xn)
        else:
            y, _ = _region(seq, mix_tp, lambda x, t: (SSM.mamba_train(
                cfg, p["mamba"], x, tp=t), None), xn)
        h = h + y
        if spec.ffn is not None:
            y, a = _ffn(cfg, spec, p, h, tp=ffn_tp, dp=layout, seq=seq)
            if a is not None:
                aux = aux + a
            h = h + y
    return h, aux


def _lookup(params: dict, tokens: torch.Tensor, dtype,
            tp=None) -> torch.Tensor:
    """The tokens' rows of the embedding; with ``tp`` those of this model
    position's vocabulary rows, zeros elsewhere (the caller sums them
    over ``model``)."""
    if tp is None:
        return params["embed"][tokens.long()].to(dtype)
    n = params["embed"].shape[0]
    t = tokens.long() - tp.rank * n
    mine = ((t >= 0) & (t < n))[..., None]
    rows = params["embed"][torch.where(mine[..., 0], t, 0)].to(dtype)
    return torch.where(mine, rows, 0)


def _embed(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
           prefix_embeds: Optional[torch.Tensor], dtype,
           tp=None, seq=None) -> torch.Tensor:
    """The tokens' rows of the embedding (then the prefix). With ``tp``
    ``embed`` holds this model position's part of the vocabulary rows:
    it looks up the tokens there, zeros elsewhere, and the rows are summed
    over ``model`` (one position adds each, exactly). With ``seq`` the
    result is this position's rows of the sequence: the sum is a
    reduce-scatter (``tp.over(seq).exit``; model position 0 adds the
    prefix), or without ``tp`` the whole lookup's own rows."""
    if cfg.n_prefix and prefix_embeds is None:
        raise ValueError(f"{cfg.name} needs prefix embeds")
    h = _lookup(params, tokens, dtype, tp)
    if tp is None:
        if cfg.n_prefix:
            h = torch.cat([prefix_embeds.to(dtype), h], dim=1)
        return h if seq is None else seq.split(h)
    if seq is None:
        h = tp.exit(h)
        if cfg.n_prefix:
            h = torch.cat([prefix_embeds.to(dtype), h], dim=1)
        return h
    if cfg.n_prefix:
        pre = prefix_embeds.to(dtype)
        h = torch.cat([pre if tp.rank == 0 else torch.zeros_like(pre), h],
                      dim=1)
    return tp.over(seq).exit(h)


def _logits(cfg: ArchConfig, params: dict, h: torch.Tensor,
            tp=None) -> torch.Tensor:
    """The head on final-normed h (tied: the embedding's transpose); with
    ``tp`` this model position's vocabulary columns."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if tp is not None:
        h = tp.enter(h)
    return h @ head.to(h.dtype)


def _whole_logits(cfg: ArchConfig, params: dict, h: torch.Tensor,
                  tp=None) -> torch.Tensor:
    """Serving's float32 logits over the whole padded vocabulary: with
    ``tp`` (the vocabulary split) the positions' columns all-gathered
    over ``model``."""
    logits = _logits(cfg, params, h, tp).float()
    return logits if tp is None else tp.gather(logits, -1)


def _check_knobs(unroll, act_dp, layout) -> None:
    if unroll != 1:
        raise NotImplementedError(
            "unroll is the reference's lax.scan unrolling; the port loops "
            "over blocks: leave it at 1")
    if act_dp is not None and (layout is None
                               or tuple(act_dp) != tuple(layout.dp)):
        raise NotImplementedError(
            f"act_dp {act_dp!r}: activations are split over the data axes "
            "of a sharded step's mesh "
            f"({None if layout is None else layout.dp}) and over nothing "
            "else; leave it at None or name those axes")


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            compute_dtype=torch.bfloat16, block_kv: Optional[int] = None,
            *, remat: bool = True, unroll: int = 1,
            act_dp: Optional[tuple] = None, seq_shard: bool = False,
            layout=None):
    """tokens: (B, S) -> (logits (B, S, vocab_padded), aux_loss).

    Logits cover token positions only (the stubbed modality prefix is
    consumed but not predicted). ``remat`` recomputes each pattern block
    in the backward pass instead of keeping its activations. ``layout``:
    ``params`` are this process's slices (see the module's docstring),
    ``tokens`` its rows of the global batch; with ``layout.vocab_tp`` the
    logits are this model position's ``vocab_padded / model`` columns.
    ``seq_shard`` with ``act_dp`` (and so a layout) splits the residual
    stream's sequence over ``model`` (see the module's docstring)."""
    _check_knobs(unroll, act_dp, layout)
    specs = pattern_specs(cfg)
    vocab_tp = seq = None
    length = tokens.shape[1] + cfg.n_prefix
    if layout is not None:
        if seq_shard and act_dp is not None:
            from repro_torch.dist.collectives import SequenceParallel
            seq = SequenceParallel(layout.mesh, length)
        params = layout.top(params, seq is not None)
        vocab_tp = layout.tp if layout.vocab_tp else None
    h = _embed(cfg, params, tokens, prefix_embeds, compute_dtype, vocab_tp,
               seq)
    positions = torch.arange(length, device=h.device)[None]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    ckpt = remat and torch.is_grad_enabled()
    for block in block_views(params):
        if ckpt:
            h, a = torch.utils.checkpoint.checkpoint(
                _block_body, cfg, specs, block, h, positions, block_kv,
                layout, seq, use_reentrant=False)
        else:
            h, a = _block_body(cfg, specs, block, h, positions, block_kv,
                               layout, seq)
        aux = aux + a
    h = L.apply_norm(params["final_norm"], h)
    if seq is not None:        # the head's enter gathers the sequence
        h = seq.gather(h, summed=vocab_tp is not None)
        vocab_tp = None
    if cfg.n_prefix:
        h = h[:, cfg.n_prefix:]
    return _logits(cfg, params, h, vocab_tp), aux


def loss_fn(cfg: ArchConfig, params: dict, batch: dict,
            compute_dtype=torch.bfloat16, block_kv: Optional[int] = None,
            *, remat: bool = True, unroll: int = 1,
            act_dp: Optional[tuple] = None, seq_shard: bool = False,
            layout=None):
    """Next-token cross entropy + MoE aux + z-loss: (total, {"ce", "aux",
    "z"}). batch: tokens, labels (+ prefix_embeds for vlm/audio). labels
    < 0 and >= ``cfg.vocab`` are masked; the padded columns count in the
    log-sum-exp. With ``layout`` the means are over the global batch:
    every position returns the same loss."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          batch.get("prefix_embeds"), compute_dtype,
                          block_kv, remat=remat, unroll=unroll,
                          act_dp=act_dp, seq_shard=seq_shard, layout=layout)
    logits = logits.float()
    labels = batch["labels"].long()
    mask = (labels >= 0) & (labels < cfg.vocab)
    safe = torch.where(mask, labels, 0)
    if layout is not None and layout.vocab_tp:
        lse, ll = layout.tp.vocab_lse(logits, safe)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - ll) * mask
    if layout is None:
        nll_sum, z_sum = nll.sum(), ((lse * mask) ** 2).sum()
        denom = torch.clamp(mask.sum(), min=1)
    else:
        # the mean of per-position means is wrong once a position's
        # labels are masked: sum first, then divide
        sums = layout.dp_sum(torch.stack([
            nll.sum(), ((lse * mask) ** 2).sum(),
            mask.sum().to(torch.float32)]))
        nll_sum, z_sum, denom = sums[0], sums[1], torch.clamp(sums[2], min=1)
    ce = nll_sum / denom
    z_loss = 1e-4 * z_sum / denom
    total = ce + z_loss + 1e-2 * aux
    return total, {"ce": ce, "aux": aux, "z": z_loss}


# --------------------------- prefill / decode -------------------------------

def cache_spec(cfg: ArchConfig, batch: int, s_cache: int,
               dtype=torch.bfloat16, device=None, *,
               layout=None) -> list[dict]:
    """Zero-initialised caches (one entry per pattern position), each
    leaf (n_blocks, batch, ...). With ``layout`` (a
    ``dist.collectives.Layout``; ``batch`` the global batch) only this
    process's slices of them, laid out by ``dist.sharding.cache_specs``
    on the global shapes."""
    dev = resolve_device(device)
    if layout is not None:
        from repro_torch.dist.sharding import (cache_specs, map_specs,
                                               shard_slices)
        mesh, coords = layout.mesh, layout.coords
        whole = cache_spec(cfg, batch, s_cache, dtype, "meta")
        return map_specs(lambda sp, t: torch.zeros(
            [sl.stop - sl.start for sl in shard_slices(t.shape, sp, mesh,
                                                        coords)],
            dtype=dtype, device=dev), cache_specs(cfg, mesh, whole), whole)
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


def fill_caches(caches: list[dict], prefilled: list[dict]) -> None:
    """A prefill's caches (``prefill``'s second result) into the first
    slots of larger ones (``cache_spec``'s), in place: the attention
    entries of the prompt's positions, the whole conv and ssm states."""
    for c, p in zip(caches, prefilled):
        for k in c:
            if k in ("k", "v"):
                c[k][:, :, :p[k].shape[2]] = p[k]
            else:
                c[k].copy_(p[k])


def _commit(dst: torch.Tensor, new: torch.Tensor,
            rows: Optional[torch.Tensor]) -> None:
    if rows is None:
        dst.copy_(new)
    else:
        dst[rows] = new[rows].to(dst.dtype)


def _serving(cfg: ArchConfig, params: dict, act_dp, layout) -> tuple:
    """``(params, vocab tp, tp)`` of a serving call: with ``layout`` the
    leaves outside the blocks gathered for use."""
    _check_knobs(1, act_dp, layout)
    if layout is None:
        return params, None, None
    return (layout.top(params), layout.tp if layout.vocab_tp else None,
            layout.tp)


def decode_step(cfg: ArchConfig, params: dict, token: torch.Tensor, pos,
                caches: list[dict], compute_dtype=torch.bfloat16,
                rows: Optional[torch.Tensor] = None, views=None, *,
                act_dp: Optional[tuple] = None, layout=None):
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
    steps. ``layout``: the sharded serving step (the module's
    docstring); every input is this process's part, and the logits are
    its rows over the whole vocabulary."""
    specs = pattern_specs(cfg)
    params, vocab_tp, tp = _serving(cfg, params, act_dp, layout)
    h = _lookup(params, token, compute_dtype, vocab_tp)
    if vocab_tp is not None:
        h = vocab_tp.exit(h)
    for b, block in enumerate(views or block_views(params)):
        if layout is not None:
            block = layout.block(block)
        for i, (spec, p) in enumerate(zip(specs, block)):
            mix_tp, ffn_tp = _tps(layout, i, tp)
            c = caches[i]
            xn = L.apply_norm(p["ln1"], h)
            if spec.kind == "A":
                out, _, _ = L.attention_decode(cfg, p["attn"], xn, pos,
                                               c["k"][b], c["v"][b], rows,
                                               tp=mix_tp)
            else:
                conv = c["conv"][b]
                out, conv, ssm_st = SSM.mamba_decode(
                    cfg, p["mamba"], xn,
                    conv if layout is None else layout.conv_whole(conv),
                    c["ssm"][b], tp=mix_tp,
                    conv_part=None if layout is None else layout.conv_part)
                _commit(c["conv"][b], conv, rows)
                _commit(c["ssm"][b], ssm_st, rows)
            h = h + out
            if spec.ffn is not None:
                h = h + _ffn(cfg, spec, p, h, tp=ffn_tp)[0]
    h = L.apply_norm(params["final_norm"], h)
    return _whole_logits(cfg, params, h, vocab_tp), caches


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            compute_dtype=torch.bfloat16, block_kv: Optional[int] = None,
            *, act_dp: Optional[tuple] = None, layout=None):
    """Full-sequence prefill producing the last position's logits and
    populated caches. Attention caches hold the processed sequence
    (window-truncated, in ring-buffer order, with a sliding window); mamba
    positions hold the final conv/ssm states. ``layout``: the sharded
    serving step (the module's docstring); the caches are this process's
    slices by ``cache_specs``."""
    specs = pattern_specs(cfg)
    params, vocab_tp, tp = _serving(cfg, params, act_dp, layout)
    h = _embed(cfg, params, tokens, prefix_embeds, compute_dtype, vocab_tp)
    s_total = h.shape[1]
    positions = torch.arange(s_total, device=h.device)[None]
    per_block = []
    for block in block_views(params):
        if layout is not None:
            block = layout.block(block)
        cache_out = []
        for i, (spec, p) in enumerate(zip(specs, block)):
            mix_tp, ffn_tp = _tps(layout, i, tp)
            xn = L.apply_norm(p["ln1"], h)
            if spec.kind == "A":
                out, k, v = L.attention_train(cfg, p["attn"], xn, positions,
                                              block_kv, mix_tp,
                                              return_kv=True)
                h = h + out
                if cfg.window and s_total > cfg.window:
                    # ring-buffer layout: slot j holds position p, p%W == j
                    w = cfg.window
                    start = s_total - w
                    k = torch.roll(k[:, start:], shifts=start % w, dims=1)
                    v = torch.roll(v[:, start:], shifts=start % w, dims=1)
                cache_out.append({"k": k.to(compute_dtype),
                                  "v": v.to(compute_dtype)})
            else:
                out, (conv, ssm_st) = SSM.mamba_train(
                    cfg, p["mamba"], xn, return_state=True, tp=mix_tp,
                    conv_part=None if layout is None else layout.conv_part)
                h = h + out
                cache_out.append({"conv": conv.to(compute_dtype),
                                  "ssm": ssm_st.to(compute_dtype)})
            if spec.ffn is not None:
                h = h + _ffn(cfg, spec, p, h, tp=ffn_tp)[0]
        per_block.append(cache_out)
    caches = [{key: torch.stack([blk[i][key] for blk in per_block])
               for key in per_block[0][i]} for i in range(len(specs))]
    h = L.apply_norm(params["final_norm"], h)
    return _whole_logits(cfg, params, h[:, -1:], vocab_tp), caches


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
