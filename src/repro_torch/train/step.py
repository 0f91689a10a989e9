"""The train step: loss -> gradients -> (compressed) gradients -> AdamW
(port of ``repro.train.step``).

Gradients come from autograd over the parameter tree's leaves
(``torch.autograd.grad`` of ``models.loss_fn``). ``grad_accum > 1``
splits the batch's leading dimension into micro-batches, sums their
float32 gradients in order from zeros and divides by ``grad_accum``, as
the reference's ``lax.scan`` does; the optimizer then steps once.

The state is ``{"params", "opt", "err"}`` (``err`` only with compression
on), every leaf float32 (``opt["count"]`` int32). The step updates it in
place (``optimizer.adamw_update``) and returns it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import loss_fn
from .compression import CompressionConfig, compress_decompress, \
    init_error_state
from .optimizer import AdamWConfig, _map, adamw_init, adamw_update, \
    tree_leaves

__all__ = ["TrainConfig", "make_train_step", "make_grad_fn", "init_state"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    compression: CompressionConfig = CompressionConfig()
    compute_dtype: str = "bfloat16"
    remat: bool = True
    grad_accum: int = 1
    block_kv: Optional[int] = None
    scan_unroll: int = 1
    act_dp: Optional[tuple] = None   # dp axes for activation constraints
    seq_shard: bool = False          # sequence parallelism
    cast_params_bf16: bool = False   # run the forward on bf16 copies of
    # the float32 matrices (float32 master copies stay in the optimizer)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}


def _to_device(batch: dict, device) -> dict:
    out = {}
    for k, a in batch.items():
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        out[k] = a.to(device)
    return out


def make_grad_fn(cfg: ArchConfig, tc: TrainConfig):
    """``grad_fn(params, batch) -> ((loss, parts), grads)``: the loss of
    ``tc``'s forward (compute dtype, remat, ``cast_params_bf16``) and its
    gradients with respect to every parameter leaf, shaped like
    ``params`` (float32 for float32 parameters). ``compute_dtype``
    "float64" (a reference check, on float64 parameters) is accepted
    beside the reference's two."""
    dtype = _DTYPES[tc.compute_dtype]

    def loss_wrap(params, batch):
        p = params
        if tc.cast_params_bf16:
            p = _map(lambda a: a.to(torch.bfloat16)
                     if a.dtype == torch.float32 and a.ndim >= 2 else a, p)
        return loss_fn(cfg, p, batch, dtype, tc.block_kv, remat=tc.remat,
                       unroll=tc.scan_unroll, act_dp=tc.act_dp,
                       seq_shard=tc.seq_shard)

    def grad_fn(params, batch):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        req = _rebuild(params, iter(leaves))
        with torch.enable_grad():
            loss, parts = loss_wrap(req, batch)
            gl = torch.autograd.grad(loss, leaves, allow_unused=True)
        gl = iter([torch.zeros_like(t) if g is None else g
                   for t, g in zip(leaves, gl)])
        return ((loss.detach(), {k: v.detach() for k, v in parts.items()}),
                _rebuild(params, gl))

    return grad_fn


def make_train_step(cfg: ArchConfig, tc: TrainConfig, grad_specs=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds ``tokens`` and ``labels`` (numpy arrays or tensors), moved to the
    parameters' device. ``metrics`` are ``{"loss", "lr", "grad_norm"}``
    and, without gradient accumulation, the loss's parts ``ce``, ``aux``
    and ``z``: 0-d tensors.

    ``grad_specs`` anchors the reference's gradient sharding to its FSDP
    layout; on one card there is none, and only None is accepted."""
    if grad_specs is not None:
        raise NotImplementedError(
            "grad_specs shards gradients over a mesh; on one card pass None")
    if tc.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {tc.grad_accum}")
    grad_fn = make_grad_fn(cfg, tc)

    def train_step(state, batch):
        params = state["params"]
        device = tree_leaves(params)[0].device
        batch = _to_device(batch, device)
        if tc.grad_accum > 1:
            n = tc.grad_accum
            micro = {k: a.reshape(n, a.shape[0] // n, *a.shape[1:])
                     for k, a in batch.items()}
            grads = _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(n):
                (l, _), g = grad_fn(params, {k: a[i]
                                             for k, a in micro.items()})
                _map(lambda acc, gi: acc.add_(gi), grads, g)
                loss = loss + l
                del g
            grads = _map(lambda g: g.div_(n), grads)
            loss = loss / n
            parts = {}
        else:
            (loss, parts), grads = grad_fn(params, batch)

        new_state = dict(state)
        if tc.compression.enabled:
            grads, new_err = compress_decompress(tc.compression, grads,
                                                 state["err"])
            new_state["err"] = new_err
        new_params, new_opt, opt_metrics = adamw_update(
            tc.opt, grads, params, state["opt"])
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        metrics = {"loss": loss, **opt_metrics, **parts}
        return new_state, metrics

    return train_step


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken in flattening order
    (dict keys sorted) from the iterator ``it``."""
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def init_state(cfg: ArchConfig, tc: TrainConfig, params) -> dict:
    """``{"params", "opt"}`` (+ ``"err"`` with compression on)."""
    state = {"params": params, "opt": adamw_init(params)}
    if tc.compression.enabled:
        state["err"] = init_error_state(params)
    return state
