"""Mixture-of-Experts layer on PyTorch (port of ``repro.models.moe``), with
the reference's two dispatch implementations.

``impl='onehot'``: GShard/Switch dispatch, a (tokens, E, C) one-hot
dispatch tensor contracted with the token batch.

``impl='sorted'``: AlphaSparse-style dispatch. Routing is a sparse matrix
problem, so tokens are SORTed by expert id, scattered into a dense
per-expert capacity buffer, run through dense expert GEMMs and gathered
back: no (tokens, E, C) tensor.

Both drop overflow tokens beyond per-expert capacity (capacity_factor).
The router and its softmax run in float32, as the reference's do. In a
sharded train step (``dp``, a ``dist.collectives.Layout``) the aux
loss's expert statistics are the global batch's: their sums are summed
over the data axes before the division.

Tensor parallelism over ``model`` (``tp``, the step's
``TensorParallel``), as GSPMD partitions the reference's einsums: every
model position holds the same tokens, routes them whole (the router and
top-k run before the region, alike on every position, so the aux loss
counts once) and passes them and their gates through ``tp.enter``.
With the experts split (expert parallelism: ``w_up`` holds the
position's ``n_experts / tp`` experts) it dispatches every token as one
device does, so capacity and drops are the global ones, and runs only
its own experts' slots (in ``sorted`` the other slots go to the dropped
bucket); with the expert hidden dim split (the reference's fallback
when the experts do not divide) it runs every expert on its columns.
The combine's partial sums, and the shared experts' column/row-parallel
ones, leave through ``tp.exit``. No all-to-all is needed while the
tokens are not split over ``model``.

With the sequence split over ``model`` too (``tp.seq``, the step's
``seq_shard``) ``x`` is the position's rows of the normed tokens, and
one all-gather gives the whole sequence twice: the router's copy takes
the position's own rows of its gradient (that gradient is whole on every
position: the gates enter through ``tp.enter_whole``, the aux loss is
the same everywhere), the experts' copy the sum of the positions'
partial gradients. Gathering the tokens, not an all-to-all of each
position's own, keeps capacity and drops those of the whole sequence.
Shared experts outside the region run on the position's rows.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

from .layers import _normal, gelu

__all__ = ["init_moe", "apply_moe", "routing_matrix"]


def init_moe(cfg: ArchConfig, gen: torch.Generator, lead=()) -> dict:
    e = cfg.moe
    d, f = cfg.d_model, e.d_expert
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    E = e.n_experts
    p = {
        "router": _normal(gen, lead + (d, E), s_in),
        "w_up": _normal(gen, lead + (E, d, f), s_in),
        "w_down": _normal(gen, lead + (E, f, d), s_out),
    }
    if cfg.mlp_kind == "swiglu":
        p["w_gate"] = _normal(gen, lead + (E, d, f), s_in)
    if e.n_shared:
        fs = f * e.n_shared
        p["sh_up"] = _normal(gen, lead + (d, fs), s_in)
        p["sh_down"] = _normal(gen, lead + (fs, d), s_out)
        if cfg.mlp_kind == "swiglu":
            p["sh_gate"] = _normal(gen, lead + (d, fs), s_in)
    return p


def _expert_ffn(cfg: ArchConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    """h: (..., E, C, d) -> (..., E, C, d) through per-expert FFN."""
    up = torch.einsum("...ecd,edf->...ecf", h, p["w_up"].to(h.dtype))
    if cfg.mlp_kind == "swiglu":
        gate = torch.einsum("...ecd,edf->...ecf", h, p["w_gate"].to(h.dtype))
        act = F.silu(gate) * up
    else:
        act = gelu(up)
    return torch.einsum("...ecf,efd->...ecd", act, p["w_down"].to(h.dtype))


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives an all-zero row
    (``F.one_hot`` raises there), so the one-hot is a comparison."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _router(cfg: ArchConfig, p: dict, x: torch.Tensor, dp=None):
    """x: (B,S,d) -> top-k (gates, idx) and the load-balance aux loss
    (over the global batch with ``dp``)."""
    e = cfg.moe
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, -1)                        # (B,S,E)
    gate_vals, idx = torch.topk(probs, e.top_k, dim=-1)      # (B,S,K)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    # Switch-style aux loss: E * sum_e f_e * P_e
    routed = _one_hot(idx, e.n_experts, torch.float32).sum(-2)
    if dp is None:
        me = probs.mean((0, 1))
        ce = routed.mean((0, 1)) / e.top_k
    else:
        n = x.shape[0] * x.shape[1] * dp.n_dp          # global tokens
        sums = dp.dp_sum(torch.cat([probs.sum((0, 1)), routed.sum((0, 1))]))
        me = sums[:e.n_experts] / n
        ce = sums[e.n_experts:] / n / e.top_k
    aux = e.n_experts * torch.sum(me * ce)
    return gate_vals, idx, aux


def _capacity(cfg: ArchConfig, s: int) -> int:
    e = cfg.moe
    return max(1, int(np.ceil(s * e.top_k / e.n_experts * e.capacity_factor)))


def _moe_onehot(cfg: ArchConfig, p: dict, x: torch.Tensor, gate_vals,
                idx, e0: int = 0) -> torch.Tensor:
    """GShard dispatch-einsum implementation (group = sequence), over the
    experts ``w_up`` holds, the first of them expert ``e0``."""
    e = cfg.moe
    b, s, d = x.shape
    n_e = p["w_up"].shape[-3]
    cap = _capacity(cfg, s)
    # a position's expert columns of the one-hot: each column's count of
    # tokens is the one-device count
    oh = _one_hot(idx - e0, n_e, torch.float32)               # (B,S,K,E)
    # position of each (token, k) within its expert, counted over the seq
    pos = torch.cumsum(oh.reshape(b, s * e.top_k, n_e), dim=1) - 1.0
    pos = pos.reshape(b, s, e.top_k, n_e)
    keep = pos < cap
    # pos is -1 where a (token, k) does not route to e and may pass cap:
    # both give a zero one-hot row, as in the reference
    pos_oh = _one_hot(pos.to(torch.int64), cap, x.dtype)
    dispatch = torch.einsum("bske,bskec->bsec", (oh * keep).to(x.dtype),
                            pos_oh)                           # (B,S,E,C)
    combine = torch.einsum("bsec,bske->bsec", dispatch,
                           (oh * gate_vals[..., None]).to(x.dtype))
    h = torch.einsum("bsec,bsd->becd", dispatch, x)
    out = _expert_ffn(cfg, p, h)
    return torch.einsum("bsec,becd->bsd", combine, out)


def _moe_sorted(cfg: ArchConfig, p: dict, x: torch.Tensor, gate_vals,
                idx, e0: int = 0) -> torch.Tensor:
    """AlphaSparse-style dispatch: sort tokens by expert, scatter into a
    dense (E, C, d) capacity buffer, dense GEMMs, gather back; over the
    experts ``w_up`` holds, the first of them expert ``e0``."""
    e = cfg.moe
    b, s, d = x.shape
    k = e.top_k
    n_e = p["w_up"].shape[-3]
    cap = _capacity(cfg, s)
    flat_e = idx.reshape(b, s * k)                         # expert per slot
    # SORT operator. ``jnp.argsort`` is stable and the ranks below depend
    # on the order of equal experts: ask torch for a stable sort too
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    # rank within expert = position - start of that expert's run
    counts = _one_hot(sorted_e, e.n_experts, torch.int64).cumsum(1)
    rank = torch.gather(counts, 2, sorted_e[..., None])[..., 0] - 1
    slot_sorted = (sorted_e - e0) * cap + rank             # (B, S*K)
    # dropped: past capacity, or another position's expert
    dropped = (rank >= cap) | (sorted_e < e0) | (sorted_e >= e0 + n_e)
    slot_sorted = torch.where(dropped, n_e * cap, slot_sorted)
    # un-sort the slot assignment back to token order
    inv = torch.argsort(order, dim=1)
    slot = torch.gather(slot_sorted, 1, inv)               # (B, S*K)

    tok = torch.arange(s, device=x.device).repeat_interleave(k)
    tok = tok[None].expand(b, s * k)                       # token id
    batch_ix = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    buf = torch.zeros((b, n_e * cap + 1, d), dtype=x.dtype,
                      device=x.device)
    # kept slots are distinct, so each receives one token added to zero
    # (exact); only the dropped bucket, cut off below, takes several
    buf.index_put_((batch_ix, slot), x[batch_ix, tok], accumulate=True)
    h = buf[:, :-1].reshape(b, n_e, cap, d)
    out = _expert_ffn(cfg, p, h).reshape(b, n_e * cap, d)
    out = torch.cat([out, torch.zeros((b, 1, d), dtype=x.dtype,
                                      device=x.device)], dim=1)
    y_tok = out[batch_ix, slot]                            # (B, S*K, d)
    w = gate_vals.reshape(b, s * k, 1).to(x.dtype)
    # the reference's combine ``y.at[batch_ix, tok].add`` adds a token's k
    # expert outputs into zeros in k order; on the card ``index_add_``
    # would add them in the atomics' order, whose bits change from call to
    # call. Gather to (B, S, K, d) and add over K in order instead.
    parts = (y_tok * w).reshape(b, s, k, d)
    y = parts[:, :, 0]
    for j in range(1, k):
        y = y + parts[:, :, j]
    return y


def _shared(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The shared experts, a dense MLP (on the columns ``sh_up`` holds)."""
    up = x @ p["sh_up"].to(x.dtype)
    if cfg.mlp_kind == "swiglu":
        h = F.silu(x @ p["sh_gate"].to(x.dtype)) * up
    else:
        h = gelu(up)
    return h @ p["sh_down"].to(x.dtype)


def apply_moe(cfg: ArchConfig, p: dict, x: torch.Tensor, dp=None,
              tp=None):
    """x: (B,S,d) -> (y, aux_loss); ``dp``: the sharded step's layout;
    ``tp``: the experts are this model position's (see the module's
    docstring)."""
    e = cfg.moe
    xr = xe = x
    if tp is not None and tp.seq is not None:
        xr, xe = tp.seq.gather_twice(x)
    gate_vals, idx, aux = _router(cfg, p, xr, dp)
    e0 = 0
    if tp is not None:
        if tp.seq is None:
            xe = tp.enter(x)
        gate_vals = tp.enter_whole(gate_vals)
        n_e = p["w_up"].shape[-3]
        e0 = 0 if n_e == e.n_experts else tp.rank * n_e
    if e.impl == "sorted":
        y = _moe_sorted(cfg, p, xe, gate_vals, idx, e0)
    else:
        y = _moe_onehot(cfg, p, xe, gate_vals, idx, e0)
    # the shared experts run in the region when their columns are split
    inside = e.n_shared and (tp is None or p["sh_up"].shape[-1] * tp.size
                             == e.d_expert * e.n_shared)
    if inside:
        y = y + _shared(cfg, p, xe)
    if tp is not None:
        y = tp.exit(y)
    if e.n_shared and not inside:
        y = y + _shared(cfg, p, x)
    return y, aux


def routing_matrix(idx, gate_vals, n_experts: int):
    """The routing table as a sparse matrix: rows = tokens, cols = experts.

    Dispatch *is* SpMV: ``R[t, e] = gate`` when token t routes to expert
    e. ``idx``/``gate_vals`` are the router's top-k outputs, ``(B, S, K)``
    or ``(T, K)`` (numpy arrays or tensors on any device); batch and
    sequence axes are flattened to one token axis. Routing churn between
    steps is then ``repro_torch.dyn.PatternDelta.from_matrices(
    routing_matrix(...), routing_matrix(...))``, which the serving plane
    patches in place (every token keeps exactly K entries, so a re-route
    always fits an ELL lane of width K). Zero gates are dropped (canonical
    storage).
    """
    from repro_torch.core.matrices import SparseMatrix

    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    idx = host(idx)
    idx = idx.reshape(-1, idx.shape[-1])
    gates = np.asarray(host(gate_vals), np.float32).reshape(idx.shape)
    n_tokens, k = idx.shape
    rows = np.repeat(np.arange(n_tokens, dtype=np.int32), k)
    return SparseMatrix(n_tokens, int(n_experts), rows,
                        idx.reshape(-1).astype(np.int32),
                        gates.reshape(-1)).canonical()
