"""Mamba-2 block (SSD, state-space duality) on PyTorch (port of
``repro.models.ssm``).

Training and prefill use the chunked SSD algorithm: quadratic
attention-like computation inside chunks of length Q, linear state
passing between chunks (the reference's ``lax.scan``, as a loop). Decode
is the O(1) recurrence on a (B, H, P, N) state plus a depthwise-conv ring
state.

Shapes: d_in = expand*d_model, H = d_in/head_dim heads, P = head_dim,
N = d_state, G = 1 (single B/C group). ``A_log``, ``dt_bias`` and
``gate_norm`` are applied in float32, as the reference does.

Tensor parallelism over ``model`` (``mamba_train``'s ``tp``, the sharded
step's ``TensorParallel``; ``out_proj`` then holds the rows of the
position's ``heads / tp`` heads): the position takes from the whole
``in_proj`` its heads' z, x and dt columns and all of B and C, which
every head shares, convolves its x channels and all B/C channels, runs
the SSD scan on its heads, and leaves through ``tp.exit`` after the
row-parallel ``out_proj``. The gated RMSNorm averages over all of
``d_in``: its sum of squares is summed over ``model`` (``tp.sum``).

Serving (prefill's ``mamba_train(return_state=True)`` and
``mamba_decode``) takes the same ``tp``: the SSM state is the position's
heads. The conv cache keeps the reference's layout, which
``dist.sharding.cache_specs`` cuts into contiguous chunks of channels
over ``model`` (``Layout.conv_part``): a chunk is neither the
position's heads' x channels nor B and C. So decode takes the whole conv
state (the caller all-gathers its chunks: ``(B, W-1, ch)``, small),
convolves the channels its heads need, and returns ``conv_part``'s
chunk of the new state: the old chunk shifted by one and, for the new
row, the chunk's columns of the whole ``in_proj`` (which the position
holds whole) applied to the token. Prefill's conv state is the same
columns applied to the last ``W - 1`` tokens.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

from .layers import _normal

__all__ = ["init_mamba", "ssd_chunked", "mamba_train", "mamba_decode"]


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.d_state          # x, B, C pass through the conv
    return d_in, n_heads, s.head_dim, s.d_state, conv_ch


def init_mamba(cfg: ArchConfig, gen: torch.Generator, lead=()) -> dict:
    d = cfg.d_model
    d_in, H, P, N, conv_ch = _dims(cfg)
    s = cfg.ssm
    dev = gen.device
    proj_out = 2 * d_in + 2 * N + H          # z, xBC, dt

    def const(v):
        return v.to(dev).expand(lead + v.shape).clone()

    return {
        "in_proj": _normal(gen, lead + (d, proj_out), 1.0 / math.sqrt(d)),
        "conv_w": _normal(gen, lead + (conv_ch, s.conv_width),
                          1.0 / math.sqrt(s.conv_width)),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=torch.float32,
                              device=dev),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, H,
                                                dtype=torch.float32))),
        "dt_bias": const(torch.log(torch.expm1(torch.linspace(
            0.001, 0.1, H, dtype=torch.float32)))),
        "D": torch.ones(lead + (H,), dtype=torch.float32, device=dev),
        "gate_norm": torch.ones(lead + (d_in,), dtype=torch.float32,
                                device=dev),
        "out_proj": _normal(gen, lead + (d_in, d), 1.0 / math.sqrt(d_in)),
    }


def _conv_train(p: dict, xbc: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, S, conv_ch)."""
    w = p["conv_w"].to(xbc.dtype)            # (ch, W)
    width = w.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    s = xbc.shape[1]
    out = 0                                  # the reference's sum(): 0 + ...
    for i in range(width):
        out = out + pad[:, i: i + s, :] * w[:, i]
    return F.silu(out + p["conv_b"].to(xbc.dtype))


def _segsum_decay(dA: torch.Tensor):
    """dA: (B, C, Q, H) -> lower-tri decay L: (B, C, H, Q, Q) and the
    inclusive cumsum css: (B, C, Q, H).

    The exponent is masked before ``exp`` (-inf above the diagonal): the
    reference's ``where(tri, exp(diff), 0)`` gives the same values, but
    above the diagonal ``diff`` is positive and its ``exp`` overflows
    once a chunk's decays are large (mamba2-1.3b at full width), and the
    ``where``'s backward then multiplies that inf by 0: NaN gradients."""
    css = torch.cumsum(dA, dim=2)                      # inclusive
    cssh = css.movedim(-1, 2)                          # (B,C,H,Q)
    diff = cssh[..., :, None] - cssh[..., None, :]     # (B,C,H,Q,Q) l,s
    q = diff.shape[-1]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dA.device))
    return torch.exp(torch.where(tri, diff, float("-inf"))), css


def ssd_chunked(xdt: torch.Tensor, dA: torch.Tensor, B_: torch.Tensor,
                C_: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None):
    """Chunked SSD scan.

    xdt: (B,S,H,P) input*dt; dA: (B,S,H); B_,C_: (B,S,N) (G=1).
    Returns (y: (B,S,H,P), final_state: (B,H,P,N)).
    """
    b, s, h, pdim = xdt.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q
    xdt = xdt.reshape(b, nc, q, h, pdim)
    dA = dA.reshape(b, nc, q, h)
    Bc = B_.reshape(b, nc, q, n)
    Cc = C_.reshape(b, nc, q, n)

    L, css = _segsum_decay(dA)                          # L:(B,nc,H,Q,Q)
    y_diag = torch.einsum("bcln,bcsn,bchls,bcshp->bclhp", Cc, Bc,
                          L.to(xdt.dtype), xdt)

    chunk_last = css[:, :, -1, :]                       # (B,nc,H)
    decay_states = torch.exp(chunk_last[:, :, None, :] - css)  # (B,nc,Q,H)
    states = torch.einsum("bcsn,bcsh,bcshp->bchpn", Bc,
                          decay_states.to(xdt.dtype), xdt)

    prev = (torch.zeros((b, h, pdim, n), dtype=xdt.dtype, device=xdt.device)
            if init_state is None else init_state.to(xdt.dtype))
    prev_states = []
    for c in range(nc):
        prev_states.append(prev)
        dec = torch.exp(chunk_last[:, c].float())[..., None, None]
        prev = prev * dec.to(prev.dtype) + states[:, c]
    final_state = prev
    prev_states = torch.stack(prev_states, dim=1)       # (B,nc,H,P,N)

    in_decay = torch.exp(css)                           # (B,nc,Q,H)
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, prev_states,
                         in_decay.to(xdt.dtype))
    y = (y_diag + y_off).reshape(b, s, h, pdim)
    return y, final_state


def _gated_out(p: dict, y: torch.Tensor, z: torch.Tensor,
               dtype, tp=None, d_in: int = 0) -> torch.Tensor:
    """Gated RMSNorm (mamba2's norm before the out-projection), in float32
    with the float32 ``gate_norm``, then the out-projection. With ``tp``,
    ``y``/``z`` are the position's ``d_in / tp`` channels: the sum of
    squares is summed over ``model`` and divided by ``d_in``."""
    g = y * F.silu(z)
    if tp is None:
        var = (g.float() ** 2).mean(-1, keepdim=True)
    else:
        var = tp.sum((g.float() ** 2).sum(-1, keepdim=True)) / d_in
    g = (g.float() * torch.rsqrt(var + 1e-6) * p["gate_norm"]).to(dtype)
    return g @ p["out_proj"].to(dtype)


def _tp_part(cfg: ArchConfig, p: dict, rank: int) -> tuple:
    """A tensor-parallel position's part of whole Mamba leaves (the heads
    ``out_proj``'s rows hold, part ``rank``): ``(p, heads)``, ``p`` with
    ``in_proj``'s columns z, x, B, C, dt and the conv's channels x, B, C
    of those heads (B and C whole), their ``A_log``/``dt_bias``/``D``
    and ``gate_norm``."""
    d_in, H, P, N, conv_ch = _dims(cfg)
    dl = p["out_proj"].shape[0]
    c0, h0, hl = rank * dl, rank * dl // P, dl // P
    w, cw, cb = p["in_proj"], p["conv_w"], p["conv_b"]
    q = dict(p)
    q["in_proj"] = torch.cat([w[:, c0:c0 + dl],
                              w[:, d_in + c0:d_in + c0 + dl],
                              w[:, 2 * d_in:2 * d_in + 2 * N],
                              w[:, 2 * d_in + 2 * N + h0:
                                2 * d_in + 2 * N + h0 + hl]], dim=1)
    q["conv_w"] = torch.cat([cw[c0:c0 + dl], cw[d_in:]])
    q["conv_b"] = torch.cat([cb[c0:c0 + dl], cb[d_in:]])
    for k in ("A_log", "dt_bias", "D"):
        q[k] = p[k][h0:h0 + hl]
    q["gate_norm"] = p["gate_norm"][c0:c0 + dl]
    return q, hl


def _conv_rows(p: dict, x: torch.Tensor, d_in: int, part) -> torch.Tensor:
    """Channels ``part`` of the conv input x @ in_proj[:, xBC] for the
    rows of ``x``, from the whole ``in_proj``."""
    lo, hi = part
    return x @ p["in_proj"][:, d_in + lo:d_in + hi].to(x.dtype)


def mamba_train(cfg: ArchConfig, p: dict, x: torch.Tensor,
                return_state: bool = False, tp=None, conv_part=None):
    """x: (B,S,d) -> (B,S,d). Set return_state for prefill (conv and ssm
    states; ``conv_part`` ``(lo, hi)``: the conv state's channels to
    return, all by default). ``tp``: this model position's heads (see the
    module's docstring); its ssm state is theirs."""
    d_in, H, P, N, conv_ch = _dims(cfg)
    d_full, whole = d_in, p
    lo, hi = conv_part or (0, conv_ch)
    if tp is not None:
        x = tp.enter(x)
        p, H = _tp_part(cfg, p, tp.rank)
        d_in, conv_ch = H * P, H * P + 2 * N
    proj = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt_raw = (proj[..., :d_in], proj[..., d_in:d_in + conv_ch],
                      proj[..., d_in + conv_ch:])
    xbc_conv = _conv_train(p, xbc)
    xs = xbc_conv[..., :d_in]
    B_ = xbc_conv[..., d_in:d_in + N]
    C_ = xbc_conv[..., d_in + N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])      # (B,S,H)
    A = -torch.exp(p["A_log"])                          # (H,)
    xh = xs.reshape(*xs.shape[:2], H, P)
    xdt = xh * dt[..., None].to(x.dtype)
    dA = dt * A                                         # (B,S,H) fp32
    y, state = ssd_chunked(xdt, dA.float(), B_, C_, cfg.ssm.chunk)
    y = y + p["D"].to(x.dtype)[None, None, :, None] * xh
    y = y.reshape(*x.shape[:2], d_in)
    out = _gated_out(p, y, z, x.dtype, tp, d_full)
    if tp is not None:
        out = tp.exit(out)
    if not return_state:
        return out
    width = p["conv_w"].shape[1]
    if tp is None:
        conv_state = xbc[:, -(width - 1):, lo:hi]       # (B, W-1, ch)
    else:
        conv_state = _conv_rows(whole, x[:, -(width - 1):], d_full,
                                (lo, hi))
    return out, (conv_state, state)


def mamba_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor,
                 tp=None, conv_part=None):
    """One-token decode. x: (B,1,d); conv_state: the whole (B, W-1, ch);
    ssm_state: (B,H,P,N), with ``tp`` the position's heads' (see the
    module's docstring). Returns (out, conv_state, ssm_state), new
    tensors: the caller commits them (``model.decode_step``); the conv
    state's channels ``conv_part`` ``(lo, hi)`` (all by default)."""
    d_in, H, P, N, conv_ch = _dims(cfg)
    d_full, whole = d_in, p
    lo, hi = conv_part or (0, conv_ch)
    state = conv_state
    if tp is not None:
        x = tp.enter(x)
        p, H = _tp_part(cfg, p, tp.rank)
        c0 = tp.rank * H * P
        d_in, conv_ch = H * P, H * P + 2 * N
        # the conv channels of the position's heads: its x, all of B, C
        state = torch.cat([conv_state[..., c0:c0 + d_in],
                           conv_state[..., d_full:]], -1)
    proj = x[:, 0] @ p["in_proj"].to(x.dtype)          # (B, proj_out)
    z, xbc, dt_raw = (proj[..., :d_in], proj[..., d_in:d_in + conv_ch],
                      proj[..., d_in + conv_ch:])
    w = p["conv_w"].to(x.dtype)                         # (ch, W)
    full = torch.cat([state.to(x.dtype), xbc[:, None]], 1)
    conv_out = F.silu(torch.einsum("bwc,cw->bc", full, w)
                      + p["conv_b"].to(x.dtype))
    if tp is None:
        new_conv_state = full[:, 1:, lo:hi]
    else:
        new_conv_state = torch.cat([
            conv_state[:, 1:, lo:hi].to(x.dtype),
            _conv_rows(whole, x[:, 0], d_full, (lo, hi))[:, None]], 1)
    xs, B_, C_ = (conv_out[..., :d_in], conv_out[..., d_in:d_in + N],
                  conv_out[..., d_in + N:])
    dt = F.softplus(dt_raw.float() + p["dt_bias"])     # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                              # (B,H)
    xh = xs.reshape(-1, H, P)
    xdt = xh * dt[..., None].to(x.dtype)
    new_state = (ssm_state * dA[..., None, None].to(ssm_state.dtype)
                 + xdt[..., None] * B_[:, None, None, :].to(ssm_state.dtype))
    y = torch.einsum("bhpn,bn->bhp", new_state.to(x.dtype), C_)
    y = y + p["D"].to(x.dtype)[None, :, None] * xh
    y = y.reshape(-1, d_in)
    out = _gated_out(p, y, z, x.dtype, tp, d_full)[:, None]
    if tp is not None:
        out = tp.exit(out)
    return out, new_conv_state, new_state
