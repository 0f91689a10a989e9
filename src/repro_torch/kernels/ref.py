"""Plain PyTorch versions of the SpMV kernels K1-K6 and of the multi-RHS
(SpMM) kernels K7-K11.

Port of ``repro.kernels.ref``, plus plain versions of the four fused
kernels and of the ordered rowmap combine of the sharded plans. Each is
the definition its CUDA kernel is held to: the wrappers in
``ell_spmv.py`` / ``seg_spmv.py`` / ``combine.py`` call these for CPU
tensors, the ``torch`` backend of the kernel builder runs them, and
``chip_smoke.py`` compares every kernel with its plain version on the
card. Like the kernels they upcast mixed-precision storage (bfloat16
vals, int16 cols) and accumulate in float32.
"""
from __future__ import annotations

import torch

__all__ = ["ell_spmv_ref", "ell_spmv_direct_ref", "ell_spmv_fused_ref",
           "seg_spmv_ref", "seg_spmv_fused_ref", "ell_spmm_ref",
           "ell_spmm_direct_ref", "ell_spmm_fused_ref", "seg_spmm_ref",
           "seg_spmm_fused_ref", "rowmap_combine_ref", "SEG_MODES"]

SEG_MODES = ("seg_scan", "onehot_mxu")


def _gather(x, cols):
    return x[cols.long()].float()


def ell_spmv_ref(vals, cols, x) -> torch.Tensor:
    """K1. vals, cols: (T, R, W); x: (n_cols,) -> fp32 partials (T, R),
    ``out[t, r] = sum_w vals[t, r, w] * x[cols[t, r, w]]``.
    Padded entries must carry val=0.

    The sum runs over w in order (a scan, which on the CPU accumulates in
    float64), so zero padding after a row's entries never changes it: a
    row packed at another width sums to the same bits. ``.sum`` groups
    the terms by W, and then a plan patched in place
    (``repro_torch.dyn``) and a fresh compile that put a row in another
    width bucket would differ in the last bit."""
    prod = vals.float() * _gather(x, cols)
    if prod.shape[-1] == 0:
        return prod.sum(dim=-1)
    return torch.cumsum(prod, dim=-1)[..., -1]


def ell_spmv_direct_ref(vals, cols, x) -> torch.Tensor:
    """K2. K1's sums as the flat (T*R,) slab of contiguous output rows."""
    return ell_spmv_ref(vals, cols, x).reshape(-1)


def ell_spmv_fused_ref(vals, cols, x, *, n_rows: int, row0: int = 0,
                       out=None) -> torch.Tensor:
    """K5. Tile row ``i = t*R + r`` is output row ``row0 + i`` (affine
    slope-1 rowmap); its sum is added to ``out`` (fresh zeros when None)
    and rows ``>= n_rows`` are dropped. Returns ``out``.

    The Pallas kernel processes ``tiles_per_step`` tiles per grid step
    and pads the tile count with zero tiles; neither changes the sums,
    so the definition has no such parameter."""
    flat = ell_spmv_ref(vals, cols, x).reshape(-1)
    if out is None:
        out = torch.zeros(n_rows, dtype=torch.float32, device=flat.device)
    hi = min(row0 + flat.numel(), n_rows)
    if hi > row0:
        out[row0:hi] += flat[:hi - row0]
    return out


def _scan_partials(cs, seg_end) -> torch.Tensor:
    """``g[m] - g[m-1]`` per tile from the in-tile inclusive cumsum ``cs``
    ((T, C) or (T, C, B)): ``g[m] = cs[e-1]`` with ``e = end[m]`` clamped
    to [0, C], and 0 where ``e = 0``. An end past the tile takes the whole
    tile's sum, as the CUDA kernels do; the Pallas kernels' ``jnp.take``
    fills NaN there in interpret mode."""
    end = seg_end.long().clamp(0, cs.shape[1])
    at = (end - 1).clamp(min=0)
    hit = end > 0
    if cs.dim() == 3:
        at = at.unsqueeze(-1).expand(-1, -1, cs.shape[2])
        hit = hit.unsqueeze(-1)
    g = torch.where(hit, torch.gather(cs, 1, at),
                    torch.zeros((), dtype=torch.float32, device=cs.device))
    g_prev = torch.cat([torch.zeros_like(g[:, :1]), g[:, :-1]], dim=1)
    return g - g_prev


def seg_spmv_ref(vals, cols, local_row, seg_end, x, seg_rows: int,
                 mode: str = "seg_scan") -> torch.Tensor:
    """K3 / K4. vals/cols/local_row: (T, S, L); seg_end: (T, M) exclusive
    in-tile end positions -> per-tile fp32 row partials (T, M).

    mode='seg_scan'  : in-tile inclusive cumsum ``cs`` of the products,
                       ``g[m] = cs[e-1]``, ``e = end[m]`` clamped to
                       [0, C] (0 where ``e = 0``), partial ``g[m] -
                       g[m-1]`` (K3).
    mode='onehot_mxu': ``partial[m] = sum_c prod[c] * [local[c] = m]``;
                       slots outside [0, M) contribute nothing (K4).
    """
    T = vals.shape[0]
    prod = (vals.float() * _gather(x, cols)).reshape(T, -1)
    if mode == "onehot_mxu":
        local = local_row.reshape(T, -1).long()
        hit = (local >= 0) & (local < seg_rows)
        out = torch.zeros(T, seg_rows, dtype=torch.float32,
                          device=prod.device)
        return out.scatter_add_(1, torch.where(hit, local, 0),
                                torch.where(hit, prod, 0.0))
    if mode != "seg_scan":
        raise ValueError(f"unknown mode {mode!r} (seg_scan | onehot_mxu)")
    return _scan_partials(torch.cumsum(prod, dim=1), seg_end)


def seg_spmv_fused_ref(vals, cols, local_row, seg_end, r0, x, seg_rows: int,
                       *, n_rows: int, mode: str = "seg_scan",
                       out=None) -> torch.Tensor:
    """K6. K3 or K4 partials *added* at ``out[r0[t] + m]``: a row that
    straddles tiles receives one add per tile. Rows ``>= n_rows`` are
    dropped. Returns ``out`` (fresh zeros when None).

    As for K5, the Pallas kernel's ``tiles_per_step`` megatiles and zero
    padding tiles add exactly zero, so they are not part of the
    definition."""
    part = seg_spmv_ref(vals, cols, local_row, seg_end, x, seg_rows, mode)
    rows = r0.long()[:, None] + torch.arange(seg_rows, device=part.device)
    keep = rows < n_rows
    if out is None:
        out = torch.zeros(n_rows, dtype=torch.float32, device=part.device)
    out.index_add_(0, torch.where(keep, rows, 0).reshape(-1),
                   torch.where(keep, part, 0.0).reshape(-1))
    return out


# ----------------------------- multi-RHS (SpMM) -----------------------------
# x is (n_cols, B): column b is the b-th right-hand side, and one gathered
# row x[col] holds all B values.

def ell_spmm_ref(vals, cols, x) -> torch.Tensor:
    """K7. vals, cols: (T, R, W); x: (n_cols, B) -> fp32 (T, R, B),
    ``out[t, r, b] = sum_w vals[t, r, w] * x[cols[t, r, w], b]``."""
    return (vals.float().unsqueeze(-1) * _gather(x, cols)).sum(dim=-2)


def ell_spmm_direct_ref(vals, cols, x) -> torch.Tensor:
    """K8. K7's sums as the (T*R, B) slab of contiguous output rows."""
    out = ell_spmm_ref(vals, cols, x)
    return out.reshape(-1, out.shape[-1])


def ell_spmm_fused_ref(vals, cols, x, *, n_rows: int, row0: int = 0,
                       out=None) -> torch.Tensor:
    """K9. Tile row ``i = t*R + r`` is output row ``row0 + i``; its B sums
    are added to ``out`` (fresh (n_rows, B) zeros when None) and rows
    ``>= n_rows`` are dropped. Returns ``out``."""
    flat = ell_spmm_direct_ref(vals, cols, x)
    if out is None:
        out = torch.zeros((n_rows, flat.shape[1]), dtype=torch.float32,
                          device=flat.device)
    hi = min(row0 + flat.shape[0], n_rows)
    if hi > row0:
        out[row0:hi] += flat[:hi - row0]
    return out


def seg_spmm_ref(vals, cols, local_row, seg_end, x, seg_rows: int,
                 mode: str = "seg_scan") -> torch.Tensor:
    """K10a / K10b. vals/cols/local_row: (T, S, L); seg_end: (T, M);
    x: (n_cols, B) -> fp32 (T, M, B). The two modes of ``seg_spmv_ref``,
    run once for all B columns: ``seg_scan`` scans the (C, B) products
    along the nnz axis and takes ``g[m] - g[m-1]`` with
    ``g[m] = cs[e-1]``, ``e = end[m]`` clamped to [0, C] (0 where
    ``e = 0``); ``onehot_mxu`` sums
    each product into its local row (slots outside [0, M) add nothing)."""
    T = vals.shape[0]
    B = x.shape[1]
    prod = (vals.float().unsqueeze(-1) * _gather(x, cols)).reshape(T, -1, B)
    if mode == "onehot_mxu":
        local = local_row.reshape(T, -1).long()
        hit = (local >= 0) & (local < seg_rows)
        out = torch.zeros(T, seg_rows, B, dtype=torch.float32,
                          device=prod.device)
        idx = torch.where(hit, local, 0).unsqueeze(-1).expand(-1, -1, B)
        return out.scatter_add_(1, idx,
                                torch.where(hit.unsqueeze(-1), prod, 0.0))
    if mode != "seg_scan":
        raise ValueError(f"unknown mode {mode!r} (seg_scan | onehot_mxu)")
    return _scan_partials(torch.cumsum(prod, dim=1), seg_end)


def seg_spmm_fused_ref(vals, cols, local_row, seg_end, r0, x, seg_rows: int,
                       *, n_rows: int, mode: str = "seg_scan",
                       out=None) -> torch.Tensor:
    """K11. K10 partials *added* at ``out[r0[t] + m, :]``: a row that
    straddles tiles receives one add per tile. Rows ``>= n_rows`` are
    dropped. Returns ``out`` (fresh (n_rows, B) zeros when None)."""
    part = seg_spmm_ref(vals, cols, local_row, seg_end, x, seg_rows, mode)
    B = part.shape[-1]
    rows = r0.long()[:, None] + torch.arange(seg_rows, device=part.device)
    keep = rows < n_rows
    if out is None:
        out = torch.zeros((n_rows, B), dtype=torch.float32,
                          device=part.device)
    out.index_add_(0, torch.where(keep, rows, 0).reshape(-1),
                   torch.where(keep.unsqueeze(-1), part, 0.0).reshape(-1, B))
    return out


def rowmap_combine_ref(y, flat, perm, offsets, rows=None) -> torch.Tensor:
    """The ordered rowmap combine: ``y[r] += flat[perm[j]]`` for the j in
    ``[offsets[u], offsets[u+1])``, in that order, output row by output
    row, where r = u, or ``rows[u]`` given a compact list of distinct
    rows. ``y`` is (n_rows,) or (n_rows, B) fp32 and ``flat`` (N,) or (N,
    B); ``perm`` holds the flat indices sorted by their row
    (``combine_order``). Returns ``y``, added to in place."""
    counts = offsets[1:] - offsets[:-1]
    out = (torch.arange(counts.numel(), device=y.device) if rows is None
           else rows.long())
    return y.index_add_(0, torch.repeat_interleave(out, counts.long()),
                        flat[perm.long()])
