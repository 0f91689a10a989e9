"""Per-tile segmented kernels: SpMV K3, K4, K6 (wrappers over
``csrc/seg_spmv.cu``) and multi-RHS SpMM K10a, K10b, K11 (over
``csrc/seg_spmm.cu``).

Each wrapper runs its plain PyTorch version (``ref.py``) when the tensors
lie on the CPU, and launches its CUDA kernel when they lie on a GPU; it
never falls back from one to the other. ``seg_spmv.launches`` and
``seg_spmm.launches`` count launches per mode (K3/K10a ``seg_scan``,
K4/K10b ``onehot_mxu``); ``seg_spmv_fused.launches`` and
``seg_spmm_fused.launches`` count K6 and K11 launches in either mode. A
fused launch is the kernel and, where tiles share rows, the ordered
combine of their side partials (``combine.fused_rows``): one count.

Replaced TPU kernels (``src/repro/kernels/seg_spmv.py``): K3/K4
``seg_spmv_pallas``, K6 ``seg_spmv_fused_pallas``, K10a/K10b
``seg_spmm_pallas`` and K11 ``seg_spmm_fused_pallas``. What bounds them on
the H100 and how the CUDA designs answer it is written at the top of the
two sources.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .combine import FusedRows, launch_combine
from .ell_spmv import _check_tiles, _stream, _type_args
from .ref import (SEG_MODES, seg_spmm_fused_ref, seg_spmm_ref,
                  seg_spmv_fused_ref, seg_spmv_ref)

__all__ = ["seg_spmv", "seg_spmv_fused", "seg_spmm", "seg_spmm_fused"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.load_library("seg_spmv")
    if lib.seg_tiles.argtypes is None:
        lib.seg_tiles.argtypes = [_P, _I, _P, _I, _P, _I, _I, _P, _L, _I, _I,
                                  _I, _I, _P, _P, _P, _P, _I, _P]
        lib.seg_tiles.restype = _I
    return lib


def _spmm_lib() -> ctypes.CDLL:
    lib = build.load_library("seg_spmm")
    if lib.seg_spmm.argtypes is None:
        lib.seg_spmm.argtypes = [_P, _I, _P, _I, _P, _I, _I, _I, _P, _L, _I,
                                 _I, _I, _I, _P, _P, _P, _P, _I, _P]
        lib.seg_spmm.restype = _I
    return lib


def _check_seg(vals, cols, local_row, seg_end, x, seg_rows, mode, out,
               x_ndim):
    """Check the operands of a seg kernel; returns its aux array
    (seg_end for seg_scan, local_row for onehot_mxu)."""
    _check_tiles(vals, cols, x, x_ndim)
    if mode not in SEG_MODES:
        raise ValueError(f"unknown mode {mode!r} (seg_scan | onehot_mxu)")
    T = vals.shape[0]
    c = vals.shape[1] * vals.shape[2]
    aux = seg_end if mode == "seg_scan" else local_row
    want = (T, seg_rows) if mode == "seg_scan" else (T, c)
    if aux is None or aux.dtype != torch.int32 or aux.numel() != want[0] * want[1]:
        raise ValueError(f"mode {mode} needs an int32 "
                         f"{'seg_end' if mode == 'seg_scan' else 'local_row'}"
                         f" with {want[0]}x{want[1]} entries")
    for name, t in (("aux", aux), ("out", out)):
        if t.device != vals.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {vals.device}")
    if seg_rows <= 0:
        raise ValueError(f"seg_rows must be positive, got {seg_rows}")
    return aux


def _fused_operands(vals, seg_rows, rows, out) -> tuple:
    """Check the fused step's ``FusedRows`` and make a side buffer for its
    shared rows."""
    T = vals.shape[0]
    if rows is None:
        raise ValueError("a fused seg kernel needs rows= (combine.fused_rows "
                         "of its descriptors, built once with the plan)")
    if (rows.dst.dtype != torch.int32 or rows.dst.numel() != T * seg_rows
            or rows.dst.device != vals.device
            or rows.n_used.dtype != torch.int32
            or rows.n_used.shape != (T,)):
        raise ValueError(f"rows must hold an int32 dst of {T}x{seg_rows} "
                         f"entries and an int32 n_used of {T} on "
                         f"{vals.device}")
    side = torch.empty((rows.n_side,) + tuple(out.shape[1:]),
                       dtype=torch.float32, device=vals.device)
    return rows, side


def _fused_ptrs(rows, side) -> tuple:
    """The kernels' dst, n_used and side pointers (0 when not fused)."""
    if rows is None:
        return 0, 0, 0
    return rows.dst.data_ptr(), rows.n_used.data_ptr(), side.data_ptr()


def _launch(vals, cols, local_row, seg_end, x, seg_rows, mode, out,
            fused=None, tiles_per_step=1) -> None:
    """Check the operands and launch ``seg_tiles``; ``fused`` is the
    (rows, side) of a fused step, whose side the combine then adds."""
    aux = _check_seg(vals, cols, local_row, seg_end, x, seg_rows, mode, out,
                     1)
    T = vals.shape[0]
    c = vals.shape[1] * vals.shape[2]
    k = max(min(int(tiles_per_step), T), 1)
    rows, side = fused or (None, None)
    lib = _lib()
    build.check(lib, lib.seg_tiles(
        *_type_args(vals, cols, x), aux.data_ptr(), T, c, seg_rows,
        SEG_MODES.index(mode), int(fused is not None), out.data_ptr(),
        *_fused_ptrs(rows, side), k, _stream(vals)), "seg_tiles")
    if rows is not None and rows.n_side:
        launch_combine(out, side, rows.perm, rows.offsets, rows.rows)


def seg_spmv(vals, cols, local_row, seg_end, x, seg_rows: int,
             mode: str = "seg_scan") -> torch.Tensor:
    """K3 (``seg_scan``) / K4 (``onehot_mxu``): (T, S, L) nnz-split tiles
    -> (T, seg_rows) fp32 segment partials."""
    if not vals.is_cuda:
        return seg_spmv_ref(vals, cols, local_row, seg_end, x, seg_rows,
                            mode)
    out = torch.empty((vals.shape[0], seg_rows), dtype=torch.float32,
                      device=vals.device)
    _launch(vals, cols, local_row, seg_end, x, seg_rows, mode, out)
    seg_spmv.launches[mode] += 1
    return out


def seg_spmv_fused(vals, cols, local_row, seg_end, r0, x, seg_rows: int, *,
                   n_rows: int, mode: str = "seg_scan",
                   tiles_per_step: int = 1, out=None,
                   rows: FusedRows = None) -> torch.Tensor:
    """K6: add tile t's partials into ``out[r0[t] + m]`` (rows ``>= n_rows``
    dropped) and return ``out``, a fresh fp32 zero vector of ``n_rows``
    when None. Requires per-tile contiguous rows (``rowmap[t, m] = r0[t] +
    m``; the plain version on CPU tensors reads ``r0``). On the GPU,
    ``rows`` (``combine.fused_rows`` of these descriptors, which a plan
    builds once) fixes where each partial goes and is required. The sums
    are bit-identical from call to call. ``tiles_per_step`` does not change the result. In one-hot
    mode it is the number of tiles one GPU block walks (clamped to [1,
    T]); in seg_scan mode it does not set the grid either: a block takes
    the ceil(2048 / C) tiles of one 2048-slot pass (``csrc/seg_spmv.cu``)."""
    if not vals.is_cuda:
        return seg_spmv_fused_ref(vals, cols, local_row, seg_end, r0, x,
                                  seg_rows, n_rows=n_rows, mode=mode,
                                  out=out)
    if out is None:
        out = torch.zeros(n_rows, dtype=torch.float32, device=vals.device)
    if out.dtype != torch.float32 or out.shape != (n_rows,):
        raise ValueError("out must be an fp32 (n_rows,) tensor")
    _check_seg(vals, cols, local_row, seg_end, x, seg_rows, mode, out, 1)
    fused = _fused_operands(vals, seg_rows, rows, out)
    _launch(vals, cols, local_row, seg_end, x, seg_rows, mode, out, fused,
            tiles_per_step)
    seg_spmv_fused.launches += 1
    return out


# ----------------------------- multi-RHS (SpMM) -----------------------------

def _spmm_launch(vals, cols, local_row, seg_end, x, seg_rows, mode, out,
                 fused=None, tiles_per_step=1) -> None:
    """Check the operands and launch ``seg_spmm``; ``fused`` as in
    :func:`_launch`."""
    aux = _check_seg(vals, cols, local_row, seg_end, x, seg_rows, mode, out,
                     2)
    T = vals.shape[0]
    c = vals.shape[1] * vals.shape[2]
    k = max(min(int(tiles_per_step), T), 1)
    rows, side = fused or (None, None)
    lib = _spmm_lib()
    build.check(lib, lib.seg_spmm(
        *_type_args(vals, cols, x), x.shape[1], aux.data_ptr(), T, c,
        seg_rows, SEG_MODES.index(mode), int(fused is not None),
        out.data_ptr(), *_fused_ptrs(rows, side), k, _stream(vals)),
        "seg_spmm")
    if rows is not None and rows.n_side:
        launch_combine(out, side, rows.perm, rows.offsets, rows.rows)


def seg_spmm(vals, cols, local_row, seg_end, x, seg_rows: int,
             mode: str = "seg_scan") -> torch.Tensor:
    """K10a (``seg_scan``) / K10b (``onehot_mxu``): (T, S, L) nnz-split
    tiles, x (n_cols, B) -> (T, seg_rows, B) fp32 segment partials."""
    if not vals.is_cuda:
        return seg_spmm_ref(vals, cols, local_row, seg_end, x, seg_rows,
                            mode)
    _check_tiles(vals, cols, x, 2)
    out = torch.empty((vals.shape[0], seg_rows, x.shape[1]),
                      dtype=torch.float32, device=vals.device)
    _spmm_launch(vals, cols, local_row, seg_end, x, seg_rows, mode, out)
    seg_spmm.launches[mode] += 1
    return out


def seg_spmm_fused(vals, cols, local_row, seg_end, r0, x, seg_rows: int, *,
                   n_rows: int, mode: str = "seg_scan",
                   tiles_per_step: int = 1, out=None,
                   rows: FusedRows = None) -> torch.Tensor:
    """K11: add tile t's (seg_rows, B) partials into ``out[r0[t] + m, :]``
    (rows ``>= n_rows`` dropped) and return ``out``, a fresh fp32
    (n_rows, B) zero tensor when None. Requires per-tile contiguous rows.
    ``rows`` as for :func:`seg_spmv_fused`; the sums are bit-identical
    from call to call. ``tiles_per_step`` does not change the result, and
    on the GPU it does not set the grid either: a block takes the
    ceil(2048 / C) tiles of one 2048-slot pass (``csrc/seg_spmm.cu``)."""
    if not vals.is_cuda:
        return seg_spmm_fused_ref(vals, cols, local_row, seg_end, r0, x,
                                  seg_rows, n_rows=n_rows, mode=mode,
                                  out=out)
    _check_tiles(vals, cols, x, 2)
    B = x.shape[1]
    if out is None:
        out = torch.zeros((n_rows, B), dtype=torch.float32,
                          device=vals.device)
    if out.dtype != torch.float32 or out.shape != (n_rows, B):
        raise ValueError("out must be an fp32 (n_rows, B) tensor")
    _check_seg(vals, cols, local_row, seg_end, x, seg_rows, mode, out, 2)
    fused = _fused_operands(vals, seg_rows, rows, out)
    _spmm_launch(vals, cols, local_row, seg_end, x, seg_rows, mode, out,
                 fused, tiles_per_step)
    seg_spmm_fused.launches += 1
    return out


seg_spmv.launches = {m: 0 for m in SEG_MODES}
seg_spmv_fused.launches = 0
seg_spmm.launches = {m: 0 for m in SEG_MODES}
seg_spmm_fused.launches = 0
