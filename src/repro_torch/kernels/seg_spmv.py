"""Per-tile segmented SpMV kernels K3, K4, K6: wrappers over
``csrc/seg_spmv.cu``.

Each wrapper runs its plain PyTorch version (``ref.py``) when the tensors
lie on the CPU, and launches its CUDA kernel when they lie on a GPU; it
never falls back from one to the other. ``seg_spmv.launches`` counts
launches per mode (K3 ``seg_scan``, K4 ``onehot_mxu``);
``seg_spmv_fused.launches`` counts K6 launches in either mode.

Replaced TPU kernels (``src/repro/kernels/seg_spmv.py``): K3/K4
``seg_spmv_pallas`` and K6 ``seg_spmv_fused_pallas``. What bounds them on
the H100 and how the CUDA design answers it is written at the top of
``csrc/seg_spmv.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ell_spmv import _check_tiles, _stream, _type_args
from .ref import SEG_MODES, seg_spmv_fused_ref, seg_spmv_ref

__all__ = ["seg_spmv", "seg_spmv_fused"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.load_library("seg_spmv")
    if lib.seg_tiles.argtypes is None:
        lib.seg_tiles.argtypes = [_P, _I, _P, _I, _P, _I, _I, _P, _L, _I, _I,
                                  _I, _I, _P, _P, _L, _I, _P]
        lib.seg_tiles.restype = _I
    return lib


def _launch(vals, cols, local_row, seg_end, x, seg_rows, mode, out, r0,
            n_rows, tiles_per_step) -> None:
    """Check the operands and launch ``seg_tiles`` (fused when r0 given)."""
    _check_tiles(vals, cols, x)
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
    extra = [("aux", aux), ("out", out)] + ([("r0", r0)] if r0 is not None
                                            else [])
    for name, t in extra:
        if t.device != vals.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {vals.device}")
    if r0 is not None and (r0.dtype != torch.int32 or r0.shape != (T,)):
        raise ValueError(f"r0 must be int32 of shape ({T},)")
    if seg_rows <= 0:
        raise ValueError(f"seg_rows must be positive, got {seg_rows}")
    k = max(min(int(tiles_per_step), T), 1)
    lib = _lib()
    build.check(lib, lib.seg_tiles(
        *_type_args(vals, cols, x), aux.data_ptr(), T, c, seg_rows,
        SEG_MODES.index(mode), int(r0 is not None), out.data_ptr(),
        0 if r0 is None else r0.data_ptr(), n_rows, k, _stream(vals)),
        "seg_tiles")


def seg_spmv(vals, cols, local_row, seg_end, x, seg_rows: int,
             mode: str = "seg_scan") -> torch.Tensor:
    """K3 (``seg_scan``) / K4 (``onehot_mxu``): (T, S, L) nnz-split tiles
    -> (T, seg_rows) fp32 segment partials."""
    if not vals.is_cuda:
        return seg_spmv_ref(vals, cols, local_row, seg_end, x, seg_rows,
                            mode)
    out = torch.empty((vals.shape[0], seg_rows), dtype=torch.float32,
                      device=vals.device)
    _launch(vals, cols, local_row, seg_end, x, seg_rows, mode, out, None,
            0, 1)
    seg_spmv.launches[mode] += 1
    return out


def seg_spmv_fused(vals, cols, local_row, seg_end, r0, x, seg_rows: int, *,
                   n_rows: int, mode: str = "seg_scan",
                   tiles_per_step: int = 1, out=None) -> torch.Tensor:
    """K6: add tile t's partials into ``out[r0[t] + m]`` (rows ``>= n_rows``
    dropped) and return ``out``, a fresh fp32 zero vector of ``n_rows``
    when None. Requires per-tile contiguous rows (``rowmap[t, m] = r0[t] +
    m``). ``tiles_per_step`` is the number of tiles one GPU block walks
    (clamped to [1, T]); it does not change the result."""
    if not vals.is_cuda:
        return seg_spmv_fused_ref(vals, cols, local_row, seg_end, r0, x,
                                  seg_rows, n_rows=n_rows, mode=mode,
                                  out=out)
    if out is None:
        out = torch.zeros(n_rows, dtype=torch.float32, device=vals.device)
    if out.dtype != torch.float32 or out.shape != (n_rows,):
        raise ValueError("out must be an fp32 (n_rows,) tensor")
    _launch(vals, cols, local_row, seg_end, x, seg_rows, mode, out, r0,
            n_rows, tiles_per_step)
    seg_spmv_fused.launches += 1
    return out


seg_spmv.launches = {m: 0 for m in SEG_MODES}
seg_spmv_fused.launches = 0
