"""ELL row-dot kernels: SpMV K1, K2, K5 (wrappers over
``csrc/ell_spmv.cu``) and multi-RHS SpMM K7, K8, K9 (over
``csrc/ell_spmm.cu``), and the grouped K1 and K7 (``ell_spmv_grouped``,
``ell_spmm_grouped``), which run many width buckets (a
:class:`TileGroup`) in one launch.

Each wrapper runs its plain PyTorch version (``ref.py``) when the tensors
lie on the CPU, and launches its CUDA kernel when they lie on a GPU; it
never falls back from one to the other. ``<wrapper>.launches`` counts the
kernel launches of each wrapper.

Replaced TPU kernels (``src/repro/kernels/ell_spmv.py``): K1
``ell_spmv_pallas``, K2 ``ell_spmv_direct_pallas``, K5
``ell_spmv_fused_pallas``, K7 ``ell_spmm_pallas``, K8
``ell_spmm_direct_pallas``, K9 ``ell_spmm_fused_pallas``. What bounds them
on the H100 and how the CUDA designs answer it is written at the top of
the two sources.
"""
from __future__ import annotations

import ctypes
import itertools

import torch

from . import build
from .ref import (ell_spmm_direct_ref, ell_spmm_fused_ref,
                  ell_spmm_grouped_ref, ell_spmm_ref, ell_spmv_direct_ref,
                  ell_spmv_fused_ref, ell_spmv_grouped_ref, ell_spmv_ref)

__all__ = ["ell_spmv", "ell_spmv_direct", "ell_spmv_fused", "ell_spmm",
           "ell_spmm_direct", "ell_spmm_fused", "ell_spmv_grouped",
           "ell_spmm_grouped", "TileGroup", "GROUP_MAX"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_VALS = (torch.float32, torch.bfloat16)
_COLS = (torch.int32, torch.int16)


# the buckets one grouped launch takes (kMaxGroup in csrc/spmm.cuh); a
# larger group runs as several launches into the same slab
GROUP_MAX = 64


class _Bucket(ctypes.Structure):
    """One bucket of a grouped launch (``BucketIn`` in csrc/spmm.cuh)."""

    _fields_ = [("vals", _P), ("cols", _P), ("out_row", _L), ("rows", _L),
                ("W", _L)]


_BUCKETS = ctypes.POINTER(_Bucket)


def _lib() -> ctypes.CDLL:
    lib = build.load_library("ell_spmv")
    if lib.ell_rows.argtypes is None:
        lib.ell_rows.argtypes = [_P, _I, _P, _I, _P, _I, _I, _P, _L, _I, _P]
        lib.ell_fused.argtypes = [_P, _I, _P, _I, _P, _I, _I, _P, _L, _I, _I,
                                  _L, _L, _I, _P]
        lib.ell_rows_grouped.argtypes = [_BUCKETS, _I, _I, _I, _P, _I, _I,
                                         _P, _P]
        lib.ell_rows.restype = lib.ell_fused.restype = _I
        lib.ell_rows_grouped.restype = _I
    return lib


def _spmm_lib() -> ctypes.CDLL:
    lib = build.load_library("ell_spmm")
    if lib.ell_spmm.argtypes is None:
        lib.ell_spmm.argtypes = [_P, _I, _P, _I, _P, _I, _I, _I, _P, _L, _I,
                                 _I, _I, _L, _L, _I, _P]
        lib.ell_spmm_grouped.argtypes = [_BUCKETS, _I, _I, _I, _P, _I, _I,
                                         _I, _P, _P]
        lib.ell_spmm.restype = lib.ell_spmm_grouped.restype = _I
    return lib


def _check_tiles(vals, cols, x, x_ndim: int = 1) -> None:
    """What the kernels take: (T, R, W) contiguous tiles and an x of
    ``x_ndim`` dimensions ((n_cols,) or (n_cols, B) with B >= 1) on one
    GPU, in the storage types the kernels are built for."""
    if vals.ndim != 3 or cols.shape != vals.shape or not vals.numel():
        raise ValueError(f"vals/cols must be equal non-empty 3-D shapes, "
                         f"got {tuple(vals.shape)} / {tuple(cols.shape)}")
    if x.ndim != x_ndim or (x_ndim == 2 and x.shape[1] < 1):
        want = "1-D (n_cols,)" if x_ndim == 1 else "2-D (n_cols, B), B >= 1"
        raise ValueError(f"x must be {want}, got shape {tuple(x.shape)}")
    if vals.dtype not in _VALS or x.dtype not in _VALS:
        raise TypeError(f"vals/x must be float32 or bfloat16, got "
                        f"{vals.dtype} / {x.dtype}")
    if cols.dtype not in _COLS:
        raise TypeError(f"cols must be int32 or int16, got {cols.dtype}")
    for name, t in (("vals", vals), ("cols", cols), ("x", x)):
        if t.device != vals.device:
            raise ValueError(f"{name} is on {t.device}, vals on {vals.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _type_args(vals, cols, x):
    return (vals.data_ptr(), int(vals.dtype == torch.bfloat16),
            cols.data_ptr(), int(cols.dtype == torch.int16),
            x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0])


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _rows(vals, cols, x) -> torch.Tensor:
    """Launch ``ell_rows``: fp32 (T, R) row sums."""
    _check_tiles(vals, cols, x)
    T, R, W = vals.shape
    out = torch.empty((T, R), dtype=torch.float32, device=vals.device)
    lib = _lib()
    build.check(lib, lib.ell_rows(*_type_args(vals, cols, x), out.data_ptr(),
                                  T * R, W, _stream(vals)), "ell_rows")
    return out


def ell_spmv(vals, cols, x) -> torch.Tensor:
    """K1: (T, R, W) padded tiles -> (T, R) fp32 row partials."""
    if not vals.is_cuda:
        return ell_spmv_ref(vals, cols, x)
    out = _rows(vals, cols, x)
    ell_spmv.launches += 1
    return out


def ell_spmv_direct(vals, cols, x) -> torch.Tensor:
    """K2: K1's sums as the flat (T*R,) slab of contiguous output rows."""
    if not vals.is_cuda:
        return ell_spmv_direct_ref(vals, cols, x)
    out = _rows(vals, cols, x).reshape(-1)
    ell_spmv_direct.launches += 1
    return out


def ell_spmv_fused(vals, cols, x, *, n_rows: int, row0: int = 0,
                   tiles_per_step: int = 1, out=None) -> torch.Tensor:
    """K5: add tile row ``t*R + r`` into ``out[row0 + t*R + r]`` (rows
    ``>= n_rows`` dropped) and return ``out``, a fresh fp32 zero vector of
    ``n_rows`` when None. Requires the affine slope-1 rowmap.
    ``tiles_per_step`` (the TPU kernel's tiles per grid step) is accepted
    and passed on; the GPU grid covers the T*R rows without it, so it
    does not change the result."""
    if not vals.is_cuda:
        return ell_spmv_fused_ref(vals, cols, x, n_rows=n_rows, row0=row0,
                                  out=out)
    _check_tiles(vals, cols, x)
    if out is None:
        out = torch.zeros(n_rows, dtype=torch.float32, device=vals.device)
    if (out.dtype != torch.float32 or out.shape != (n_rows,)
            or out.device != vals.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous fp32 (n_rows,) tensor on "
                         "the tiles' device")
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    T, R, W = vals.shape
    k = max(min(int(tiles_per_step), T), 1)
    lib = _lib()
    build.check(lib, lib.ell_fused(*_type_args(vals, cols, x),
                                   out.data_ptr(), T, R, W, row0, n_rows, k,
                                   _stream(vals)), "ell_fused")
    ell_spmv_fused.launches += 1
    return out


# ----------------------------- multi-RHS (SpMM) -----------------------------

def _spmm_launch(vals, cols, x, out, fused: int, row0: int, n_rows: int,
                 tiles_per_step: int) -> None:
    """Launch ``ell_spmm`` (x already checked as (n_cols, B))."""
    T, R, W = vals.shape
    k = max(min(int(tiles_per_step), T), 1)
    lib = _spmm_lib()
    build.check(lib, lib.ell_spmm(*_type_args(vals, cols, x), x.shape[1],
                                  out.data_ptr(), T, R, W, fused, row0,
                                  n_rows, k, _stream(vals)), "ell_spmm")


def _spmm_rows(vals, cols, x) -> torch.Tensor:
    """fp32 (T*R, B) row sums of every tile row."""
    _check_tiles(vals, cols, x, 2)
    T, R, _ = vals.shape
    out = torch.empty((T * R, x.shape[1]), dtype=torch.float32,
                      device=vals.device)
    _spmm_launch(vals, cols, x, out, 0, 0, 0, 1)
    return out


def ell_spmm(vals, cols, x) -> torch.Tensor:
    """K7: (T, R, W) padded tiles, x (n_cols, B) -> (T, R, B) fp32 row
    partials, the format read once for all B columns."""
    if not vals.is_cuda:
        return ell_spmm_ref(vals, cols, x)
    T, R, _ = vals.shape
    out = _spmm_rows(vals, cols, x).reshape(T, R, -1)
    ell_spmm.launches += 1
    return out


def ell_spmm_direct(vals, cols, x) -> torch.Tensor:
    """K8: K7's sums as the (T*R, B) slab of contiguous output rows."""
    if not vals.is_cuda:
        return ell_spmm_direct_ref(vals, cols, x)
    out = _spmm_rows(vals, cols, x)
    ell_spmm_direct.launches += 1
    return out


def ell_spmm_fused(vals, cols, x, *, n_rows: int, row0: int = 0,
                   tiles_per_step: int = 1, out=None) -> torch.Tensor:
    """K9: add tile row ``t*R + r``'s B sums into ``out[row0 + t*R + r]``
    (rows ``>= n_rows`` dropped) and return ``out``, a fresh fp32
    (n_rows, B) zero tensor when None. Requires the affine slope-1 rowmap.
    ``tiles_per_step`` is the number of tiles one column of the GPU grid
    covers (clamped to [1, T]); it does not change the result."""
    if not vals.is_cuda:
        return ell_spmm_fused_ref(vals, cols, x, n_rows=n_rows, row0=row0,
                                  out=out)
    _check_tiles(vals, cols, x, 2)
    if out is None:
        out = torch.zeros((n_rows, x.shape[1]), dtype=torch.float32,
                          device=vals.device)
    if (out.dtype != torch.float32 or out.shape != (n_rows, x.shape[1])
            or out.device != vals.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous fp32 (n_rows, B) tensor "
                         "on the tiles' device")
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    _spmm_launch(vals, cols, x, out, 1, row0, n_rows, tiles_per_step)
    ell_spmm_fused.launches += 1
    return out


# ------------------------ grouped launches (K1, K7) ------------------------

class TileGroup:
    """The width buckets of one grouped K1 or K7 launch: each bucket's
    (T, R, W) ``vals`` and ``cols``, all of one vals and one cols dtype on
    one device, checked once. Bucket i's T*R row sums go to rows
    ``offsets[i]`` .. ``offsets[i + 1]`` of the launch's (``n_rows``[, B])
    output slab. On a GPU the group also holds ``chunks``, each launch's
    descriptors (``GROUP_MAX`` buckets a launch), built once, so that a
    grouped call costs one ctypes call a launch; the group holds the
    tensors, so the descriptors' pointers stay valid while it lives."""

    def __init__(self, vals, cols):
        vals, cols = tuple(vals), tuple(cols)
        if not vals or len(vals) != len(cols):
            raise ValueError(f"a group needs buckets, and cols for each: "
                             f"{len(vals)} vals, {len(cols)} cols")
        v0, c0 = vals[0], cols[0]
        for v, c in zip(vals, cols):
            if v.ndim != 3 or c.shape != v.shape or not v.numel():
                raise ValueError(f"vals/cols must be equal non-empty 3-D "
                                 f"shapes, got {tuple(v.shape)} / "
                                 f"{tuple(c.shape)}")
            if v.dtype not in _VALS or c.dtype not in _COLS:
                raise TypeError(f"vals must be float32 or bfloat16 and cols "
                                f"int32 or int16, got {v.dtype} / {c.dtype}")
            if v.dtype != v0.dtype or c.dtype != c0.dtype:
                raise TypeError("every bucket of a group must have one vals "
                                "and one cols dtype")
            if v.device != v0.device or c.device != v0.device:
                raise ValueError("every bucket of a group must lie on one "
                                 "device")
            if not (v.is_contiguous() and c.is_contiguous()):
                raise ValueError("vals and cols must be contiguous")
        self.vals, self.cols = vals, cols
        rows = [v.shape[0] * v.shape[1] for v in vals]
        self.offsets = tuple(itertools.accumulate(rows, initial=0))
        self.n_rows = self.offsets[-1]
        self.device = v0.device
        self.types = (int(v0.dtype == torch.bfloat16),
                      int(c0.dtype == torch.int16))
        self.chunks = ()
        if v0.is_cuda:
            self.chunks = tuple(
                ((_Bucket * len(part))(*[
                    _Bucket(vals[i].data_ptr(), cols[i].data_ptr(),
                            self.offsets[i], rows[i], vals[i].shape[2])
                    for i in part]), len(part))
                for part in (range(lo, min(lo + GROUP_MAX, len(vals)))
                             for lo in range(0, len(vals), GROUP_MAX)))


def _grouped_out(group: TileGroup, x, x_ndim: int) -> torch.Tensor:
    """Check x against a grouped launch and allocate its output slab."""
    if x.ndim != x_ndim or (x_ndim == 2 and x.shape[1] < 1):
        want = "1-D (n_cols,)" if x_ndim == 1 else "2-D (n_cols, B), B >= 1"
        raise ValueError(f"x must be {want}, got shape {tuple(x.shape)}")
    if x.dtype not in _VALS:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.device != group.device or not x.is_contiguous():
        raise ValueError(f"x must be contiguous on {group.device}")
    return torch.empty((group.n_rows,) + tuple(x.shape[1:]),
                       dtype=torch.float32, device=x.device)


def ell_spmv_grouped(group: TileGroup, x) -> torch.Tensor:
    """The grouped K1: every bucket of ``group`` in one launch (one per
    ``GROUP_MAX`` buckets), x (n_cols,) -> the (``group.n_rows``,) fp32
    slab of their row partials, bucket after bucket; each row the bits of
    its bucket's own ``ell_spmv`` for buckets wider than 32 slots (the
    slab kernel's buckets also agree: csrc/spmm.cuh, split_rows)."""
    if group.device.type != "cuda":
        return ell_spmv_grouped_ref(group.vals, group.cols, x)
    out = _grouped_out(group, x, 1)
    lib, stream = _lib(), _stream(x)
    for arr, n in group.chunks:
        build.check(lib, lib.ell_rows_grouped(
            arr, n, *group.types, x.data_ptr(), int(x.dtype == torch.bfloat16),
            x.shape[0], out.data_ptr(), stream), "ell_rows_grouped")
        ell_spmv_grouped.launches += 1
    return out


def ell_spmm_grouped(group: TileGroup, x) -> torch.Tensor:
    """The grouped K7: every bucket of ``group`` in one launch (one per
    ``GROUP_MAX`` buckets), x (n_cols, B) -> the (``group.n_rows``, B)
    fp32 slab of their row partials, bucket after bucket, each row the
    bits of its bucket's own ``ell_spmm``."""
    if group.device.type != "cuda":
        return ell_spmm_grouped_ref(group.vals, group.cols, x)
    out = _grouped_out(group, x, 2)
    lib, stream = _spmm_lib(), _stream(x)
    for arr, n in group.chunks:
        build.check(lib, lib.ell_spmm_grouped(
            arr, n, *group.types, x.data_ptr(), int(x.dtype == torch.bfloat16),
            x.shape[0], x.shape[1], out.data_ptr(), stream),
            "ell_spmm_grouped")
        ell_spmm_grouped.launches += 1
    return out


ell_spmv.launches = 0
ell_spmv_direct.launches = 0
ell_spmv_fused.launches = 0
ell_spmm.launches = 0
ell_spmm_direct.launches = 0
ell_spmm_fused.launches = 0
ell_spmv_grouped.launches = 0
ell_spmm_grouped.launches = 0
