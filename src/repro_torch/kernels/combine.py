"""The ordered rowmap combine (a wrapper over ``csrc/rowmap_combine.cu``).

The sharded plans (``repro_torch.dist``) add their tile partials into y
through it instead of ``index_add_``, whose atomics on the card add a
row's partials in an order that can change from call to call. The order
is fixed once, when the plan's operands are placed (``combine_order``),
so two calls, and a saved-and-loaded plan, give the same bits.

``rowmap_combine`` runs its plain version (``ref.rowmap_combine_ref``)
on CPU tensors and launches its CUDA kernel on GPU tensors;
``rowmap_combine.launches`` counts the launches. It replaces no Pallas
kernel: the reference's combine is an XLA scatter.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ell_spmv import _stream
from .ref import rowmap_combine_ref

__all__ = ["combine_order", "rowmap_combine"]

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load_library("rowmap_combine")
    if lib.rowmap_combine.argtypes is None:
        lib.rowmap_combine.argtypes = [_P, _P, _P, _P, _L, _I, _P]
        lib.rowmap_combine.restype = _I
    return lib


def combine_order(rowmap: torch.Tensor, n_rows: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(perm, offsets)`` of a rowmap: the flat indices of its entries
    ``>= 0`` sorted by row, stably (a row's partials keep their flat
    order), as int32, and each row's run in them, as int64 offsets of
    length ``n_rows + 1``. Computed on the rowmap's device."""
    flat = rowmap.reshape(-1).long()
    valid = torch.nonzero(flat >= 0).reshape(-1)
    rows = flat[valid]
    if rows.numel() and int(rows.max()) >= n_rows:
        raise ValueError(f"rowmap names row {int(rows.max())} of a "
                         f"{n_rows}-row output")
    order = torch.sort(rows, stable=True).indices
    offsets = torch.zeros(n_rows + 1, dtype=torch.int64, device=flat.device)
    offsets[1:] = torch.cumsum(torch.bincount(rows, minlength=n_rows), 0)
    return valid[order].to(torch.int32), offsets


def rowmap_combine(y, flat, perm, offsets) -> torch.Tensor:
    """Add each row's partials of ``flat`` ((N,) or (N, B) fp32) into
    ``y`` ((n_rows,) or (n_rows, B) fp32) in ``perm`` order and return
    ``y``."""
    if not y.is_cuda:
        return rowmap_combine_ref(y, flat, perm, offsets)
    n_rows = y.shape[0]
    B = 1 if y.ndim == 1 else y.shape[1]
    if (y.dtype != torch.float32 or flat.dtype != torch.float32
            or flat.shape[1:] != y.shape[1:]):
        raise ValueError(f"y {tuple(y.shape)} and flat {tuple(flat.shape)} "
                         "must be fp32 with the same columns")
    if perm.dtype != torch.int32 or offsets.dtype != torch.int64:
        raise TypeError("perm must be int32 and offsets int64")
    if offsets.shape != (n_rows + 1,):
        raise ValueError(f"offsets must have {n_rows + 1} entries")
    for name, t in (("flat", flat), ("perm", perm), ("offsets", offsets)):
        if t.device != y.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {y.device}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    lib = _lib()
    build.check(lib, lib.rowmap_combine(y.data_ptr(), flat.data_ptr(),
                                        perm.data_ptr(), offsets.data_ptr(),
                                        n_rows, B, _stream(y)),
                "rowmap_combine")
    rowmap_combine.launches += 1
    return y


rowmap_combine.launches = 0
