"""The ordered rowmap combine (a wrapper over ``csrc/rowmap_combine.cu``).

Dense plans (``core.kernel_builder``) and the sharded plans
(``repro_torch.dist``) add their tile partials into y through it instead
of ``index_add_``, whose atomics on the card add a row's partials in an
order that can change from call to call. The order is fixed once, when
the plan is built or loaded (``combine_order``), so two calls, and a
saved-and-loaded plan, give the same bits.

The fused seg kernels K6 and K11 use it for the rows that straddle
tiles: ``fused_rows`` gives each (tile, segment) of a fused step either
its output row, when no other tile adds into that row, or a slot of a
side buffer, whose slots the kernel's wrapper then adds into y through
the same combine, in tile order.

``rowmap_combine`` runs its plain version (``ref.rowmap_combine_ref``)
on CPU tensors and launches its CUDA kernel on GPU tensors;
``rowmap_combine.launches`` counts the launches. It replaces no Pallas
kernel: the reference's combine is an XLA scatter.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .ell_spmv import _stream
from .ref import rowmap_combine_ref

__all__ = ["combine_order", "rowmap_combine", "FusedRows", "fused_rows"]

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load_library("rowmap_combine")
    if lib.rowmap_combine.argtypes is None:
        lib.rowmap_combine.argtypes = [_P, _P, _P, _P, _P, _L, _I, _P]
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
    launch_combine(y, flat, perm, offsets)
    rowmap_combine.launches += 1
    return y


rowmap_combine.launches = 0


def launch_combine(y, flat, perm, offsets, rows=None) -> None:
    """Launch the combine kernel on checked operands; ``rows`` (int32) is
    a compact list of the output rows that ``offsets`` bound (the fused
    seg wrappers' second pass, counted as part of their own launch)."""
    lib = _lib()
    n_out = y.shape[0] if rows is None else rows.numel()
    build.check(lib, lib.rowmap_combine(
        y.data_ptr(), flat.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
        0 if rows is None else rows.data_ptr(), n_out,
        1 if y.ndim == 1 else y.shape[1], _stream(y)), "rowmap_combine")


class FusedRows(NamedTuple):
    """Where a fused seg step puts each (tile, segment) partial.

    ``dst`` (T * seg_rows int32): the output row when this pair is the
    only one of the step that adds into that row; -1 when the pair adds
    nothing (an empty segment, or a row past n_rows); ``-2 - k`` for slot
    k of the side buffer (a row that several tiles add into).
    ``n_used`` (T int32): one past each tile's last segment that adds
    anything (the kernels skip the rest). The side's ``n_side`` slots are
    numbered in (tile, segment) order; ``rows`` (int32) lists the distinct
    rows they add into, ascending, and ``perm`` / ``offsets`` give each
    listed row its slots, in that order."""

    dst: torch.Tensor
    n_used: torch.Tensor
    perm: torch.Tensor
    offsets: torch.Tensor
    rows: torch.Tensor
    n_side: int


def fused_rows(r0, aux, seg_rows: int, n_rows: int, mode: str,
               chunk: int) -> FusedRows:
    """The ``FusedRows`` of a fused seg step whose tile t adds segment m
    at row ``r0[t] + m``. ``aux`` is seg_end (T, seg_rows) in seg_scan
    mode, whose segment m is empty when its clamped ends are equal, and
    local_row (T, chunk) in one-hot mode, whose segment m is empty when
    no slot names it. Empty segments add exactly zero, so they claim no
    row. Computed on r0's device, once per plan (it changes with the
    descriptors, never with the values)."""
    T, M = r0.shape[0], int(seg_rows)
    dev = r0.device
    if mode == "seg_scan":
        end = aux.reshape(T, M).long().clamp(0, int(chunk))
        prev = torch.cat([torch.zeros((T, 1), dtype=torch.long, device=dev),
                          end[:, :-1]], dim=1)
        used = end != prev
    else:
        local = aux.reshape(T, -1).long()
        ok = (local >= 0) & (local < M)
        slot = torch.arange(T, device=dev)[:, None] * M + local
        used = torch.zeros(T * M, dtype=torch.bool, device=dev)
        used[slot[ok]] = True
        used = used.reshape(T, M)
    rows = r0.long()[:, None] + torch.arange(M, device=dev)
    used &= (rows >= 0) & (rows < n_rows)
    n_used = (used * torch.arange(1, M + 1, device=dev)).amax(dim=1)
    rows, used = rows.reshape(-1), used.reshape(-1)
    count = torch.bincount(rows[used], minlength=n_rows)
    shared = used & (count[rows.clamp(0, max(n_rows - 1, 0))] > 1)
    side = torch.cumsum(shared.long(), 0) - 1
    dst = torch.where(shared, -2 - side, torch.where(used, rows, -1))
    side_rows = rows[shared]
    perm = torch.sort(side_rows, stable=True).indices
    listed, counts = torch.unique_consecutive(side_rows[perm],
                                              return_counts=True)
    offsets = torch.zeros(listed.numel() + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    return FusedRows(dst.to(torch.int32), n_used.to(torch.int32),
                     perm.to(torch.int32), offsets, listed.to(torch.int32),
                     int(perm.numel()))
