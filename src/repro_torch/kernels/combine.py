"""The ordered rowmap combine (a wrapper over ``csrc/rowmap_combine.cu``).

Dense plans (``core.kernel_builder``) and the sharded plans
(``repro_torch.dist``) add their tile partials into y through it instead
of ``index_add_``, whose atomics on the card add a row's partials in an
order that can change from call to call. The order is fixed once, when
the plan is built or loaded (``combine_order``), so two calls, and a
saved-and-loaded plan, give the same bits.

The fused seg kernels K6 and K11 add the rows that straddle tiles in the
same order, inside their one launch: ``fused_rows`` gives each (tile,
segment) of a fused step either its output row, when no other tile adds
into that row, or its place among the row's shared partials. The last of
a row's partials to arrive adds them all into y in (tile, segment)
order, as ``rowmap_combine`` would over their side slots: a row of two
through a 64-bit exchange cell a column, a longer one through side
slots and an arrival counter (``csrc/flush.cuh``).

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

__all__ = ["CombineOrder", "combine_order", "rowmap_combine", "FusedRows",
           "fused_rows", "SLOT_BASE", "CELL_COLS"]

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load_library("rowmap_combine")
    if lib.rowmap_combine.argtypes is None:
        lib.rowmap_combine.argtypes = [_P, _P, _P, _P, _L, _I, _P]
        lib.rowmap_combine.restype = _I
    return lib


class CombineOrder(tuple):
    """A rowmap's fixed combine order, ``(perm, offsets)``, checked once:
    ``perm`` int32 and ``offsets`` int64 of length ``n_rows + 1``, both
    contiguous on one device."""

    def __new__(cls, perm: torch.Tensor, offsets: torch.Tensor):
        if perm.dtype != torch.int32 or offsets.dtype != torch.int64:
            raise TypeError("perm must be int32 and offsets int64")
        if perm.ndim != 1 or offsets.ndim != 1 or offsets.numel() < 1:
            raise ValueError("perm and offsets must be 1-D, offsets "
                             "non-empty")
        if offsets.device != perm.device or not (perm.is_contiguous()
                                                 and offsets.is_contiguous()):
            raise ValueError("perm and offsets must be contiguous on one "
                             "device")
        self = super().__new__(cls, (perm, offsets))
        self.n_rows = offsets.numel() - 1
        return self

    @property
    def perm(self) -> torch.Tensor:
        return self[0]

    @property
    def offsets(self) -> torch.Tensor:
        return self[1]


def combine_order(rowmap: torch.Tensor, n_rows: int) -> CombineOrder:
    """The :class:`CombineOrder` of a rowmap: the flat indices of its
    entries ``>= 0`` sorted by row, stably (a row's partials keep their
    flat order), as int32, and each row's run in them, as int64 offsets
    of length ``n_rows + 1``. Computed on the rowmap's device."""
    flat = rowmap.reshape(-1).long()
    valid = torch.nonzero(flat >= 0).reshape(-1)
    rows = flat[valid]
    if rows.numel() and int(rows.max()) >= n_rows:
        raise ValueError(f"rowmap names row {int(rows.max())} of a "
                         f"{n_rows}-row output")
    order = torch.sort(rows, stable=True).indices
    offsets = torch.zeros(n_rows + 1, dtype=torch.int64, device=flat.device)
    offsets[1:] = torch.cumsum(torch.bincount(rows, minlength=n_rows), 0)
    return CombineOrder(valid[order].to(torch.int32), offsets)


def rowmap_combine(y, flat, perm, offsets=None) -> torch.Tensor:
    """Add each row's partials of ``flat`` ((N,) or (N, B) fp32) into
    ``y`` ((n_rows,) or (n_rows, B) fp32) in the order's perm order and
    return ``y``. The order is a :class:`CombineOrder` (``perm`` alone,
    checked when it was built) or the bare ``perm, offsets`` tensors,
    checked on every call."""
    order = perm if offsets is None else CombineOrder(perm, offsets)
    if not isinstance(order, CombineOrder):
        raise TypeError("give a CombineOrder, or perm and offsets")
    if not y.is_cuda:
        return rowmap_combine_ref(y, flat, *order)
    if (y.dtype != torch.float32 or flat.dtype != torch.float32
            or flat.shape[1:] != y.shape[1:] or y.ndim > 2):
        raise ValueError(f"y {tuple(y.shape)} and flat {tuple(flat.shape)} "
                         "must be fp32 with the same columns")
    if y.shape[0] != order.n_rows:
        raise ValueError(f"the order has {order.n_rows} rows, y "
                         f"{y.shape[0]}")
    if flat.device != y.device or order.perm.device != y.device:
        raise ValueError(f"flat and the order must lie on {y.device}")
    if not (y.is_contiguous() and flat.is_contiguous()):
        raise ValueError("y and flat must be contiguous")
    lib = _lib()
    build.check(lib, lib.rowmap_combine(
        y.data_ptr(), flat.data_ptr(), order.perm.data_ptr(),
        order.offsets.data_ptr(), order.n_rows,
        1 if y.ndim == 1 else y.shape[1], _stream(y)),
        "rowmap_combine")
    rowmap_combine.launches += 1
    return y


rowmap_combine.launches = 0


# the pair codes of FusedRows.dst and the exchange cells' columns; the
# kernels' flush.cuh holds the same constants
SLOT_BASE = -(1 << 30)
CELL_COLS = 32


class FusedRows(NamedTuple):
    """Where a fused seg step puts each (tile, segment) partial, and the
    state with which its kernel adds the rows that tiles share in a fixed
    order inside its one launch (``csrc/flush.cuh``).

    ``dst`` (T * seg_rows int32), a code per pair: the output row when
    this pair is the only one of the step that adds into that row; -1
    when it adds nothing (an empty segment, or a row past n_rows); for a
    row that several pairs add into, the pair's side slot k, numbered in
    (tile, segment) order, as ``SLOT_BASE - k``, or, where the row has
    two pairs, ``-2 - (2 u + r)``: listed row u's exchange, rank r (0 for
    the first pair in (tile, segment) order). ``n_used`` (T int32): one
    past each tile's last segment that adds anything (the kernels skip the
    rest). ``rows`` (int32) lists the shared rows, ascending, ``perm`` /
    ``offsets`` give each its ``n_side`` slots in (tile, segment) order,
    ``slot_row`` (n_side int32) names each slot's listed row and ``count``
    (int32) each listed row's slots. The kernels' state: ``arrive``
    (int32, a listed row's arrival counter, which the kernels count
    modulo ``count``) and ``cells`` (int64, ``CELL_COLS`` exchange cells a
    listed row). Both start at zero and every launch leaves them there,
    so they are never reset; they belong to one plan, whose fused step
    must not run on two streams at once."""

    dst: torch.Tensor
    n_used: torch.Tensor
    perm: torch.Tensor
    offsets: torch.Tensor
    rows: torch.Tensor
    n_side: int
    slot_row: torch.Tensor
    count: torch.Tensor
    arrive: torch.Tensor
    cells: torch.Tensor

    def shared_pairs(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The pairs (flat indices into ``dst``) that add into a shared
        row, and each one's side slot."""
        d = self.dst.long()
        pairs = torch.nonzero(d <= -2).reshape(-1)
        code = d[pairs]
        slot = SLOT_BASE - code
        ex = code > SLOT_BASE
        c = -2 - code[ex]
        slot[ex] = self.perm.long()[self.offsets[c // 2] + c % 2]
        return pairs, slot


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
    side_rows = rows[shared]
    perm = torch.sort(side_rows, stable=True).indices
    listed, counts = torch.unique_consecutive(side_rows[perm],
                                              return_counts=True)
    n_side, n_listed = int(perm.numel()), int(listed.numel())
    if n_side >= -SLOT_BASE - 2:
        raise ValueError(f"{n_side} shared (tile, segment) pairs: more "
                         "than the pair codes hold")
    offsets = torch.zeros(n_listed + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    owner = torch.repeat_interleave(torch.arange(n_listed, device=dev),
                                    counts)
    slot_row = torch.empty(n_side, dtype=torch.long, device=dev)
    slot_row[perm] = owner
    rank = torch.empty(n_side, dtype=torch.long, device=dev)
    rank[perm] = torch.arange(n_side, device=dev) - offsets[:-1][owner]
    k = torch.arange(n_side, device=dev)
    code = torch.where(counts[slot_row] == 2, -2 - (2 * slot_row + rank),
                       SLOT_BASE - k)
    dst = torch.where(used, rows, -1)
    dst[shared] = code
    return FusedRows(dst.to(torch.int32), n_used.to(torch.int32),
                     perm.to(torch.int32), offsets, listed.to(torch.int32),
                     n_side, slot_row.to(torch.int32),
                     counts.to(torch.int32),
                     torch.zeros(n_listed, dtype=torch.int32, device=dev),
                     torch.zeros(n_listed * CELL_COLS, dtype=torch.int64,
                                 device=dev))
