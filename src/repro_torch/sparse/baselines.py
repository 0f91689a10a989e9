"""Human-designed ("artificial") sparse formats: the paper's baselines.

Port of ``repro.sparse.baselines``. Each entry mirrors one of the formats
the paper compares against (§VII-B/VII-C) as an independent
(format-build, kernel) pair. These are *not* built through the Operator
Graph machinery: they are the hand-written competitors, so the
comparison of a searched plan against them is meaningful.

The numpy packing gives every format array bit-identical to the
reference's (SELL groups its work by width bucket once, where the
reference rescans all nonzeros for each width). The format dict holds torch tensors on
``device`` (default: the current GPU; ``torch.device("cpu")`` runs them
on the host), and each ``fn`` is plain eager torch: the reference's
``jax.ops.segment_sum`` and ``.at[].add`` become ``index_add_``, its
``einsum("rw,rw->r")`` becomes ``(vals * x[cols]).sum(-1)``. The
reference's are fused XLA programs; these run one kernel per op.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.kernel_builder import resolve_device
from repro_torch.core.matrices import SparseMatrix

__all__ = ["BaselineFormat", "BASELINES", "build_baseline"]


@dataclasses.dataclass
class BaselineFormat:
    name: str
    fmt: dict                      # name -> torch.Tensor on one device
    fn: Callable                   # fn(fmt, x) -> y
    stored_bytes: int
    padded_nnz: int

    @property
    def device(self) -> torch.device:
        return next(iter(self.fmt.values())).device

    def __call__(self, x) -> torch.Tensor:
        """x: (n_cols,) float32 -> (n_rows,) float32 on the format's
        device (a numpy or host x is copied there first)."""
        return self.fn(self.fmt, torch.as_tensor(x, device=self.device))


def _bytes(fmt: dict) -> int:
    return sum(t.numel() * t.element_size() for t in fmt.values())


def _device(device) -> torch.device:
    return resolve_device("cuda") if device is None else torch.device(device)


def _put(fmt: dict, device) -> dict:
    """numpy arrays -> tensors on ``device`` (a copy: fmt never aliases the
    matrix's arrays)."""
    return {k: torch.tensor(v, device=device) for k, v in fmt.items()}


def _rowdot(vals, cols, x):
    """sum_w vals[..., w] * x[cols[..., w]] (the reference's einsum)."""
    return (vals * x[cols]).sum(-1)


# ----------------------------------- CSR ----------------------------------

def build_csr(m: SparseMatrix, *, device=None) -> BaselineFormat:
    """cuSPARSE-CSR analogue: row-wise segmented reduction."""
    fmt = _put({"vals": m.vals, "cols": m.cols, "rows": m.rows},
               _device(device))
    n_rows = m.n_rows

    def fn(fmt, x):
        prod = fmt["vals"] * x[fmt["cols"]]
        return torch.zeros(n_rows, dtype=prod.dtype,
                           device=prod.device).index_add_(0, fmt["rows"],
                                                          prod)

    return BaselineFormat("CSR", fmt, fn, _bytes(fmt), m.nnz)


# ----------------------------------- COO ----------------------------------

def build_coo(m: SparseMatrix, *, device=None) -> BaselineFormat:
    """cuSPARSE-COO analogue (atomic scatter -> scatter-add)."""
    fmt = _put({"vals": m.vals, "cols": m.cols, "rows": m.rows},
               _device(device))
    n_rows = m.n_rows

    def fn(fmt, x):
        prod = fmt["vals"] * x[fmt["cols"]]
        return torch.zeros(n_rows, dtype=prod.dtype,
                           device=prod.device).index_add_(0, fmt["rows"],
                                                          prod)

    return BaselineFormat("COO", fmt, fn, _bytes(fmt), m.nnz)


# ----------------------------------- ELL ----------------------------------

def _ell_arrays(rows, cols, vals, n_rows, width):
    lengths = np.bincount(rows, minlength=n_rows)
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    pos = np.arange(rows.size, dtype=np.int64) - row_ptr[rows]
    keep = pos < width
    ev = np.zeros((n_rows, width), np.float32)
    ec = np.zeros((n_rows, width), np.int32)
    ev[rows[keep], pos[keep]] = vals[keep]
    ec[rows[keep], pos[keep]] = cols[keep]
    overflow = ~keep
    return ev, ec, overflow


def build_ell(m: SparseMatrix, *, device=None) -> BaselineFormat:
    width = int(m.row_lengths().max()) if m.nnz else 1
    ev, ec, _ = _ell_arrays(m.rows, m.cols, m.vals, m.n_rows, width)
    fmt = _put({"vals": ev, "cols": ec}, _device(device))

    def fn(fmt, x):
        return _rowdot(fmt["vals"], fmt["cols"], x)

    return BaselineFormat("ELL", fmt, fn, _bytes(fmt), m.n_rows * width)


# ---------------------------------- SELL ----------------------------------

def build_sell(m: SparseMatrix, c: int = 8, sigma_slices: int = 16, *,
               device=None) -> BaselineFormat:
    """SELL-C-sigma [36,39]: sort within sigma windows, slice into C-row
    chunks with per-slice width, bucket slices by width."""
    lengths = m.row_lengths()
    perm = np.arange(m.n_rows, dtype=np.int64)
    span = c * sigma_slices
    for lo in range(0, m.n_rows, span):
        hi = min(lo + span, m.n_rows)
        perm[lo:hi] = lo + np.argsort(-lengths[lo:hi], kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(m.n_rows)
    rows = inv[m.rows]
    order = np.lexsort((m.cols, rows))
    rows, cols, vals = rows[order], m.cols[order], m.vals[order]

    n_slices = math.ceil(m.n_rows / c)
    lens_p = np.zeros(n_slices * c, np.int64)
    lens_p[: m.n_rows] = np.bincount(rows, minlength=m.n_rows)
    widths = np.maximum(lens_p.reshape(n_slices, c).max(1), 1)

    row_ptr = np.concatenate([[0], np.cumsum(lens_p[: m.n_rows])]).astype(np.int64)
    pos = np.arange(rows.size, dtype=np.int64) - row_ptr[rows]
    # group slices, nonzeros and rows by width bucket once (the reference
    # rescans every nonzero for each of the widths: hundreds of passes on
    # a power-law matrix); the arrays are the reference's, bit for bit
    uw, slice_bucket = np.unique(widths, return_inverse=True)

    def group(bucket_of):
        order = np.argsort(bucket_of, kind="stable")
        return order, np.searchsorted(bucket_of[order], np.arange(uw.size + 1))

    sl_order, sl_bounds = group(slice_bucket)
    rank = np.empty(n_slices, np.int64)          # a slice's index in its bucket
    rank[sl_order] = np.arange(n_slices) - np.repeat(sl_bounds[:-1],
                                                     np.diff(sl_bounds))
    nz_order, nz_bounds = group(slice_bucket[rows // c])
    row_order, row_bounds = group(slice_bucket[np.arange(m.n_rows) // c])
    fmt = {}
    buckets = []
    padded = 0
    for b, w in enumerate(uw):
        n_sl = int(sl_bounds[b + 1] - sl_bounds[b])
        ev = np.zeros((n_sl, c, int(w)), np.float32)
        ec = np.zeros((n_sl, c, int(w)), np.int32)
        rmap = np.full((n_sl, c), -1, np.int32)
        nz = nz_order[nz_bounds[b]:nz_bounds[b + 1]]
        ev[rank[rows[nz] // c], rows[nz] % c, pos[nz]] = vals[nz]
        ec[rank[rows[nz] // c], rows[nz] % c, pos[nz]] = cols[nz]
        rr = row_order[row_bounds[b]:row_bounds[b + 1]]
        rmap[rank[rr // c], rr % c] = perm[rr]
        fmt[f"v{w}"], fmt[f"c{w}"], fmt[f"r{w}"] = ev, ec, rmap
        buckets.append(int(w))
        padded += ev.size
    fmt = _put(fmt, _device(device))
    n_rows = m.n_rows

    def fn(fmt, x):
        y = torch.zeros(n_rows + 1, dtype=torch.float32, device=x.device)
        for w in buckets:
            part = _rowdot(fmt[f"v{w}"], fmt[f"c{w}"], x)
            rm = fmt[f"r{w}"].reshape(-1)
            safe = torch.where(rm >= 0, rm, n_rows)
            y.index_add_(0, safe, part.reshape(-1))
        return y[:n_rows]

    return BaselineFormat("SELL", fmt, fn, _bytes(fmt), padded)


# ----------------------------------- HYB ----------------------------------

def build_hyb(m: SparseMatrix, *, device=None) -> BaselineFormat:
    """HYB [51,62]: ELL of typical width + COO overflow."""
    lengths = m.row_lengths()
    width = max(1, int(np.percentile(lengths, 75)))
    ev, ec, overflow = _ell_arrays(m.rows, m.cols, m.vals, m.n_rows, width)
    fmt = _put({"vals": ev, "cols": ec,
                "orows": m.rows[overflow], "ocols": m.cols[overflow],
                "ovals": m.vals[overflow]}, _device(device))

    def fn(fmt, x):
        y = _rowdot(fmt["vals"], fmt["cols"], x)
        prod = fmt["ovals"] * x[fmt["ocols"]]
        return y.index_add_(0, fmt["orows"], prod)

    return BaselineFormat("HYB", fmt, fn, _bytes(fmt),
                          m.n_rows * width + int(overflow.sum()))


# ------------------------------- Merge-CSR --------------------------------

def build_merge(m: SparseMatrix, chunk: int = 1024, *,
                device=None) -> BaselineFormat:
    """Merge-based CSR [27]: perfectly nnz-balanced chunks + segment fixup."""
    pad = math.ceil(max(m.nnz, 1) / chunk) * chunk
    vals = np.zeros(pad, np.float32)
    cols = np.zeros(pad, np.int32)
    rows = np.zeros(pad, np.int32)
    vals[: m.nnz], cols[: m.nnz], rows[: m.nnz] = m.vals, m.cols, m.rows
    if m.nnz:
        rows[m.nnz:] = m.rows[-1]
    fmt = _put({"vals": vals, "cols": cols, "rows": rows}, _device(device))
    n_rows = m.n_rows

    def fn(fmt, x):
        prod = fmt["vals"] * x[fmt["cols"]]
        return torch.zeros(n_rows, dtype=prod.dtype,
                           device=prod.device).index_add_(0, fmt["rows"],
                                                          prod)

    return BaselineFormat("Merge", fmt, fn, _bytes(fmt), pad)


# ---------------------------------- ACSR ----------------------------------

def build_acsr(m: SparseMatrix, *, device=None) -> BaselineFormat:
    """ACSR [24]: bin rows by power-of-two length; one ELL group per bin."""
    lengths = m.row_lengths()
    logs = np.ceil(np.log2(np.maximum(lengths, 1))).astype(np.int64)
    fmt = {}
    groups = []
    padded = 0
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    pos = np.arange(m.nnz, dtype=np.int64) - row_ptr[m.rows]
    for lv in np.unique(logs):
        sel = np.where(logs == lv)[0]
        w = max(1, int(lengths[sel].max()))
        rank = np.full(m.n_rows, -1, np.int64)
        rank[sel] = np.arange(sel.size)
        mask = rank[m.rows] >= 0
        ev = np.zeros((sel.size, w), np.float32)
        ec = np.zeros((sel.size, w), np.int32)
        ev[rank[m.rows[mask]], pos[mask]] = m.vals[mask]
        ec[rank[m.rows[mask]], pos[mask]] = m.cols[mask]
        fmt[f"v{lv}"], fmt[f"c{lv}"] = ev, ec
        fmt[f"r{lv}"] = sel.astype(np.int32)
        groups.append(int(lv))
        padded += ev.size
    fmt = _put(fmt, _device(device))
    n_rows = m.n_rows

    def fn(fmt, x):
        y = torch.zeros(n_rows, dtype=torch.float32, device=x.device)
        for lv in groups:
            part = _rowdot(fmt[f"v{lv}"], fmt[f"c{lv}"], x)
            y.index_add_(0, fmt[f"r{lv}"], part)
        return y

    return BaselineFormat("ACSR", fmt, fn, _bytes(fmt), padded)


# ------------------------------ CSR-Adaptive ------------------------------

def build_csr_adaptive(m: SparseMatrix, block_nnz: int = 256, *,
                       device=None) -> BaselineFormat:
    """CSR-Adaptive [22,34]: greedy row blocks of ~block_nnz nnz; CSR-Stream
    within a block (segment reduce), vector-row for long rows."""
    lengths = m.row_lengths()
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    # greedy block boundaries on rows
    bounds = [0]
    acc = 0
    for r in range(m.n_rows):
        acc += lengths[r]
        if acc >= block_nnz:
            bounds.append(r + 1)
            acc = 0
    if bounds[-1] != m.n_rows:
        bounds.append(m.n_rows)
    bounds = np.asarray(bounds, np.int64)
    # pad each block's nnz range to the max block nnz => rectangular gather
    blk_lo = row_ptr[bounds[:-1]]
    blk_hi = row_ptr[bounds[1:]]
    w = int((blk_hi - blk_lo).max()) if len(bounds) > 1 else max(m.nnz, 1)
    B = len(bounds) - 1
    vals = np.zeros((B, w), np.float32)
    cols = np.zeros((B, w), np.int32)
    rows = np.zeros((B, w), np.int32)
    for b in range(B):
        n = int(blk_hi[b] - blk_lo[b])
        vals[b, :n] = m.vals[blk_lo[b]: blk_hi[b]]
        cols[b, :n] = m.cols[blk_lo[b]: blk_hi[b]]
        rows[b, :n] = m.rows[blk_lo[b]: blk_hi[b]]
        if n < w:
            rows[b, n:] = rows[b, max(n - 1, 0)]
    fmt = _put({"vals": vals, "cols": cols, "rows": rows}, _device(device))
    n_rows = m.n_rows

    def fn(fmt, x):
        prod = fmt["vals"] * x[fmt["cols"]]
        return torch.zeros(n_rows, dtype=prod.dtype,
                           device=prod.device).index_add_(
            0, fmt["rows"].reshape(-1), prod.reshape(-1))

    return BaselineFormat("CSR-Adaptive", fmt, fn, _bytes(fmt), B * w)


BASELINES: dict[str, Callable[..., BaselineFormat]] = {
    "CSR": build_csr,
    "COO": build_coo,
    "ELL": build_ell,
    "SELL": build_sell,
    "HYB": build_hyb,
    "Merge": build_merge,
    "ACSR": build_acsr,
    "CSR-Adaptive": build_csr_adaptive,
}


def build_baseline(name: str, m: SparseMatrix,
                   device: Optional[object] = None) -> BaselineFormat:
    """Build baseline ``name`` for ``m`` on ``device`` (default: the GPU)."""
    return BASELINES[name](m, device=device)
