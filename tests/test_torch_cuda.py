"""The CUDA kernels K1-K11 against their plain PyTorch versions, a
cuda-backend compile against the oracle (1-D and (n_cols, B) x), and the
serving engine on the card. These need an NVIDIA GPU (they
build the kernels with nvcc): here they skip; on the card run

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_cuda.py

This file imports no jax (and needs none of tests/conftest.py), so it
also runs where jax is not installed.
Tolerance ``1e-4 * max|plain| + 1e-6``: the kernels sum in another order
than the plain versions. Repeated calls of one plan, its saved-and-loaded
copy and any tiles_per_step give the same bits (the combines add in an
order fixed with the plan): those comparisons are exact.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import matrices as tm
from repro_torch.core.graph import OperatorGraph
from repro_torch.design.registry import OpSpec
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu

VALS = (torch.float32, torch.bfloat16)
COLS = (torch.int32, torch.int16)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels are built with nvcc)")
    return torch.device("cuda")


def _rows(g, vals, local, end, r0, m, n_rows, mode):
    """The ``FusedRows`` that a fused seg kernel takes on the card (a plan
    builds them once), from the descriptors moved by ``g``."""
    from repro_torch.kernels.combine import fused_rows
    return fused_rows(g(r0), g(end if mode == "seg_scan" else local), m,
                      n_rows, mode, vals.shape[1] * vals.shape[2])


def _close(got, want):
    got, want = got.cpu(), want.cpu()
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-4 * float(want.abs().max()) + 1e-6
    assert float((got - want).abs().max()) <= tol


def _seg_case(rng, t, s, l, m):
    c = s * l
    local = np.sort(rng.integers(0, m, (t, c)), axis=1)
    local = np.minimum(local - local[:, :1], m - 1)
    seg_end = np.empty((t, m), np.int32)
    for ti in range(t):   # segment m ends where the first row > m starts
        seg_end[ti] = np.searchsorted(local[ti], np.arange(m), side="right")
    return (torch.from_numpy(local.astype(np.int32).reshape(t, s, l)),
            torch.from_numpy(seg_end))


# (T, R, W): K1/K2 take the 32-row slab kernel up to W = 32 and split rows
# over warps above it; 72 and 5 rows are not multiples of the slab's 32
ELL_SHAPES = [(11, 16, 45), (3, 24, 1), (3, 24, 9), (3, 24, 31), (3, 24, 32),
              (3, 24, 33), (1, 24, 400), (1, 5, 1000), (300, 128, 3)]


@pytest.mark.parametrize("t,r,w", ELL_SHAPES)
@pytest.mark.parametrize("vd", VALS)
@pytest.mark.parametrize("cd", COLS)
def test_ell_kernels_match_plain(dev, vd, cd, t, r, w):
    rng = np.random.default_rng(t * 1000 + w)
    n_cols = 3000
    vals = torch.from_numpy(rng.standard_normal((t, r, w))).to(vd)
    cols = torch.from_numpy(rng.integers(0, n_cols, (t, r, w))).to(cd)
    x = torch.from_numpy(rng.standard_normal(n_cols).astype(np.float32))
    g = [z.to(dev) for z in (vals, cols, x)]
    _close(ops.ell_spmv(*g), ref.ell_spmv_ref(vals, cols, x))
    _close(ops.ell_spmv_direct(*g), ref.ell_spmv_direct_ref(vals, cols, x))
    # K5 adds into out: a prefilled one shows += and not =; n_rows cuts a
    # 32-row slab (or the last of fewer rows) short
    n_rows = 11 + t * r - min(13, t * r // 2)
    y0 = torch.from_numpy(rng.standard_normal(n_rows).astype(np.float32))
    for k in (1, 3, 8):
        _close(ops.ell_spmv_fused(*g, n_rows=170, row0=7, tiles_per_step=k),
               ref.ell_spmv_fused_ref(vals, cols, x, n_rows=170, row0=7))
        _close(ops.ell_spmv_fused(*g, n_rows=n_rows, row0=11,
                                  tiles_per_step=k, out=y0.clone().to(dev)),
               ref.ell_spmv_fused_ref(vals, cols, x, n_rows=n_rows, row0=11,
                                      out=y0.clone()))
    torch.cuda.synchronize()


def _out_of_range(rng, cols, n_cols, vals):
    """``cols`` with about a tenth of its slots (and the first) moved outside
    [0, n_cols), and the plain versions' inputs for the same sums: those
    slots at column 0 with value 0."""
    bad = torch.from_numpy(rng.random(tuple(cols.shape)) < 0.1)
    bad.view(-1)[0] = True
    got = cols.masked_fill(bad, n_cols + 7)
    got.view(-1)[0] = -1
    return got, cols.masked_fill(bad, 0), vals.masked_fill(bad, 0)


@pytest.mark.parametrize("t,r,w", [(3, 24, 9), (1, 24, 400)])
@pytest.mark.parametrize("vd,cd,xd", [
    (torch.float32, torch.int32, torch.float32),
    (torch.bfloat16, torch.int16, torch.bfloat16)])
def test_ell_kernels_skip_out_of_range_columns(dev, t, r, w, vd, cd, xd):
    """A column outside [0, n_cols) contributes 0 in K1, K2, K5 and
    K7-K9, on the slab and the split-row mappings alike."""
    rng = np.random.default_rng(w)
    n_cols = 2000
    vals = torch.from_numpy(rng.standard_normal((t, r, w))).to(vd)
    cols = torch.from_numpy(rng.integers(0, n_cols, (t, r, w))).to(cd)
    cols, ok_cols, ok_vals = _out_of_range(rng, cols, n_cols, vals)
    x1 = torch.from_numpy(rng.standard_normal(n_cols)).to(xd)
    x8 = torch.from_numpy(rng.standard_normal((n_cols, 8))).to(xd)
    v, c = vals.to(dev), cols.to(dev)
    _close(ops.ell_spmv(v, c, x1.to(dev)),
           ref.ell_spmv_ref(ok_vals, ok_cols, x1))
    _close(ops.ell_spmv_direct(v, c, x1.to(dev)),
           ref.ell_spmv_direct_ref(ok_vals, ok_cols, x1))
    _close(ops.ell_spmv_fused(v, c, x1.to(dev), n_rows=t * r),
           ref.ell_spmv_fused_ref(ok_vals, ok_cols, x1, n_rows=t * r))
    _close(ops.ell_spmm(v, c, x8.to(dev)),
           ref.ell_spmm_ref(ok_vals, ok_cols, x8))
    _close(ops.ell_spmm_direct(v, c, x8.to(dev)),
           ref.ell_spmm_direct_ref(ok_vals, ok_cols, x8))
    _close(ops.ell_spmm_fused(v, c, x8.to(dev), n_rows=t * r,
                              tiles_per_step=3),
           ref.ell_spmm_fused_ref(ok_vals, ok_cols, x8, n_rows=t * r))
    torch.cuda.synchronize()


def _onehot_rows(rng, case, t, c, m):
    """(t, c) local rows for the one-hot kernels (K4, K6, K10b, K11), which
    must sum any of them as the one-hot matrix does."""
    if case == "unsorted":
        return rng.integers(0, m, (t, c))
    if case == "one_row":              # one heavy row fills each tile
        return np.repeat(np.arange(t)[:, None] % m, c, axis=1)
    if case == "runs":                 # sorted runs across thread (8 slots)
        lens = [7, 9, 31, 33, 250, 260, 1, 8, 16, 257]   # and warp (256)
        rows = np.repeat(np.arange(c), np.resize(lens, c))[:c]
        return np.broadcast_to(np.minimum(rows, m - 1), (t, c))
    if case == "out_of_range":         # -1, M, M + 100 add nothing
        local = rng.integers(0, m, (t, c))
        bad = rng.random((t, c)) < 0.15
        local[bad] = rng.choice([-1, m, m + 100], int(bad.sum()))
        return local
    raise ValueError(case)


def _off_by_one(t, dev):
    """``t`` on ``dev``, one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    flat[1:] = t.reshape(-1).to(dev)
    return flat[1:].view(t.shape)


# (mode, local_row case, (T, S, L, M)): seg_scan on the packer's sorted
# rows (it reads seg_end, never local_row); one-hot on those, on unsorted,
# one-row, run and out-of-range rows, at C = 21 and 12 (not multiples of
# 8: scalar loads) and with arrays off the 16-byte alignment
SEG_CASES = [("seg_scan", "sorted", (9, 8, 128, 96)),
             ("seg_scan", "sorted", (9, 3, 7, 5)),
             ("onehot_mxu", "sorted", (9, 8, 128, 96)),
             ("onehot_mxu", "unsorted", (9, 8, 128, 96)),
             ("onehot_mxu", "one_row", (9, 16, 128, 96)),
             ("onehot_mxu", "runs", (9, 16, 128, 96)),
             ("onehot_mxu", "out_of_range", (9, 16, 128, 96)),
             ("onehot_mxu", "out_of_range", (9, 3, 7, 5)),
             ("onehot_mxu", "unsorted", (9, 3, 4, 10)),
             ("onehot_mxu", "unaligned", (9, 16, 128, 96))]


@pytest.mark.parametrize("mode,case,shape", SEG_CASES)
@pytest.mark.parametrize("vd", VALS)
@pytest.mark.parametrize("cd", COLS)
def test_seg_kernels_match_plain(dev, mode, case, shape, vd, cd):
    """K3/K4 and K6 (tiles_per_step 1, 3, 8 with T = 9; rows straddling
    tiles; n_rows cutting the last)."""
    rng = np.random.default_rng(1)
    n_cols = 2000
    T, S, L, M = shape
    local, end = _seg_case(rng, T, S, L, M)
    if case not in ("sorted", "unaligned"):
        local = torch.from_numpy(np.ascontiguousarray(_onehot_rows(
            rng, case, T, S * L, M), dtype=np.int32).reshape(T, S, L))
    vals = torch.from_numpy(rng.standard_normal((T, S, L))).to(vd)
    cols = torch.from_numpy(rng.integers(0, n_cols, (T, S, L))).to(cd)
    x = torch.from_numpy(rng.standard_normal(n_cols).astype(np.float32))
    r0 = torch.from_numpy((np.arange(T) * 50).astype(np.int32))
    g = ((lambda t: _off_by_one(t, dev)) if case == "unaligned"
         else (lambda t: t.to(dev)))
    _close(ops.seg_spmv(g(vals), g(cols), g(local), g(end), g(x), M,
                        mode=mode),
           ref.seg_spmv_ref(vals, cols, local, end, x, M, mode))
    for k in (1, 3, 8):
        _close(ops.seg_spmv_fused(g(vals), g(cols), g(local), g(end), g(r0),
                                  g(x), M, n_rows=420, mode=mode,
                                  tiles_per_step=k, rows=_rows(
                                      g, vals, local, end, r0, M, 420, mode)),
               ref.seg_spmv_fused_ref(vals, cols, local, end, r0, x, M,
                                      n_rows=420, mode=mode))
    torch.cuda.synchronize()


@pytest.mark.parametrize("reduce", ["SEG_SCAN_RED", "ONEHOT_MXU_RED",
                                    "GMEM_ATOM_RED", "LANE_TOTAL_RED"])
def test_cuda_compile_matches_oracle(dev, reduce):
    m = tm.powerlaw_matrix(3000, 2800, 6.0, 1.2, seed=3)
    layout = ((OpSpec.make("TILE_ROW_BLOCK", rows=32),
               OpSpec.make("LANE_ROW_BLOCK"))
              if reduce == "LANE_TOTAL_RED"
              else (OpSpec.make("LANE_NNZ_BLOCK", chunk=512),))
    g = OperatorGraph.chain(OpSpec.make("COMPRESS"), *layout,
                            OpSpec.make(reduce))
    plan = repro_torch.compile(m, repro_torch.Target(), graph=g)
    x = np.random.default_rng(0).standard_normal(m.n_cols).astype(np.float32)
    y = plan(x)
    assert y.is_cuda
    o = m.spmv_dense_oracle(x)
    assert np.abs(y.cpu().numpy() - o).max() <= 1e-4 * np.abs(o).max()


# ----------------------------- multi-RHS (SpMM) -----------------------------

STORAGE = [(torch.float32, torch.int32, torch.float32),
           (torch.bfloat16, torch.int16, torch.float32),
           (torch.bfloat16, torch.int16, torch.bfloat16)]


# (T, R, W): warps per row 1 (W = 9, 33, 37; 5120 rows) up to 8 (W = 400
# and 1000 at few rows); the serving bucket of one tile, W = 397
ELL_SPMM_SHAPES = [(7, 24, 37), (3, 24, 9), (3, 24, 33), (1, 128, 397),
                   (2, 16, 400), (1, 5, 1000), (40, 128, 20)]


@pytest.mark.parametrize("t,r,w", ELL_SPMM_SHAPES)
@pytest.mark.parametrize("b", [1, 3, 8, 17, 40])
@pytest.mark.parametrize("vd,cd,xd", STORAGE)
def test_ell_spmm_kernels_match_plain(dev, b, vd, cd, xd, t, r, w):
    """K7, K8 and K9 (T not a multiple of tiles_per_step 3 or 8; n_rows
    cuts into the last tile; B above the 32-column chunk)."""
    rng = np.random.default_rng(b * 1000 + w)
    n_cols = 3000
    vals = torch.from_numpy(rng.standard_normal((t, r, w))).to(vd)
    cols = torch.from_numpy(rng.integers(0, n_cols, (t, r, w))).to(cd)
    x = torch.from_numpy(rng.standard_normal((n_cols, b))).to(xd)
    g = [z.to(dev) for z in (vals, cols, x)]
    _close(ops.ell_spmm(*g), ref.ell_spmm_ref(vals, cols, x))
    _close(ops.ell_spmm_direct(*g), ref.ell_spmm_direct_ref(vals, cols, x))
    n_rows = 11 + t * r - r // 2
    for k in (1, 3, 8):
        _close(ops.ell_spmm_fused(*g, n_rows=n_rows, row0=11,
                                  tiles_per_step=k),
               ref.ell_spmm_fused_ref(vals, cols, x, n_rows=n_rows, row0=11))
    torch.cuda.synchronize()


@pytest.mark.parametrize("b", [4, 8, 40])
@pytest.mark.parametrize("vd,cd,xd", STORAGE)
def test_ell_spmm_unaligned_x(dev, b, vd, cd, xd):
    """B a multiple of 4 but x one element off the 16-byte (8-byte for
    bf16) alignment: K7-K9 take one column per lane instead of four."""
    rng = np.random.default_rng(b)
    n_cols = 1000
    vals = torch.from_numpy(rng.standard_normal((3, 16, 45))).to(vd)
    cols = torch.from_numpy(rng.integers(0, n_cols, (3, 16, 45))).to(cd)
    x = torch.from_numpy(rng.standard_normal((n_cols, b))).to(xd)
    flat = torch.empty(x.numel() + 1, dtype=xd, device=dev)
    flat[1:] = x.reshape(-1).to(dev)
    xs = flat[1:].view(n_cols, b)
    v, c = vals.to(dev), cols.to(dev)
    _close(ops.ell_spmm(v, c, xs), ref.ell_spmm_ref(vals, cols, x))
    _close(ops.ell_spmm_direct(v, c, xs),
           ref.ell_spmm_direct_ref(vals, cols, x))
    _close(ops.ell_spmm_fused(v, c, xs, n_rows=40, row0=2, tiles_per_step=3),
           ref.ell_spmm_fused_ref(vals, cols, x, n_rows=40, row0=2))
    torch.cuda.synchronize()


@pytest.mark.parametrize("b", [1, 3, 8, 17])
@pytest.mark.parametrize("mode", ["seg_scan", "onehot_mxu"])
@pytest.mark.parametrize("vd,cd,xd", STORAGE)
def test_seg_spmm_kernels_match_plain(dev, b, mode, vd, cd, xd):
    """K10a/K10b and K11 (tiles_per_step 1, 3, 8 with T = 7), plus one
    padding tile (every end 0) and unused segment slots (end = C)."""
    rng = np.random.default_rng(10 + b)
    n_cols = 2000
    T, S, L, M = 7, 8, 128, 200
    local, end = _seg_case(rng, T, S, L, M)
    end[-1] = 0                          # a padding tile
    local[-1] = 0
    vals = torch.from_numpy(rng.standard_normal((T, S, L))).to(vd)
    vals[-1] = 0
    cols = torch.from_numpy(rng.integers(0, n_cols, (T, S, L))).to(cd)
    x = torch.from_numpy(rng.standard_normal((n_cols, b))).to(xd)
    r0 = torch.from_numpy((np.arange(T) * 150).astype(np.int32))
    g = lambda t: t.to(dev)
    _close(ops.seg_spmm(g(vals), g(cols), g(local), g(end), g(x), M,
                        mode=mode),
           ref.seg_spmm_ref(vals, cols, local, end, x, M, mode))
    for k in (1, 3, 8):
        _close(ops.seg_spmm_fused(g(vals), g(cols), g(local), g(end), g(r0),
                                  g(x), M, n_rows=1000, mode=mode,
                                  tiles_per_step=k, rows=_rows(
                                      g, vals, local, end, r0, M, 1000, mode)),
               ref.seg_spmm_fused_ref(vals, cols, local, end, r0, x, M,
                                      n_rows=1000, mode=mode))
    torch.cuda.synchronize()


@pytest.mark.parametrize("b", [8, 17, 40])
@pytest.mark.parametrize("mode", ["seg_scan", "onehot_mxu"])
def test_seg_spmm_full_chunk(dev, b, mode):
    """C = 8192 slots per tile (LANE_NNZ_BLOCK's largest chunk) and M =
    700: a stored (C, B) scan would not fit a block's shared memory, and at
    B = 40 the (M, B) accumulator passes 48 KB (the opt-in)."""
    rng = np.random.default_rng(b)
    n_cols = 4000
    T, S, L, M = 3, 64, 128, 700
    local, end = _seg_case(rng, T, S, L, M)
    vals = torch.from_numpy(rng.standard_normal((T, S, L)).astype(np.float32))
    cols = torch.from_numpy(rng.integers(0, n_cols, (T, S, L)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((n_cols, b)).astype(np.float32))
    r0 = torch.from_numpy((np.arange(T) * 600).astype(np.int32))
    g = lambda t: t.to(dev)
    _close(ops.seg_spmm(g(vals), g(cols), g(local), g(end), g(x), M,
                        mode=mode),
           ref.seg_spmm_ref(vals, cols, local, end, x, M, mode))
    _close(ops.seg_spmm_fused(g(vals), g(cols), g(local), g(end), g(r0),
                              g(x), M, n_rows=1900, mode=mode,
                              tiles_per_step=3, rows=_rows(
                                  g, vals, local, end, r0, M, 1900, mode)),
           ref.seg_spmm_fused_ref(vals, cols, local, end, r0, x, M,
                                  n_rows=1900, mode=mode))
    torch.cuda.synchronize()


def _check_seg_spmm(g, vals, cols, local, end, x, m, mode, r0, n_rows,
                    ks=(1, 3, 8)):
    """K10 and K11 (at each tiles_per_step) against their plain versions;
    ``g`` moves a tensor to the card."""
    _close(ops.seg_spmm(g(vals), g(cols), g(local), g(end), g(x), m,
                        mode=mode),
           ref.seg_spmm_ref(vals, cols, local, end, x, m, mode))
    for k in ks:
        _close(ops.seg_spmm_fused(g(vals), g(cols), g(local), g(end), g(r0),
                                  g(x), m, n_rows=n_rows, mode=mode,
                                  tiles_per_step=k, rows=_rows(
                                      g, vals, local, end, r0, m, n_rows,
                                      mode)),
               ref.seg_spmm_fused_ref(vals, cols, local, end, r0, x, m,
                                      n_rows=n_rows, mode=mode))
    torch.cuda.synchronize()


# (local_row case, (T, S, L, M)) for K10b / K11 in one-hot mode: the
# packer's sorted rows, unsorted, one-row, run and out-of-range rows, at
# C = 21 and 12 (not multiples of 8: scalar loads) and with the arrays and
# x off the 16-byte alignment (scalar loads and one column per x gather)
ONEHOT_SPMM_CASES = [("sorted", (9, 16, 128, 96)),
                     ("unsorted", (9, 16, 128, 96)),
                     ("one_row", (9, 16, 128, 96)),
                     ("runs", (9, 16, 128, 96)),
                     ("out_of_range", (9, 16, 128, 96)),
                     ("out_of_range", (9, 3, 7, 5)),
                     ("unsorted", (9, 3, 4, 10)),
                     ("unaligned", (9, 16, 128, 96))]


@pytest.mark.parametrize("case,shape", ONEHOT_SPMM_CASES)
@pytest.mark.parametrize("b", [1, 3, 8, 12, 17, 40])
@pytest.mark.parametrize("vd,cd,xd", STORAGE)
def test_onehot_seg_spmm_kernels_on_any_local_row(dev, case, shape, b, vd,
                                                   cd, xd):
    """K10b and K11 in one-hot mode sum runs of equal local rows: right for
    rows in any order, repeated, or outside [0, M), with runs that cross
    a thread's 8 slots, a warp and a 2048-slot pass. B = 8 and 40 take
    two lanes a slot, B = 12 one lane and 4 columns a gather."""
    rng = np.random.default_rng(b * 7 + shape[1])
    n_cols = 2000
    T, S, L, M = shape
    local, end = _seg_case(rng, T, S, L, M)
    if case not in ("sorted", "unaligned"):
        local = torch.from_numpy(np.ascontiguousarray(_onehot_rows(
            rng, case, T, S * L, M), dtype=np.int32).reshape(T, S, L))
    vals = torch.from_numpy(rng.standard_normal((T, S, L))).to(vd)
    cols = torch.from_numpy(rng.integers(0, n_cols, (T, S, L))).to(cd)
    x = torch.from_numpy(rng.standard_normal((n_cols, b))).to(xd)
    r0 = torch.from_numpy((np.arange(T) * 50).astype(np.int32))
    g = ((lambda t: _off_by_one(t, dev)) if case == "unaligned"
         else (lambda t: t.to(dev)))
    _check_seg_spmm(g, vals, cols, local, end, x, M, "onehot_mxu", r0, 420)


def _ends(rng, case, t, c, m):
    """(t, m) seg_end rows the packer never writes (descending, repeated,
    past C, below 0, any of these) or a padding tile (every end 0)."""
    if case == "descending":
        end = rng.integers(0, c + 1, (t, m))
        end[0] = np.sort(end[0])[::-1]
    elif case == "repeated":
        end = np.sort(rng.choice([0, c // 3, c // 3, c - 1, c], (t, m)),
                      axis=1)
        end[0] = c // 2
    elif case == "past_c":
        end = np.sort(rng.integers(0, c + 1, (t, m)), axis=1)
        end[:, -3:] = [c + 1, c + 7, 2 * c]
    elif case == "negative":
        end = np.sort(rng.integers(0, c + 1, (t, m)), axis=1)
        end[:, :3] = [-5, -1, 0]
    elif case == "mixed":
        end = rng.integers(-3, c + 4, (t, m))
    else:   # padding: the packer's ends, and a last tile of ends 0
        end = np.sort(rng.integers(0, c + 1, (t, m)), axis=1)
        end[-1] = 0
    return torch.from_numpy(end.astype(np.int32))


@pytest.mark.parametrize("case", ["descending", "repeated", "past_c",
                                  "negative", "mixed", "padding"])
@pytest.mark.parametrize("b", [1, 3, 8, 17, 40])
@pytest.mark.parametrize("vd,cd,xd", STORAGE)
def test_seg_scan_spmm_kernels_on_any_ends(dev, case, b, vd, cd, xd):
    """K10a and K11 in seg_scan mode on ends the packer never writes: a
    tile whose ends descend anywhere takes the signed range-sum path
    (exact zeros for repeated ends, ends clamped to [0, C])."""
    rng = np.random.default_rng(b * 11 + len(case))
    n_cols = 2000
    T, S, L, M = 7, 4, 128, 24
    end = _ends(rng, case, T, S * L, M)
    local = torch.zeros((T, S, L), dtype=torch.int32)   # seg_scan: unread
    vals = torch.from_numpy(rng.standard_normal((T, S, L))).to(vd)
    cols = torch.from_numpy(rng.integers(0, n_cols, (T, S, L))).to(cd)
    x = torch.from_numpy(rng.standard_normal((n_cols, b))).to(xd)
    r0 = torch.from_numpy((np.arange(T) * 20).astype(np.int32))
    _check_seg_spmm(lambda t: t.to(dev), vals, cols, local, end, x, M,
                    "seg_scan", r0, 150)


def _check_seg_scan(g, vals, cols, end, x, m, r0, n_rows, ks=(1, 3, 8, 16)):
    """K3 and K6 in seg_scan mode (K6 at each tiles_per_step) against
    their plain versions; ``g`` moves a tensor to the card."""
    local = torch.zeros(vals.shape, dtype=torch.int32)   # seg_scan: unread
    _close(ops.seg_spmv(g(vals), g(cols), g(local), g(end), g(x), m,
                        mode="seg_scan"),
           ref.seg_spmv_ref(vals, cols, local, end, x, m, "seg_scan"))
    for k in ks:
        _close(ops.seg_spmv_fused(g(vals), g(cols), g(local), g(end), g(r0),
                                  g(x), m, n_rows=n_rows, mode="seg_scan",
                                  tiles_per_step=k, rows=_rows(
                                      g, vals, local, end, r0, m, n_rows,
                                      "seg_scan")),
               ref.seg_spmv_fused_ref(vals, cols, local, end, r0, x, m,
                                      n_rows=n_rows, mode="seg_scan"))
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["descending", "repeated", "past_c",
                                  "negative", "mixed", "padding"])
@pytest.mark.parametrize("vd,cd,xd", STORAGE)
def test_seg_scan_kernels_on_any_ends(dev, case, vd, cd, xd):
    """K3 and K6 in seg_scan mode on ends the packer never writes: g[m] is
    read from the stored inclusive sums at any end, so a descending pair
    gives a negated range sum, a repeated end an exact zero, and ends are
    clamped to [0, C]."""
    rng = np.random.default_rng(len(case))
    n_cols = 2000
    T, S, L, M = 7, 4, 128, 24
    end = _ends(rng, case, T, S * L, M)
    vals = torch.from_numpy(rng.standard_normal((T, S, L))).to(vd)
    cols = torch.from_numpy(rng.integers(0, n_cols, (T, S, L))).to(cd)
    x = torch.from_numpy(rng.standard_normal(n_cols)).to(xd)
    r0 = torch.from_numpy((np.arange(T) * 20).astype(np.int32))
    _check_seg_scan(lambda t: t.to(dev), vals, cols, end, x, M, r0, 150)


# (T, S, L, M) for K3 / K6 in seg_scan mode: C = 21 (scalar loads; a
# thread's 8 slots cross tiles), 512 (a 2048-slot pass spans four tiles),
# 2048 (one tile a pass) and 8192 (four passes a tile, with a carry); T is
# not a multiple of tiles_per_step 3, 8 or 16
SCAN_WIDTHS = [(37, 3, 7, 5), (37, 4, 128, 60), (9, 16, 128, 300),
               (3, 64, 128, 700), (2, 96, 128, 300)]


@pytest.mark.parametrize("t,s,l,m", SCAN_WIDTHS)
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("vd,cd,xd", STORAGE)
def test_seg_scan_kernels_at_each_width(dev, t, s, l, m, aligned, vd, cd,
                                        xd):
    """K3 and K6 in seg_scan mode on the packer's ends at each tile width
    the kernel maps differently, with the arrays on or off the 16-byte
    alignment (16-byte or scalar loads); K6 gives the same sums at
    tiles_per_step 1, 3, 8 and 16."""
    rng = np.random.default_rng(t * s * l + m)
    n_cols = 3000
    _, end = _seg_case(rng, t, s, l, m)
    vals = torch.from_numpy(rng.standard_normal((t, s, l))).to(vd)
    cols = torch.from_numpy(rng.integers(0, n_cols, (t, s, l))).to(cd)
    x = torch.from_numpy(rng.standard_normal(n_cols)).to(xd)
    r0 = torch.from_numpy((np.arange(t) * (m // 2)).astype(np.int32))
    g = ((lambda z: z.to(dev)) if aligned
         else (lambda z: _off_by_one(z, dev)))
    _check_seg_scan(g, vals, cols, end, x, m, r0, (m // 2) * t + 7)


def test_seg_scan_kernels_many_segments(dev):
    """M = 60000 segments over tiles of C = 8192 slots: the block's shared
    memory holds the tile's sums and does not grow with M."""
    rng = np.random.default_rng(60000)
    n_cols = 4000
    T, S, L, M = 2, 64, 128, 60000
    _, end = _seg_case(rng, T, S, L, M)
    vals = torch.from_numpy(rng.standard_normal((T, S, L)).astype(np.float32))
    cols = torch.from_numpy(rng.integers(0, n_cols, (T, S, L)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal(n_cols).astype(np.float32))
    r0 = torch.from_numpy((np.arange(T) * 100).astype(np.int32))
    _check_seg_scan(lambda z: z.to(dev), vals, cols, end, x, M, r0, 100 + M,
                    ks=(1, 2))


@pytest.mark.parametrize("b", [1, 8, 17])
@pytest.mark.parametrize("mode", ["seg_scan", "onehot_mxu"])
def test_seg_spmm_small_tiles_share_a_pass(dev, b, mode):
    """C = 512 (the searched serving plan's chunk): a block's 2048-slot
    pass spans four tiles. tiles_per_step 1, 3, 8 and 16 with T = 37, not
    a multiple of any, give the same sums."""
    rng = np.random.default_rng(b)
    n_cols = 3000
    T, S, L, M = 37, 4, 128, 8
    local, end = _seg_case(rng, T, S, L, M)
    vals = torch.from_numpy(rng.standard_normal((T, S, L)).astype(np.float32))
    cols = torch.from_numpy(rng.integers(0, n_cols, (T, S, L)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((n_cols, b)).astype(np.float32))
    r0 = torch.from_numpy((np.arange(T) * 6).astype(np.int32))
    _check_seg_spmm(lambda t: t.to(dev), vals, cols, local, end, x, M, mode,
                    r0, 6 * T, ks=(1, 3, 8, 16))


@pytest.mark.parametrize("mode,m,b", [("onehot_mxu", 8192, 8),
                                      ("seg_scan", 8192, 8),
                                      ("onehot_mxu", 60000, 1),
                                      ("seg_scan", 60000, 1)])
def test_seg_spmm_windows_smaller_than_a_tile(dev, mode, m, b):
    """One tile's M x B accumulator beyond the block's shared memory: at
    M = 8192, B = 8 a window takes fewer columns; at M = 60000 part of the
    tile's segments, and the tile is read once per window."""
    rng = np.random.default_rng(m + b)
    n_cols = 4000
    T, S, L = 2, 64, 128
    local, end = _seg_case(rng, T, S, L, m)
    vals = torch.from_numpy(rng.standard_normal((T, S, L)).astype(np.float32))
    cols = torch.from_numpy(rng.integers(0, n_cols, (T, S, L)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((n_cols, b)).astype(np.float32))
    r0 = torch.from_numpy((np.arange(T) * 100).astype(np.int32))
    _check_seg_spmm(lambda t: t.to(dev), vals, cols, local, end, x, m, mode,
                    r0, 100 + m, ks=(1, 2))


@pytest.mark.parametrize("mode", ["seg_scan", "onehot_mxu"])
def test_seg_spmm_window_of_exactly_48_kb(dev, mode):
    """C = 512, M = 384, B = 8, T = 6: a window of four tiles takes exactly
    48 KB of dynamic shared memory, which with the kernel's own __shared__
    array needs the opt-in (a candidate of the B = 8 search on the CLI's
    demo matrix launched it without one and failed)."""
    rng = np.random.default_rng(48)
    n_cols = 2000
    T, S, L, M = 6, 4, 128, 384
    local, end = _seg_case(rng, T, S, L, M)
    vals = torch.from_numpy(rng.standard_normal((T, S, L)).astype(np.float32))
    cols = torch.from_numpy(rng.integers(0, n_cols, (T, S, L)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((n_cols, 8)).astype(np.float32))
    r0 = torch.from_numpy((np.arange(T) * 300).astype(np.int32))
    _check_seg_spmm(lambda t: t.to(dev), vals, cols, local, end, x, M, mode,
                    r0, 300 * T + M, ks=(1, 3))


@pytest.mark.parametrize("reduce", ["SEG_SCAN_RED", "ONEHOT_MXU_RED",
                                    "GMEM_ATOM_RED", "LANE_TOTAL_RED"])
def test_cuda_compile_spmm_matches_oracle(dev, reduce):
    m = tm.powerlaw_matrix(3000, 2800, 6.0, 1.2, seed=3)
    layout = ((OpSpec.make("TILE_ROW_BLOCK", rows=32),
               OpSpec.make("LANE_ROW_BLOCK"))
              if reduce == "LANE_TOTAL_RED"
              else (OpSpec.make("LANE_NNZ_BLOCK", chunk=512),))
    g = OperatorGraph.chain(OpSpec.make("COMPRESS"), *layout,
                            OpSpec.make(reduce))
    plan = repro_torch.compile(m, repro_torch.Target(batch_size=8), graph=g)
    x = np.random.default_rng(0).standard_normal(
        (m.n_cols, 8)).astype(np.float32)
    y = plan(x)
    assert y.is_cuda and y.shape == (m.n_rows, 8)
    o = m.spmm_dense_oracle(x)
    assert np.abs(y.cpu().numpy() - o).max() <= 1e-4 * np.abs(o).max()


def test_spmv_engine_on_the_card(dev):
    """Ragged waves through PlanExecutor + SpmvEngine on a searched B = 4
    plan; every bucket is hit and every answer matches the oracle."""
    from repro_torch.serve import (MatvecRequest, PlanExecutor, SpmvEngine,
                                   prune_magnitude)
    rng = np.random.default_rng(4)
    m = prune_magnitude(rng.standard_normal((512, 384)).astype(np.float32),
                        0.08)
    plan = repro_torch.compile(
        m, repro_torch.Target(batch_size=4),
        budget=repro_torch.SearchConfig(max_seconds=20, max_structures=2,
                                        coarse_samples=2, timing_repeats=1,
                                        seed=0))
    ex = PlanExecutor(plan, m)
    ex.warmup()
    eng = SpmvEngine(ex)
    reqs = []
    for n in (5, 1, 2, 3, 9):
        wave = [MatvecRequest(len(reqs) + i,
                              rng.standard_normal(m.n_cols).astype(np.float32))
                for i in range(n)]
        reqs += wave
        out = eng.run(wave)
        assert out["failed"] == 0 and out["dropped"] == 0
    for r in reqs:
        assert r.status == "ok"
        o = m.spmv_dense_oracle(r.x)
        assert np.abs(r.y - o).max() <= 1e-3 * np.abs(o).max() + 1e-5


@functools.cache
def _smoke():
    """``chip_smoke.py`` (the repository's smoke run on the card), whose
    row-sum probe and bucket-moving mutation these tests share."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_row_sums_do_not_depend_on_width_or_launch(dev):
    """A row padded with zero slots to each W and launched among 1, 128
    and 65,536 rows of random others: K1 and K5 give it the same bits
    everywhere, as do K7 and K9 at B = 8, and the grouped K1 and K7 with
    its bucket between two others (several random rows: a short row's
    sums in two orders agree by chance about one time in three);
    ``row_sum_bits`` holds K1's sum to its plain version."""
    smoke = _smoke()
    for n, widths, seeds in smoke.ROW_SUM_CASES:
        for seed in range(seeds):
            got = smoke.row_sum_bits(n, widths, seed)
            distinct = {k: len(v) for k, v in got.items()}
            assert all(v == 1 for v in distinct.values()), (n, seed, distinct)
            assert got["K1"] == got["K5"] and got["K7"] == got["K9"]


# (T, R, W) buckets of a grouped launch: K1's slab widths (<= 32) and
# split-row widths, a serving tile, a bucket of one row
GROUP_SHAPES = [(1, 128, 397), (3, 16, 33), (2, 24, 9), (1, 5, 1000),
                (4, 128, 40), (1, 1, 64), (7, 8, 32)]


def _group_case(rng, shapes, n_cols, vd, cd):
    vals = [torch.from_numpy(rng.standard_normal(s)).to(vd) for s in shapes]
    cols = [torch.from_numpy(rng.integers(0, n_cols, s)).to(cd)
            for s in shapes]
    return vals, cols


@pytest.mark.parametrize("b", [1, 3, 8, 17])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("vd,cd,xd", STORAGE)
def test_grouped_kernels_match_plain_and_the_per_bucket_kernels(
        dev, b, aligned, vd, cd, xd):
    """The grouped K1 (a 1-D x) and K7 over buckets of several widths:
    within the tolerance of their plain versions, and each row the bits of
    its bucket's own K1 / K7 launch (x one element off its alignment too,
    where K7 takes one column a lane); columns out of range add 0, as in
    the per-bucket kernels."""
    rng = np.random.default_rng(b + 10 * aligned)
    n_cols = 3000
    vals, cols = _group_case(rng, GROUP_SHAPES, n_cols, vd, cd)
    cols[1][0, 3, :5] = -1
    cols[4][2, 7, 3] = n_cols
    x = torch.from_numpy(rng.standard_normal(
        (n_cols,) if b == 1 else (n_cols, b))).to(xd)
    flat = torch.empty(x.numel() + (0 if aligned else 1), dtype=xd,
                       device=dev)
    flat[flat.numel() - x.numel():] = x.reshape(-1).to(dev)
    xs = flat[flat.numel() - x.numel():].view(x.shape)
    gv, gc = [v.to(dev) for v in vals], [c.to(dev) for c in cols]
    group = ops.TileGroup(gv, gc)
    if b == 1:
        got = ops.ell_spmv_grouped(group, xs)
        per = torch.cat([ops.ell_spmv(v, c, xs).reshape(-1)
                         for v, c in zip(gv, gc)])
    else:
        got = ops.ell_spmm_grouped(group, xs)
        per = torch.cat([ops.ell_spmm(v, c, xs).reshape(-1, b)
                         for v, c in zip(gv, gc)])
    assert torch.equal(got, per)
    keep = [c.clamp(0, n_cols - 1) for c in cols]
    zero = [torch.where((c >= 0) & (c < n_cols), v.float(), 0.0).to(vd)
            for v, c in zip(vals, cols)]
    plain = (ref.ell_spmv_grouped_ref(zero, keep, x) if b == 1
             else ref.ell_spmm_grouped_ref(zero, keep, x))
    _close(got, plain)
    torch.cuda.synchronize()


@pytest.mark.parametrize("b", [1, 8])
def test_grouped_launch_splits_past_group_max(dev, b):
    """A group of more buckets than a launch's parameters hold runs as
    several launches into one slab, each row with its bucket's bits."""
    rng = np.random.default_rng(b)
    n_cols = 500
    shapes = [(1 + i % 3, 8, 33 + i) for i in range(ops.GROUP_MAX + 6)]
    vals, cols = _group_case(rng, shapes, n_cols, torch.float32,
                             torch.int32)
    x = torch.from_numpy(rng.standard_normal(
        (n_cols,) if b == 1 else (n_cols, b)).astype(np.float32)).to(dev)
    gv, gc = [v.to(dev) for v in vals], [c.to(dev) for c in cols]
    group = ops.TileGroup(gv, gc)
    assert len(group.chunks) == 2
    op, one = ((ops.ell_spmv_grouped, ops.ell_spmv) if b == 1
               else (ops.ell_spmm_grouped, ops.ell_spmm))
    before = ops.launch_counts()
    got = op(group, x)
    kid = "K1" if b == 1 else "K7"
    assert ops.launch_counts()[kid] == before[kid] + 2
    per = torch.cat([one(v, c, x).reshape((-1,) + tuple(got.shape[1:]))
                     for v, c in zip(gv, gc)])
    assert torch.equal(got, per)


def _bucketed(n_buckets, base, tile_rows=16, n_cols=3000, seed=0):
    """Row tiles of ``n_buckets`` widths base, base + 1, ..., 1-3 tiles
    each, shuffled: an ELL plan of one width bucket per width."""
    rng = np.random.default_rng(seed)
    widths = [base + i for i in range(n_buckets) for _ in range(1 + i % 3)]
    rng.shuffle(widths)
    rows, cols = [], []
    for t, w in enumerate(widths):
        for r in range(tile_rows):
            n = w if r == 0 else int(rng.integers(1, w + 1))
            rows.append(np.full(n, t * tile_rows + r, np.int32))
            cols.append(rng.choice(n_cols, n, replace=False).astype(np.int32))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return tm.SparseMatrix(len(widths) * tile_rows, n_cols, rows, cols,
                           rng.standard_normal(rows.size).astype(
                               np.float32)).canonical()


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("base", [25, 33])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_plan_call_equals_the_per_step_call(dev, b, base, fused,
                                                    dtype):
    """An ELL plan of 26 width buckets (25-50 slots: K1's slab buckets
    among them, or 33-58) on the card: the grouped call gives the
    per-step loop's bits, launching one grouped kernel and one combine
    for the scatter buckets (with a 1-D x, K1's slab buckets one launch
    each), and the oracle's answer within the search tolerance."""
    from repro_torch.core.graph import run_graph
    from repro_torch.core.kernel_builder import ELL_GROUPS, build_program
    m = _bucketed(26, base, seed=base)
    graph = OperatorGraph.chain(OpSpec.make("COMPRESS"),
                                OpSpec.make("TILE_ROW_BLOCK", rows=16),
                                OpSpec.make("LANE_ROW_BLOCK"),
                                OpSpec.make("LANE_TOTAL_RED"))
    prog = build_program(run_graph(m, graph), "cuda", fuse_combine=fused,
                         storage_dtype=dtype)
    steps = prog.spec["steps"]
    assert len(steps) == 26
    per_step = {k: v for k, v in prog.order.items() if k != ELL_GROUPS}
    rng = np.random.default_rng(b)
    x = torch.from_numpy(rng.standard_normal(
        (m.n_cols,) if b == 1 else (m.n_cols, b)).astype(np.float32)).to(dev)
    before = ops.launch_counts()
    y = prog(x)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in ops.launch_counts().items()
           if v != before[k]}
    fused_n = sum(bool(st.get("fused")) for st in steps)
    alone = [st for st in steps if b == 1 and not st.get("fused")
             and prog.fmt[f"{st['key']}_vals"].shape[2] <= 32]
    scatter = sum(st["combine"]["mode"] == "rowmap" for st in alone)
    kid, fid = ("K1", "K5") if b == 1 else ("K7", "K9")
    want = {kid: 1 + len(alone), "rowmap_combine": 1 + scatter}
    if fused_n:
        want[fid] = fused_n
    assert got == want
    assert torch.equal(y, prog.fn(prog.fmt, x, per_step))
    oracle = (m.spmv_dense_oracle(x.cpu().numpy()) if b == 1
              else m.spmm_dense_oracle(x.cpu().numpy()))
    tol = 1e-3 if dtype == "float32" else 2e-2
    assert np.abs(y.cpu().numpy() - oracle).max() <= (
        tol * np.abs(oracle).max() + 1e-5)


def test_rowmap_combine_matches_plain_and_repeats_bit_for_bit(dev):
    from repro_torch.kernels.combine import combine_order
    rng = np.random.default_rng(3)
    for n_rows, n, b in ((50, 4000, 1), (7, 300, 8), (1000, 50000, 3)):
        rm = torch.from_numpy(rng.integers(-1, n_rows, n).astype(np.int32))
        flat = torch.from_numpy(rng.standard_normal(
            (n,) if b == 1 else (n, b)).astype(np.float32))
        y0 = torch.from_numpy(rng.standard_normal(
            (n_rows,) if b == 1 else (n_rows, b)).astype(np.float32))
        perm, off = combine_order(rm, n_rows)
        want = ref.rowmap_combine_ref(y0.clone(), flat, perm, off)
        g = [t.to(dev) for t in (y0, flat, perm, off)]
        before = ops.rowmap_combine.launches
        outs = [ops.rowmap_combine(g[0].clone(), *g[1:]) for _ in range(3)]
        assert ops.rowmap_combine.launches == before + 3
        _close(outs[0], want)
        assert all(torch.equal(o, outs[0]) for o in outs)
        assert torch.equal(combine_order(rm.to(dev), n_rows)[0].cpu(),
                           perm)


# run lengths of the combine's cases, one row each, and one run of 20,000
RUN_LENGTHS = (0, 1, 2, 31, 32, 33, 41, 1000, 0, 20000, 3, 0)


def _in_order(y0, flat, perm, off):
    """The combine as an explicit loop on the CPU: each row's partials
    added into it one after another, in perm order, in float32."""
    y, f = y0.numpy().copy(), flat.numpy()
    p, o = perm.numpy(), off.numpy()
    for r in range(len(o) - 1):
        for j in range(o[r], o[r + 1]):
            y[r] = y[r] + f[p[j]]
    return torch.from_numpy(y)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("b", [1, 3, 4, 8, 17, 40])
def test_rowmap_combine_adds_each_run_in_perm_order(dev, b, aligned):
    """The combine, at every run length of RUN_LENGTHS (the partials of
    each row shuffled among the others', some partials with no row), into
    a y prefilled with non-zero values, and flat on or off its 16-byte
    alignment, bit for bit an in-order float32 loop on the CPU: through
    the wrapper, the bare ``perm, offsets`` form and the C entry, and with
    the same runs behind 70,000 empty rows, which give the card enough
    rows for one thread a row (rowmap_combine_thread) where the few rows
    get a group of lanes a row."""
    from repro_torch.kernels import combine
    rng = np.random.default_rng(b)
    rm = np.concatenate([np.full(n, r, np.int32)
                         for r, n in enumerate(RUN_LENGTHS)]
                        + [np.full(50, -1, np.int32)])
    rm = torch.from_numpy(rng.permutation(rm))
    n_rows, n = len(RUN_LENGTHS), rm.numel()
    rhs = () if b == 1 else (b,)
    store = torch.from_numpy(rng.standard_normal(n * b + 1).astype(
        np.float32))
    flat = (store[:-1] if aligned else store[1:]).reshape((n,) + rhs)
    y0 = torch.from_numpy(rng.standard_normal((n_rows,) + rhs).astype(
        np.float32))
    order = combine.combine_order(rm, n_rows)
    assert int((order.offsets[1:] - order.offsets[:-1]).max()) == 20000
    want = _in_order(y0, flat, *order)
    store_d = store.to(dev)
    flat_d = (store_d[:-1] if aligned else store_d[1:]).reshape((n,) + rhs)
    assert (flat_d.data_ptr() % 16 == 0) == aligned
    order_d = combine.combine_order(rm.to(dev), n_rows)
    before = ops.rowmap_combine.launches
    got = ops.rowmap_combine(y0.to(dev), flat_d, order_d)
    assert ops.rowmap_combine.launches == before + 1
    assert torch.equal(got.cpu(), want)
    bare = ops.rowmap_combine(y0.to(dev), flat_d, *order_d)
    assert torch.equal(bare.cpu(), want)
    lib = combine._lib()
    y = y0.to(dev)
    assert lib.rowmap_combine(
        y.data_ptr(), flat_d.data_ptr(), order_d.perm.data_ptr(),
        order_d.offsets.data_ptr(), n_rows, b, combine._stream(y)) == 0
    assert torch.equal(y.cpu(), want)
    many = 70000                         # empty rows after the runs
    off = torch.cat([order_d.offsets, order_d.offsets[-1:].expand(many)])
    y_many = torch.cat([y0, torch.from_numpy(rng.standard_normal(
        (many,) + rhs).astype(np.float32))])
    got = ops.rowmap_combine(y_many.to(dev), flat_d,
                             combine.CombineOrder(order_d.perm,
                                                  off.contiguous()))
    assert torch.equal(got.cpu()[:n_rows], want)
    assert torch.equal(got.cpu()[n_rows:], y_many[n_rows:])


def test_rowmap_combine_refuses_what_does_not_match_its_order(dev):
    from repro_torch.kernels import combine
    order = combine.combine_order(torch.tensor([2, 0, 2], device=dev), 3)
    flat = torch.ones(3, device=dev)
    with pytest.raises(ValueError, match="rows"):
        ops.rowmap_combine(torch.zeros(4, device=dev), flat, order)
    with pytest.raises(ValueError, match="columns"):
        ops.rowmap_combine(torch.zeros(3, 2, device=dev), flat, order)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rowmap_combine(torch.zeros(3, 2, device=dev)[:, 0], flat, order)
    with pytest.raises(TypeError, match="int32"):
        ops.rowmap_combine(torch.zeros(3, device=dev), flat,
                           order.perm.long(), order.offsets)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["row", "col"])
def test_folded_sharded_call_equals_the_per_shard_loop(dev, mode, dtype):
    """A 4-shard plan on cuda:0 (every shard on one card) runs one family
    kernel and one combine a step, over the folded operands, and gives
    bit for bit what one ``build_kernel`` run a shard over its stack
    slice (its own combine orders), then the bands or the shard-order
    sum, give on the card at B = 1 and 8; so does a plan whose shards
    each have another family (all-padding tiles on the others). The same
    plan on a mesh whose shards name the card two ways (``cuda`` and
    ``cuda:0`` compare unequal) runs ``make_stacked_fn`` once a shard,
    a family kernel and a combine a step and shard, with the same bits."""
    import itertools
    from repro_torch.core.kernel_builder import (SPEC_VERSION, build_kernel,
                                                 combine_orders)
    from repro_torch.dist import make_data_mesh
    from repro_torch.dist.mesh import DataMesh
    from repro_torch.dist.spmv import build_sharded_spmv, shard_map_spmv
    seg = lambda red: OperatorGraph.chain(
        OpSpec.make("COMPRESS"),
        OpSpec.make("LANE_NNZ_BLOCK", chunk=128, lanes=8), OpSpec.make(red))
    graphs = itertools.cycle([
        OperatorGraph.chain(OpSpec.make("COMPRESS"),
                            OpSpec.make("TILE_ROW_BLOCK", rows=16),
                            OpSpec.make("LANE_ROW_BLOCK"),
                            OpSpec.make("LANE_TOTAL_RED")),
        seg("SEG_SCAN_RED"), seg("ONEHOT_MXU_RED"), seg("GMEM_ATOM_RED")])
    m = tm.powerlaw_matrix(3000, 2800, 6.0, 1.2, seed=3)
    mesh = make_data_mesh(4, device="cuda:0")
    apart = DataMesh(tuple(torch.device("cuda", 0) if i % 2 else
                           torch.device("cuda") for i in range(4)))
    progs = [shard_map_spmv(m, mesh, mode=mode, storage_dtype=dtype),
             shard_map_spmv(m, mesh, mode=mode, storage_dtype=dtype,
                            graph_for=lambda sub: next(graphs))]
    for prog in progs:
        per_shard = build_sharded_spmv(prog.shards, prog.programs, apart)
        assert per_shard.operands.folded is None
        n = len(prog.shards)
        n_out = prog.band_rows if mode == "row" else prog.n_rows
        spec = {"version": SPEC_VERSION, "n_rows": n_out,
                "steps": prog.steps}
        run = build_kernel(spec, backend="cuda")
        width = -(-m.n_cols // n)
        for b in (1, 8):
            x = torch.from_numpy(np.random.default_rng(b).standard_normal(
                (width * n,) if b == 1 else (width * n, b)).astype(
                np.float32)).to(dev)
            x[m.n_cols:] = 0
            outs = []
            for i in range(n):
                fmt = {k: v[i] for k, v in prog.stacks.items()}
                xi = x[i * width:(i + 1) * width] if mode == "col" else \
                    x[:m.n_cols]
                outs.append(run(fmt, xi.contiguous(),
                                combine_orders(spec, fmt, "cuda")))
            if mode == "row":
                want = torch.cat([o[:s.size]
                                  for o, s in zip(outs, prog.shards)])
            else:
                want = outs[0].clone()
                for o in outs[1:]:
                    want += o
            counts = ops.launch_counts()
            got = prog(x[:m.n_cols])
            after = ops.launch_counts()
            launched = {k: after[k] - counts[k] for k in after
                        if after[k] != counts[k]}
            assert launched["rowmap_combine"] == len(prog.steps)
            assert sum(launched.values()) == 2 * len(prog.steps)
            assert torch.equal(got, want), (b, len(prog.steps))
            counts = ops.launch_counts()
            apart_y = per_shard(x[:m.n_cols])
            after = ops.launch_counts()
            assert after["rowmap_combine"] - counts["rowmap_combine"] == \
                n * len(prog.steps)
            assert sum(after.values()) - sum(counts.values()) == \
                2 * n * len(prog.steps)
            assert torch.equal(apart_y, want), (b, len(prog.steps))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["row", "col"])
def test_sharded_plan_on_the_card(dev, mode, dtype, tmp_path):
    """A 4-shard plan on cuda:0 (row/col; 1-D and B = 8; fp32 and bf16
    stacks) against its CPU twin on the torch backend and the oracle; two
    calls and the saved-and-loaded plan give the same bits; the ordered
    combine launched."""
    from repro_torch.dist import make_data_mesh
    m = tm.powerlaw_matrix(3000, 2800, 6.0, 1.2, seed=3)
    mesh = make_data_mesh(4, device="cuda:0")
    plan = repro_torch.compile(m, repro_torch.Target(
        mesh=mesh, partition=mode, dtype=dtype))
    twin = repro_torch.compile(m, repro_torch.Target(
        backend="torch", mesh=make_data_mesh(4, device="cpu"),
        partition=mode, dtype=dtype))
    assert plan.steps_json == twin.steps_json
    path = tmp_path / "sharded.plan.npz"
    plan.save(path)
    loaded = repro_torch.load_plan(path, mesh=mesh)
    for b in (1, 8):
        x = np.random.default_rng(b).standard_normal(
            (m.n_cols,) if b == 1 else (m.n_cols, b)).astype(np.float32)
        before = ops.rowmap_combine.launches
        y = plan(x)
        assert y.is_cuda and ops.rowmap_combine.launches > before
        _close(y, twin(x))
        o = m.spmv_dense_oracle(x) if b == 1 else m.spmm_dense_oracle(x)
        tol = 1e-4 if dtype == "float32" else 2e-2
        assert np.abs(y.cpu().numpy() - o).max() <= tol * np.abs(o).max()
        assert torch.equal(plan(x), y) and torch.equal(loaded(x), y)


def test_sharded_families_on_padding_tiles_on_the_card(dev):
    """Each shard designed with another family (ELL, seg_scan, one-hot,
    gmem_atom): every family's stack holds all-padding tiles for three of
    the four shards, and K1/K3/K4/K7/K10a/K10b run them; the answer holds
    to the oracle at B = 1 and 8."""
    import itertools
    from repro_torch.dist import make_data_mesh
    from repro_torch.dist.mesh import DataMesh
    from repro_torch.dist.spmv import build_sharded_spmv, shard_map_spmv
    seg = lambda red: OperatorGraph.chain(
        OpSpec.make("COMPRESS"),
        OpSpec.make("LANE_NNZ_BLOCK", chunk=128, lanes=8), OpSpec.make(red))
    graphs = itertools.cycle([
        OperatorGraph.chain(OpSpec.make("COMPRESS"),
                            OpSpec.make("TILE_ROW_BLOCK", rows=16),
                            OpSpec.make("LANE_ROW_BLOCK"),
                            OpSpec.make("LANE_TOTAL_RED")),
        seg("SEG_SCAN_RED"), seg("ONEHOT_MXU_RED"), seg("GMEM_ATOM_RED")])
    m = tm.powerlaw_matrix(3000, 2800, 6.0, 1.2, seed=4)
    for mode in ("row", "col"):
        prog = shard_map_spmv(m, make_data_mesh(4, device="cuda:0"),
                              mode=mode, graph_for=lambda sub: next(graphs))
        assert len(prog.steps) == 4
        for b in (1, 8):
            x = np.random.default_rng(b).standard_normal(
                (m.n_cols,) if b == 1 else (m.n_cols, b)).astype(np.float32)
            o = m.spmv_dense_oracle(x) if b == 1 else m.spmm_dense_oracle(x)
            y = prog(x).cpu().numpy()
            assert np.abs(y - o).max() <= 1e-4 * np.abs(o).max()


def test_sharded_searched_plan_on_the_card(dev):
    """dist_search on 4 shards of one card, pooled, with a shard that
    crashes: the shard falls back and the answer holds to the oracle."""
    import warnings
    from repro_torch.dist import make_data_mesh
    from repro_torch.dist.search import (ShardedSearchConfig, dist_search,
                                         shard_fault_hook)
    m = tm.powerlaw_matrix(4000, 4000, 8.0, 1.2, seed=5)
    cfg = ShardedSearchConfig(
        search=repro_torch.SearchConfig(max_seconds=8, max_structures=2,
                                        coarse_samples=1,
                                        fine_eval_budget=0,
                                        use_cost_model=False, seed=0),
        min_nnz_for_search=1)

    def crash(shard):
        if shard.index == 0:
            raise RuntimeError("injected shard crash")

    x = np.random.default_rng(0).standard_normal(m.n_cols).astype(np.float32)
    o = m.spmv_dense_oracle(x)
    mesh = make_data_mesh(4, device="cuda:0")
    res = dist_search(m, mesh, cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with shard_fault_hook(crash):
            hurt = dist_search(m, mesh, cfg)
    assert hurt.failed_shards() == [0]
    assert hurt.failure_counts.get("fallback") == 1
    for r in (res, hurt):
        y = r.program(x).cpu().numpy()
        assert np.abs(y - o).max() <= 1e-3 * np.abs(o).max() + 1e-5


def _keep_lengths_mutation(m, seed):
    """Revalue 10 %, drop 5 % and re-add one new entry into every row that
    lost one: every row keeps its length, so a fresh compile designs the
    same layout and the same kernel launches as the patched plan."""
    rng = np.random.default_rng(seed)
    vals = m.vals.copy()
    rev = rng.choice(m.nnz, m.nnz // 10, replace=False)
    vals[rev] = rng.standard_normal(rev.size).astype(np.float32) + 0.1
    drop = rng.choice(m.nnz, m.nnz // 20, replace=False)
    keep = np.ones(m.nnz, bool)
    keep[drop] = False
    dense = m.to_dense() != 0
    add_r, add_c = [], []
    for r in m.rows[drop]:
        free = np.nonzero(~dense[r])[0]
        c = int(rng.choice(free))
        dense[r, c] = True
        add_r.append(r)
        add_c.append(c)
    add_v = rng.standard_normal(len(add_r)).astype(np.float32) + 0.1
    return tm.SparseMatrix(
        m.n_rows, m.n_cols,
        np.concatenate([m.rows[keep], np.array(add_r, np.int32)]),
        np.concatenate([m.cols[keep], np.array(add_c, np.int32)]),
        np.concatenate([vals[keep], add_v])).canonical()


@pytest.mark.parametrize("delta_kind", ["keep_lengths", "move_buckets"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_on_the_card_matches_a_fresh_compile(dev, dtype, delta_kind):
    """SpmvPlan.update on the cuda backend (the reference's 96 x 96 dyn
    matrix, the capacity ELL design, which runs K1): bit-identical to a
    fresh cuda compile of the mutated matrix in its output, and, where
    every row keeps its length, tensor for tensor; the source plan still
    answers for the old matrix. A delta that shrinks rows leaves them in
    their buckets in the patched plan and moves them to narrower ones in
    the fresh compile: K1's row sums do not depend on the width."""
    from repro_torch.dyn import PatternDelta, check_capacity
    from repro_torch.train.dynamic import capacity_graph
    m = tm.powerlaw_matrix(96, 96, 12.0, 1.2, seed=3)
    target = repro_torch.Target(dtype=dtype)
    plan = repro_torch.compile(m, target, graph=capacity_graph())
    if delta_kind == "keep_lengths":
        m1 = _keep_lengths_mutation(m, seed=2)
        np.testing.assert_array_equal(m1.row_lengths(), m.row_lengths())
    else:
        m1 = _smoke().bucket_moving_mutation(m, seed=2)
    delta = PatternDelta.from_matrices(m, m1)
    assert check_capacity(plan, delta)
    upd = plan.update(delta)
    fresh = repro_torch.compile(m1, target, graph=capacity_graph())
    assert upd.plan_version == plan.plan_version + 1
    if delta_kind == "keep_lengths":
        assert sorted(upd.fmt) == sorted(fresh.fmt)
        for k, t in fresh.fmt.items():
            assert upd.fmt[k].is_cuda and torch.equal(upd.fmt[k], t), k
    else:   # the layouts differ: the rows did move between buckets
        buckets = lambda p: [(st["report"]["width"], st["report"]["tiles"])
                             for st in p.spec["steps"]]
        assert buckets(upd) == buckets(plan) != buckets(fresh)
    x = np.random.default_rng(0).standard_normal(m.n_cols).astype(np.float32)
    assert torch.equal(upd(x), fresh(x))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for mat, p in ((m1, upd), (m, plan)):
        o = mat.spmv_dense_oracle(x)
        assert np.abs(p(x).cpu().numpy() - o).max() <= tol * np.abs(o).max()


@pytest.mark.parametrize("name", ["CSR", "COO", "ELL", "SELL", "HYB",
                                  "Merge", "ACSR", "CSR-Adaptive"])
def test_baselines_on_the_card_match_the_cpu(dev, name):
    """Every baseline format built on the card holds the same tensors as
    on the CPU, and its eager-torch SpMV agrees with the CPU run within
    the reference's baseline tolerance (index_add_ order differs)."""
    from repro_torch.sparse import build_baseline
    for mname in ("powerlaw_mid", "hyb_like"):
        m = tm.make_suite("small")[mname]
        gpu = build_baseline(name, m, device=dev)
        cpu = build_baseline(name, m, device="cpu")
        assert (gpu.stored_bytes, gpu.padded_nnz) == (cpu.stored_bytes,
                                                      cpu.padded_nnz)
        for k, t in cpu.fmt.items():
            assert gpu.fmt[k].is_cuda and torch.equal(gpu.fmt[k].cpu(), t)
        x = np.random.default_rng(1).standard_normal(
            m.n_cols).astype(np.float32)
        y = gpu(x)
        assert y.is_cuda and y.dtype == torch.float32
        want = cpu(x)
        tol = 2e-4 * float(want.abs().max()) + 1e-5
        assert float((y.cpu() - want).abs().max()) <= tol


def test_learned_and_portfolio_compile_on_the_card(dev, tmp_path):
    """Fleet compilation on the cuda backend: a swept store, a trained
    corpus model, then "learned" and "portfolio" compiles of a held-out
    matrix against the oracle, with cost_analysis counting their bytes."""
    from repro_torch.corpus import (default_model_path, holdout_corpus,
                                    run_sweep, synthetic_corpus,
                                    train_from_store)
    budget = repro_torch.SearchConfig(max_seconds=15, max_structures=2,
                                      coarse_samples=1, fine_eval_budget=0,
                                      timing_repeats=1, use_cost_model=False,
                                      seed=0)
    target = repro_torch.Target()
    store = repro_torch.PlanStore(tmp_path)
    recs = run_sweep(synthetic_corpus("smoke")[:4], store, budget=budget,
                     target=target)
    assert len(recs) == 4 and not any(r.error for r in recs)
    train_from_store(tmp_path).save(default_model_path(tmp_path))
    m = holdout_corpus("smoke")[2].build()
    x = np.random.default_rng(0).standard_normal(m.n_cols).astype(np.float32)
    oracle = m.spmv_dense_oracle(x)
    for strategy in ("learned", "portfolio"):
        plan = repro_torch.compile(m, target, budget=budget,
                                   strategy=strategy, store=store)
        assert plan.search_result.strategy_name == strategy
        assert plan.device.type == "cuda"
        y = plan(torch.from_numpy(x).to(dev)).cpu().numpy()
        assert np.abs(y - oracle).max() <= 1e-3 * np.abs(oracle).max() + 1e-5
        cost = plan.cost_analysis()
        assert cost["flops"] >= 2 * m.nnz
        assert cost["bytes accessed"] > (m.n_rows + m.n_cols) * 4


# ------------------------------ token serving ------------------------------

def _llm_cfg(arch):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl="sorted"))
    return cfg


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-moe-16b"])
def test_model_executor_on_the_card_matches_the_cpu(dev, arch):
    """The same weights (the port's init on the CPU) through a
    ``ModelExecutor`` on the card and one on the CPU, fp32: per-slot
    steps with partial live masks, the live rows' logits and every cache
    leaf within 2e-4 * max|cpu| + 1e-5."""
    from repro_torch.models import init_params
    from repro_torch.serve import ModelExecutor
    cfg = _llm_cfg(arch)
    params = init_params(cfg, 0, "cpu")
    cpu = ModelExecutor(cfg, 3, 32, params=params, device="cpu")
    gpu = ModelExecutor(cfg, 3, 32, params=params, device=dev)
    assert gpu.params["embed"].is_cuda and gpu.caches[0]["k"].is_cuda
    rng = np.random.default_rng(0)

    def close(got, want):
        tol = 2e-4 * float(np.abs(want).max()) + 1e-5
        assert float(np.abs(got - want).max()) <= tol

    for t in range(10):
        tok = rng.integers(0, cfg.vocab, (3, 1))
        pos = np.array([t, t + 3, 2 * t])
        live = np.array([True, t % 3 != 1, True])
        want = cpu.decode(tok, pos, live)
        got = gpu.decode(tok, pos, live)
        close(got[live], want[live])
    for c_cpu, c_gpu in zip(cpu.caches, gpu.caches):
        for k in c_cpu:
            close(c_gpu[k].cpu().numpy(), c_cpu[k].numpy())


def test_mid_flight_join_on_the_card(dev):
    """On the card, a request joining mid-flight gives the tokens and the
    slot caches, bit for bit, of the same request served alone."""
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    cfg = _llm_cfg("granite-3-2b")
    sc = ServeConfig(max_batch=2, max_seq=64, max_new_tokens=6)

    def solo(prompt):
        eng = ServingEngine(cfg, sc, device=dev)
        r = Request(0, np.asarray(prompt))
        eng.run([r])
        return tuple(r.out_tokens), eng, r._slot

    runs = [solo([1, 2, 3]), solo([7, 8, 9, 10, 11])]
    eng = ServingEngine(cfg, sc, device=dev)
    ra, rb = Request(0, np.array([1, 2, 3])), Request(1, np.array(
        [7, 8, 9, 10, 11]))
    assert eng.submit(ra)
    eng.step()
    eng.step()
    assert eng.submit(rb)
    while eng.active or eng.queue:
        eng.step()
    for (tokens, solo_eng, solo_slot), req in zip(runs, (ra, rb)):
        assert tuple(req.out_tokens) == tokens
        for c_solo, c_join in zip(solo_eng.executor.caches,
                                  eng.executor.caches):
            for k in c_solo:
                assert c_join[k].is_cuda
                assert torch.equal(c_solo[k][:, solo_slot],
                                   c_join[k][:, req._slot]), k


# ----------------------------- bit stability -------------------------------

def _seg_graph(red, chunk):
    return OperatorGraph.chain(OpSpec.make("COMPRESS"),
                               OpSpec.make("LANE_NNZ_BLOCK", chunk=chunk),
                               OpSpec.make(red))


@functools.lru_cache(maxsize=None)
def _bitstable_matrix():
    # rows of up to thousands of slots: runs across warps, passes and tiles
    return tm.powerlaw_matrix(2 ** 15, 2 ** 15, 16.0, 1.5, seed=0)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("red,chunk", [("SEG_SCAN_RED", 2048),
                                       ("ONEHOT_MXU_RED", 2048),
                                       ("GMEM_ATOM_RED", 512),
                                       ("ONEHOT_MXU_RED", 512)])
def test_dense_seg_plans_repeat_bit_for_bit(dev, red, chunk, fused, b,
                                            tmp_path):
    """K3, K4, K6 (both modes) at B = 1 and K10a, K10b, K11 at B = 8, and
    the unfused steps' ordered combine: 20 calls and the loaded copy give
    the bits of the first call."""
    from repro_torch.api import _plan_from_program
    from repro_torch.core.graph import run_graph
    from repro_torch.core.kernel_builder import build_program
    m = _bitstable_matrix()
    prog = build_program(run_graph(m, _seg_graph(red, chunk)), "cuda",
                         tiles_per_step=4, fuse_combine=fused)
    assert all(st.get("fused", False) == fused for st in prog.spec["steps"])
    plan = _plan_from_program(prog, None, repro_torch.Target())
    plan.save(tmp_path / "p.npz")
    loaded = repro_torch.load_plan(tmp_path / "p.npz")
    rng = np.random.default_rng(b)
    x = torch.from_numpy(rng.standard_normal(
        (m.n_cols,) if b == 1 else (m.n_cols, b)).astype(np.float32)).to(dev)
    y0 = plan(x)
    for _ in range(19):
        assert torch.equal(plan(x), y0)
    assert torch.equal(loaded(x), y0)
    assert torch.equal(prog(x), y0)
    want = (m.spmv_dense_oracle(x.cpu().numpy()) if b == 1
            else m.spmm_dense_oracle(x.cpu().numpy()))
    assert np.abs(y0.cpu().numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["seg_scan", "onehot_mxu"])
def test_fused_seg_kernels_same_bits_at_any_tiles_per_step(dev, mode):
    """K6 and K11: tiles_per_step 1, 3, 8 and 16, with FusedRows built
    twice, give one result bit for bit; without FusedRows the kernels
    refuse to launch."""
    from repro_torch.core.graph import run_graph
    from repro_torch.core.kernel_builder import plan_format
    from repro_torch.kernels.combine import fused_rows
    m = _bitstable_matrix()
    red = "SEG_SCAN_RED" if mode == "seg_scan" else "ONEHOT_MXU_RED"
    fmt, spec = plan_format(run_graph(m, _seg_graph(red, 512)),
                            fuse_combine=True, device=dev)
    key = spec["steps"][0]["key"]
    v, c = fmt[f"{key}_vals"], fmt[f"{key}_cols"]
    local, end, r0 = (fmt.get(f"{key}_local"), fmt.get(f"{key}_end"),
                      fmt[f"{key}_r0"])
    M = spec["steps"][0]["seg_rows"]
    rows = fused_rows(r0, end if mode == "seg_scan" else local, M, m.n_rows,
                      mode, v.shape[1] * v.shape[2])
    assert rows.n_side > 0
    again = fused_rows(r0, end if mode == "seg_scan" else local, M,
                       m.n_rows, mode, v.shape[1] * v.shape[2])
    rng = np.random.default_rng(0)
    for x in (torch.from_numpy(rng.standard_normal(m.n_cols).astype(
            np.float32)).to(dev),
              torch.from_numpy(rng.standard_normal((m.n_cols, 8)).astype(
                  np.float32)).to(dev)):
        op = ops.seg_spmv_fused if x.ndim == 1 else ops.seg_spmm_fused
        outs = [op(v, c, local, end, r0, x, M, n_rows=m.n_rows, mode=mode,
                   tiles_per_step=k, rows=r)
                for k in (1, 3, 8, 16) for r in (rows, again)]
        assert all(torch.equal(o, outs[0]) for o in outs[1:])
        with pytest.raises(ValueError, match="rows="):
            op(v, c, local, end, r0, x, M, n_rows=m.n_rows, mode=mode)
        plain = (ref.seg_spmv_fused_ref if x.ndim == 1
                 else ref.seg_spmm_fused_ref)
        _close(outs[0], plain(v.cpu(), c.cpu(), None if local is None
                              else local.cpu(), None if end is None
                              else end.cpu(), r0.cpu(), x.cpu(), M,
                              n_rows=m.n_rows, mode=mode))


def _parent_placement(rows, part, y0):
    """The unfused kernel's partials ``part`` ((T * M,) or (T * M, B))
    placed in the fused step's fixed order: y0 plus each one-writer pair's
    partial at its row (y[d] + v), then the listed rows' side slots
    through ``rowmap_combine`` in perm order."""
    y = y0.clone()
    d = rows.dst.long()
    direct = d >= 0
    y[d[direct]] = y[d[direct]] + part[direct]
    side = torch.empty((rows.n_side,) + tuple(part.shape[1:]),
                       device=part.device)
    pairs, slot = rows.shared_pairs()
    side[slot] = part[pairs]
    off = torch.zeros(y.shape[0] + 1, dtype=torch.int64, device=y.device)
    off[rows.rows.long() + 1] = rows.count.long()
    return ops.rowmap_combine(y, side, rows.perm, torch.cumsum(off, 0))


def _shared_rows_case(kind, mode, dev):
    """Fused seg operands whose tiles share rows: ``plan`` (a fused plan's
    step on the power-law matrix, C = 512), ``overlap`` (41 tiles, each
    sharing 5 rows with the next) and ``stacked`` (41 tiles on the same
    24 rows, so each row has up to 41 writers), the last rows cut."""
    if kind == "plan":
        from repro_torch.core.graph import run_graph
        from repro_torch.core.kernel_builder import plan_format
        m = _bitstable_matrix()
        red = "SEG_SCAN_RED" if mode == "seg_scan" else "ONEHOT_MXU_RED"
        fmt, spec = plan_format(run_graph(m, _seg_graph(red, 512)),
                                fuse_combine=True, device=dev)
        key = spec["steps"][0]["key"]
        return (fmt[f"{key}_vals"], fmt[f"{key}_cols"],
                fmt.get(f"{key}_local"), fmt.get(f"{key}_end"),
                fmt[f"{key}_r0"], spec["steps"][0]["seg_rows"], m.n_rows,
                m.n_cols)
    rng = np.random.default_rng(41)
    T, S, L, M, n_cols = 41, 4, 128, 24, 3000
    local, end = _seg_case(rng, T, S, L, M)
    vals = torch.from_numpy(rng.standard_normal((T, S, L)).astype(np.float32))
    cols = torch.from_numpy(rng.integers(0, n_cols, (T, S, L)).astype(np.int32))
    r0 = np.arange(T) * (M - 5) if kind == "overlap" else np.zeros(T)
    r0 = torch.from_numpy(r0.astype(np.int32))
    n_rows = int(r0.max()) + M - 3
    g = lambda t: t.to(dev)
    return (g(vals), g(cols), g(local), g(end), g(r0), M, n_rows, n_cols)


def _hold_to_parent(op, unfused, v, c, local, end, r0, x, M, n_rows, mode,
                    k, rows, calls=50):
    """The fused kernel's partials are the unfused kernel's bits (its
    one-writer rows from a zero y), and ``calls`` calls into a random y
    give the parent's placement bit for bit, the counters back at 0."""
    B = x.shape[1:]
    part = unfused(v, c, local, end, x, M, mode=mode).reshape(
        (-1,) + tuple(B))
    d = rows.dst.long()
    zero = op(v, c, local, end, r0, x, M, n_rows=n_rows, mode=mode,
              tiles_per_step=k, rows=rows)
    assert torch.equal(zero[d[d >= 0]], part[d >= 0])
    y0 = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (n_rows,) + tuple(B)).astype(np.float32)).to(x.device)
    want = _parent_placement(rows, part, y0)
    for _ in range(calls):
        got = op(v, c, local, end, r0, x, M, n_rows=n_rows, mode=mode,
                 tiles_per_step=k, out=y0.clone(), rows=rows)
        assert torch.equal(got, want)
    assert not bool(rows.arrive.any()) and not bool(rows.cells.any())


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("b", [1, 3, 8, 17, 40])
@pytest.mark.parametrize("kind", ["plan", "overlap", "stacked"])
@pytest.mark.parametrize("mode", ["seg_scan", "onehot_mxu"])
def test_fused_seg_kernels_equal_the_unfused_partials_in_order(dev, mode,
                                                               kind, b, k):
    """K6 (1-D x; at b = 1) and K11 ((n_cols, b) x) add their shared rows
    inside the one launch: 50 calls equal the unfused kernel's (K3/K4,
    K10a/K10b) partials placed in (tile, segment) order through
    rowmap_combine, bit for bit, at tiles_per_step 1, 3 and 8 (41 tiles:
    not a multiple of 3 or 8), with rows of two writers (exchanged) and
    of up to 41 (counted), and at b = 40, past the exchange cells'
    columns (all counted); the cells and counters end at 0."""
    from repro_torch.kernels.combine import fused_rows
    v, c, local, end, r0, M, n_rows, n_cols = _shared_rows_case(kind, mode,
                                                               dev)
    rows = fused_rows(r0, end if mode == "seg_scan" else local, M, n_rows,
                      mode, v.shape[1] * v.shape[2])
    assert rows.n_side > 0
    if kind == "stacked":
        assert int(rows.count.max()) > 32
    rng = np.random.default_rng(b)
    if b == 1:
        x = torch.from_numpy(rng.standard_normal(n_cols).astype(
            np.float32)).to(dev)
        _hold_to_parent(ops.seg_spmv_fused, ops.seg_spmv, v, c, local, end,
                        r0, x, M, n_rows, mode, k, rows)
    x = torch.from_numpy(rng.standard_normal((n_cols, b)).astype(
        np.float32)).to(dev)
    _hold_to_parent(ops.seg_spmm_fused, ops.seg_spmm, v, c, local, end, r0,
                    x, M, n_rows, mode, k, rows)


@pytest.mark.parametrize("b", [8, 17])
@pytest.mark.parametrize("mode", ["seg_scan", "onehot_mxu"])
def test_fused_seg_spmm_shared_rows_over_column_windows(dev, mode, b):
    """K11 with M = 8192: one tile's M x b accumulator passes the block's
    shared memory, so a window takes 4 of the columns and a pair's side
    slot is written over several windows; tiles overlap by half, so most
    rows are shared. 50 calls equal the parent's placement."""
    from repro_torch.kernels.combine import fused_rows
    rng = np.random.default_rng(b)
    T, S, L, M, n_cols = 5, 64, 128, 8192, 4000
    local, end = _seg_case(rng, T, S, L, M)
    g = lambda t: t.to(dev)
    v = g(torch.from_numpy(rng.standard_normal((T, S, L)).astype(
        np.float32)))
    c = g(torch.from_numpy(rng.integers(0, n_cols, (T, S, L)).astype(
        np.int32)))
    r0 = g(torch.from_numpy((np.arange(T) * (M // 2)).astype(np.int32)))
    n_rows = int(r0.max()) + M
    local, end = g(local), g(end)
    rows = fused_rows(r0, end if mode == "seg_scan" else local, M, n_rows,
                      mode, S * L)
    assert rows.n_side > M
    x = g(torch.from_numpy(rng.standard_normal((n_cols, b)).astype(
        np.float32)))
    _hold_to_parent(ops.seg_spmm_fused, ops.seg_spmm, v, c, local, end, r0,
                    x, M, n_rows, mode, 2, rows)


def test_seg_update_on_the_card_is_bit_stable(dev):
    """A dyn update of a fused seg plan derives its combine order afresh;
    the patched plan repeats bit for bit and equals a plan built afresh
    from its arrays, and a fresh compile of the updated matrix."""
    import dataclasses
    from repro_torch.dyn import PatternDelta
    m = _bitstable_matrix()
    plan = repro_torch.compile(m, repro_torch.Target(),
                               graph=_seg_graph("SEG_SCAN_RED", 2048))
    vals = m.vals.copy()
    vals[::5] *= -1.5
    m1 = dataclasses.replace(m, vals=vals)
    upd = plan.update(PatternDelta.from_matrices(m, m1))
    fresh = dataclasses.replace(upd, combine_state=None)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        m.n_cols).astype(np.float32)).to(dev)
    y = upd(x)
    assert all(torch.equal(upd(x), y) for _ in range(10))
    assert torch.equal(fresh(x), y)
    again = repro_torch.compile(m1, repro_torch.Target(),
                                graph=_seg_graph("SEG_SCAN_RED", 2048))
    assert torch.equal(again(x), y)
    o = m1.spmv_dense_oracle(x.cpu().numpy())
    assert np.abs(y.cpu().numpy() - o).max() <= 1e-5 * np.abs(o).max()


# ------------------------------- training ----------------------------------

def test_train_step_on_the_card_matches_the_cpu(dev):
    """granite-3-2b reduced, fp32, batch 2 x 32, three steps of
    make_train_step from the same weights on the card and on the CPU:
    loss and grad_norm within 1e-4 relative (fp32 sums in another
    order), parameters within 2 * lr a step (AdamW's sign of a gradient
    near 0) and 99.9 % of them within 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import AdamWConfig, tree_leaves
    from repro_torch.train.step import TrainConfig, init_state, \
        make_train_step
    cfg = get_config("granite-3-2b").reduced()
    lr = 3e-4
    tc = TrainConfig(opt=AdamWConfig(lr=lr, total_steps=10, warmup_steps=1),
                     compute_dtype="float32")
    params = init_params(cfg, 0, "cpu")
    cpu = init_state(cfg, tc, params)
    gpu = init_state(cfg, tc, _to(params, dev))
    step = make_train_step(cfg, tc)
    pipe = SyntheticTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                             global_batch=2, seed=0))
    for s in range(3):
        cpu, mc = step(cpu, pipe.batch_at(s))
        gpu, mg = step(gpu, pipe.batch_at(s))
        assert mg["loss"].is_cuda
        for k in ("loss", "grad_norm"):
            assert abs(float(mg[k]) - float(mc[k])) <= 1e-4 * abs(float(mc[k]))
    err = torch.cat([(a.cpu() - b).abs().reshape(-1) for a, b in zip(
        tree_leaves(gpu["params"]), tree_leaves(cpu["params"]))])
    assert float(err.max()) <= 2 * lr * 3
    assert float((err <= 1e-5).float().mean()) >= 0.999


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
