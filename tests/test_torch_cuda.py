"""The CUDA kernels K1-K11 against their plain PyTorch versions, a
cuda-backend compile against the oracle (1-D and (n_cols, B) x), and the
serving engine on the card. These need an NVIDIA GPU (they
build the kernels with nvcc): here they skip; on the card run

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_cuda.py

This file imports no jax (and needs none of tests/conftest.py), so it
also runs where jax is not installed.
Tolerance ``1e-4 * max|plain| + 1e-6``: the kernels sum in another order,
and K4/K6 add with atomics whose order changes from run to run.
"""
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


def _close(got, want):
    got, want = got.cpu(), want.cpu()
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-4 * float(want.abs().max()) + 1e-6
    assert float((got - want).abs().max()) <= tol


def _seg_case(rng, t, s, l, m):
    c = s * l
    local = np.sort(rng.integers(0, m, (t, c)), axis=1)
    local = np.minimum(local - local[:, :1], m - 1)
    seg_end = np.full((t, m), c, np.int32)
    for ti in range(t):
        for seg in range(m):
            nxt = np.where(local[ti] > seg)[0]
            seg_end[ti, seg] = nxt[0] if nxt.size else c
    return (torch.from_numpy(local.astype(np.int32).reshape(t, s, l)),
            torch.from_numpy(seg_end))


@pytest.mark.parametrize("vd", VALS)
@pytest.mark.parametrize("cd", COLS)
def test_ell_kernels_match_plain(dev, vd, cd):
    rng = np.random.default_rng(0)
    n_cols = 3000
    T, R, W = 11, 16, 45
    vals = torch.from_numpy(rng.standard_normal((T, R, W))).to(vd)
    cols = torch.from_numpy(rng.integers(0, n_cols, (T, R, W))).to(cd)
    x = torch.from_numpy(rng.standard_normal(n_cols).astype(np.float32))
    g = [t.to(dev) for t in (vals, cols, x)]
    _close(ops.ell_spmv(*g), ref.ell_spmv_ref(vals, cols, x))
    _close(ops.ell_spmv_direct(*g), ref.ell_spmv_direct_ref(vals, cols, x))
    for k in (1, 3, 8):
        _close(ops.ell_spmv_fused(*g, n_rows=170, row0=7, tiles_per_step=k),
               ref.ell_spmv_fused_ref(vals, cols, x, n_rows=170, row0=7))
    torch.cuda.synchronize()


@pytest.mark.parametrize("mode", ["seg_scan", "onehot_mxu"])
@pytest.mark.parametrize("vd", VALS)
def test_seg_kernels_match_plain(dev, mode, vd):
    rng = np.random.default_rng(1)
    n_cols = 2000
    T, S, L, M = 9, 8, 128, 96           # C = 1024: four scan passes
    local, end = _seg_case(rng, T, S, L, M)
    vals = torch.from_numpy(rng.standard_normal((T, S, L))).to(vd)
    cols = torch.from_numpy(rng.integers(0, n_cols, (T, S, L))).to(torch.int16)
    x = torch.from_numpy(rng.standard_normal(n_cols).astype(np.float32))
    r0 = torch.from_numpy((np.arange(T) * 50).astype(np.int32))
    g = lambda t: t.to(dev)
    _close(ops.seg_spmv(g(vals), g(cols), g(local), g(end), g(x), M,
                        mode=mode),
           ref.seg_spmv_ref(vals, cols, local, end, x, M, mode))
    for k in (1, 3, 8):
        _close(ops.seg_spmv_fused(g(vals), g(cols), g(local), g(end), g(r0),
                                  g(x), M, n_rows=420, mode=mode,
                                  tiles_per_step=k),
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


@pytest.mark.parametrize("b", [1, 3, 8, 17, 40])
@pytest.mark.parametrize("vd,cd,xd", STORAGE)
def test_ell_spmm_kernels_match_plain(dev, b, vd, cd, xd):
    """K7, K8 and K9 (T = 7 not a multiple of tiles_per_step 3 or 8; n_rows
    cuts into the last tile; B above the 32-column chunk)."""
    rng = np.random.default_rng(b)
    n_cols = 3000
    T, R, W = 7, 24, 37
    vals = torch.from_numpy(rng.standard_normal((T, R, W))).to(vd)
    cols = torch.from_numpy(rng.integers(0, n_cols, (T, R, W))).to(cd)
    x = torch.from_numpy(rng.standard_normal((n_cols, b))).to(xd)
    g = [t.to(dev) for t in (vals, cols, x)]
    _close(ops.ell_spmm(*g), ref.ell_spmm_ref(vals, cols, x))
    _close(ops.ell_spmm_direct(*g), ref.ell_spmm_direct_ref(vals, cols, x))
    for k in (1, 3, 8):
        _close(ops.ell_spmm_fused(*g, n_rows=150, row0=11, tiles_per_step=k),
               ref.ell_spmm_fused_ref(vals, cols, x, n_rows=150, row0=11))
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
                                  tiles_per_step=k),
               ref.seg_spmm_fused_ref(vals, cols, local, end, r0, x, M,
                                      n_rows=1000, mode=mode))
    torch.cuda.synchronize()


@pytest.mark.parametrize("b", [8, 17])
@pytest.mark.parametrize("mode", ["seg_scan", "onehot_mxu"])
def test_seg_spmm_full_chunk(dev, b, mode):
    """C = 8192 slots per tile (LANE_NNZ_BLOCK's largest chunk): a stored
    (C, B) scan would not fit a block's shared memory."""
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
                              tiles_per_step=3),
           ref.seg_spmm_fused_ref(vals, cols, local, end, r0, x, M,
                                  n_rows=1900, mode=mode))
    torch.cuda.synchronize()


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
