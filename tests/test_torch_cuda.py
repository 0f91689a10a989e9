"""The CUDA kernels K1-K6 against their plain PyTorch versions, and a
cuda-backend compile against the oracle. These need an NVIDIA GPU (they
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
