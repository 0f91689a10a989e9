"""Plain versions of K1-K6 (``repro_torch.kernels``, CPU tensors) against
the reference's Pallas kernels in interpret mode, on the shape sweeps of
tests/test_kernels.py and tests/test_fused.py, fp32/int32 and bf16/int16
storage, ``tiles_per_step`` in {1, 3}.

Tolerance ``1e-5 * max|ref| + 1e-6``: both sides take the same fp32
products and sums, only in another order. All M slots of K3/K4 are
compared, not only the slots a rowmap keeps. The CUDA kernels themselves
are held to these plain versions on the card (tests/test_torch_cuda.py
and chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops

STORAGE = {"fp32": (np.float32, np.int32), "bf16": ("bfloat16", np.int16)}


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    tol = 1e-5 * np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor (bf16 rounded
    once, by jax, so both sides see identical bits)."""
    if dtype == "bfloat16":
        j = jnp.asarray(a, jnp.bfloat16)
        t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
            torch.bfloat16)
        return j, t
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _rand_ell(rng, t, r, w, n_cols):
    vals = rng.standard_normal((t, r, w)).astype(np.float32)
    keep = rng.integers(0, w + 1, (t, r, 1))
    vals = vals * (np.arange(w)[None, None, :] < keep)
    cols = rng.integers(0, n_cols, (t, r, w)).astype(np.int32)
    return vals, cols


def _rand_seg(rng, t, s, l, m, n_cols):
    """Sorted local rows per tile starting at 0 and the matching
    CSR5-style seg_end (as tests/test_kernels.py builds them)."""
    c = s * l
    local = np.sort(rng.integers(0, m, (t, c)), axis=1)
    local = np.minimum(local - local[:, :1], m - 1)
    seg_end = np.full((t, m), c, np.int32)
    for ti in range(t):
        for seg in range(m):
            nxt = np.where(local[ti] > seg)[0]
            seg_end[ti, seg] = nxt[0] if nxt.size else c
    vals = rng.standard_normal((t, s, l)).astype(np.float32)
    cols = rng.integers(0, n_cols, (t, s, l)).astype(np.int32)
    return vals, cols, local.astype(np.int32).reshape(t, s, l), seg_end


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("t,r,w", [(1, 8, 4), (3, 8, 16), (5, 16, 1),
                                   (2, 32, 33), (7, 8, 128)])
def test_ell_plain_versions_match_pallas(t, r, w, storage):
    """K1, K2 and K5 (row0 > 0, n_rows cutting the last tile, K in 1, 3)."""
    rng = np.random.default_rng(t * 100 + r + w)
    n_cols = 300
    vdt, cdt = STORAGE[storage]
    v, c = _rand_ell(rng, t, r, w, n_cols)
    (vj, vt), (cj, ct) = _pair(v, vdt), _pair(c, cdt)
    xj, xt = _pair(rng.standard_normal(n_cols), np.float32)
    _close(ops.ell_spmv(vt, ct, xt), ref_ops.ell_spmv(vj, cj, xj))
    _close(ops.ell_spmv_direct(vt, ct, xt),
           ref_ops.ell_spmv_direct(vj, cj, xj))
    row0, n_rows = 3, 3 + t * r - r // 2
    for k in (1, 3):
        _close(ops.ell_spmv_fused(vt, ct, xt, row0=row0, n_rows=n_rows,
                                  tiles_per_step=k),
               ref_ops.ell_spmv_fused(vj, cj, xj, row0=row0, n_rows=n_rows,
                                      tiles_per_step=k))


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("mode", ["seg_scan", "onehot_mxu"])
@pytest.mark.parametrize("t,s,l,m", [(1, 2, 8, 8), (3, 4, 16, 16),
                                     (2, 8, 8, 24)])
def test_seg_plain_versions_match_pallas(mode, t, s, l, m, storage):
    """K3/K4 (all M slots) and K6 with rows straddling tiles, K in 1, 3."""
    rng = np.random.default_rng(t + s + l + m)
    n_cols = 200
    vdt, cdt = STORAGE[storage]
    v, c, local, end = _rand_seg(rng, t, s, l, m, n_cols)
    (vj, vt), (cj, ct) = _pair(v, vdt), _pair(c, cdt)
    (lj, lt), (ej, et) = _pair(local, np.int32), _pair(end, np.int32)
    xj, xt = _pair(rng.standard_normal(n_cols), np.float32)
    _close(ops.seg_spmv(vt, ct, lt, et, xt, m, mode=mode),
           ref_ops.seg_spmv(vj, cj, lj, ej, xj, m, mode=mode))
    # consecutive tiles overlap by half a tile: each shared row gets one
    # add per tile; n_rows cuts into the last tile
    r0 = (np.arange(t) * (m // 2)).astype(np.int32)
    r0j, r0t = _pair(r0, np.int32)
    n_rows = int(r0[-1]) + m // 2 + 1
    for k in (1, 3):
        _close(ops.seg_spmv_fused(vt, ct, lt, et, r0t, xt, m, n_rows=n_rows,
                                  mode=mode, tiles_per_step=k),
               ref_ops.seg_spmv_fused(vj, cj, lj, ej, r0j, xj, m,
                                      n_rows=n_rows,
                                      n_out=int(r0.max()) + m, mode=mode,
                                      tiles_per_step=k))


def test_bf16_x_upcasts_like_pallas():
    """A bf16 x (Target dtype bfloat16) is upcast before the product."""
    rng = np.random.default_rng(5)
    v, c = _rand_ell(rng, 3, 8, 16, 64)
    (vj, vt), (cj, ct) = _pair(v, np.float32), _pair(c, np.int32)
    xj, xt = _pair(rng.standard_normal(64), "bfloat16")
    _close(ops.ell_spmv(vt, ct, xt), ref_ops.ell_spmv(vj, cj, xj))


def test_seg_unknown_mode_raises():
    t = torch.zeros((1, 2, 4))
    i = torch.zeros((1, 2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown mode"):
        ops.seg_spmv(t, i, i, torch.zeros((1, 8), dtype=torch.int32),
                     torch.zeros(4), 8, mode="bogus")
