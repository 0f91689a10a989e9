"""Plain versions of K1-K6 (``repro_torch.kernels``, CPU tensors) against
the reference's Pallas kernels in interpret mode, on the shape sweeps of
tests/test_kernels.py and tests/test_fused.py, fp32/int32 and bf16/int16
storage, ``tiles_per_step`` in {1, 3}; K3/K4/K6 also on the seg_end rows
and local rows the packer never writes.

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
                                   (2, 32, 33), (7, 8, 128), (2, 64, 9),
                                   (1, 128, 1), (3, 8, 33)])
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


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("t,s,l,m", [(3, 4, 16, 16), (2, 3, 7, 5)])
def test_onehot_plain_versions_match_pallas_on_any_local_row(t, s, l, m,
                                                             storage):
    """K4 and K6 in one-hot mode on unsorted local rows with entries
    outside [0, M) (-1, M, M + 100): a slot adds into the row it names
    wherever it sits in the tile, and an out-of-range slot adds nothing,
    as a row of zeros in the Pallas kernel's one-hot matrix does. The CUDA
    kernel sums runs of equal rows, and must keep this for rows in any
    order."""
    rng = np.random.default_rng(t * s + l + m)
    n_cols = 200
    vdt, cdt = STORAGE[storage]
    v, c, _, end = _rand_seg(rng, t, s, l, m, n_cols)
    local = rng.integers(0, m, (t, s * l))
    bad = rng.random(local.shape) < 0.2
    local[bad] = rng.choice([-1, m, m + 100], int(bad.sum()))
    local[0, :3] = [-1, m, m + 100]
    local = local.astype(np.int32).reshape(t, s, l)
    (vj, vt), (cj, ct) = _pair(v, vdt), _pair(c, cdt)
    (lj, lt), (ej, et) = _pair(local, np.int32), _pair(end, np.int32)
    xj, xt = _pair(rng.standard_normal(n_cols), np.float32)
    _close(ops.seg_spmv(vt, ct, lt, et, xt, m, mode="onehot_mxu"),
           ref_ops.seg_spmv(vj, cj, lj, ej, xj, m, mode="onehot_mxu"))
    r0 = (np.arange(t) * (m // 2)).astype(np.int32)
    r0j, r0t = _pair(r0, np.int32)
    n_rows = int(r0[-1]) + m // 2 + 1
    for k in (1, 3):
        _close(ops.seg_spmv_fused(vt, ct, lt, et, r0t, xt, m, n_rows=n_rows,
                                  mode="onehot_mxu", tiles_per_step=k),
               ref_ops.seg_spmv_fused(vj, cj, lj, ej, r0j, xj, m,
                                      n_rows=n_rows,
                                      n_out=int(r0.max()) + m,
                                      mode="onehot_mxu", tiles_per_step=k))


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


def _odd_ends(rng, case, t, c, m):
    """(t, m) seg_end rows that the packer never writes: ends that descend
    somewhere, repeat, pass the tile's C slots or fall below 0."""
    if case == "descending":            # unsorted, the first tile reversed
        end = rng.integers(0, c + 1, (t, m))
        end[0] = np.sort(end[0])[::-1]
    elif case == "repeated":            # few distinct ends, in order
        end = np.sort(rng.choice([0, c // 3, c // 3, c - 1, c], (t, m)),
                      axis=1)
        end[0] = c // 2
    elif case == "past_c":              # in order, the last ones past C
        end = np.sort(rng.integers(0, c + 1, (t, m)), axis=1)
        end[:, -3:] = [c + 1, c + 7, 2 * c]
    elif case == "negative":            # in order, the first ones below 0
        end = np.sort(rng.integers(0, c + 1, (t, m)), axis=1)
        end[:, :3] = [-5, -1, 0]
    else:                               # anything in [-3, C + 3]
        end = rng.integers(-3, c + 4, (t, m))
    return end.astype(np.int32)


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("case", ["descending", "repeated", "past_c",
                                  "negative", "mixed"])
def test_seg_scan_plain_versions_match_pallas_on_any_ends(case, storage):
    """K3 and K6 in seg_scan mode on ends the packer never writes. The
    Pallas kernel's g[m] is cs[end[m] - 1] (0 where end[m] <= 0), so a
    descending pair gives a negated range sum and a repeated end an exact
    zero. Past the tile's C slots the reference reads out of range (NaN in
    interpret mode); the port (plain and CUDA) defines g there as the whole
    tile's sum, which is the Pallas kernel on the ends clamped to C. On the
    raw ends, the K3 segments that touch no end past C agree."""
    rng = np.random.default_rng(len(case) + len(storage))
    t, s, l, m, n_cols = 3, 4, 16, 16, 110
    vdt, cdt = STORAGE[storage]
    v, c, local, _ = _rand_seg(rng, t, s, l, m, n_cols)
    end = _odd_ends(rng, case, t, s * l, m)
    (vj, vt), (cj, ct) = _pair(v, vdt), _pair(c, cdt)
    (lj, lt), (_, et) = _pair(local, np.int32), _pair(end, np.int32)
    ej = jnp.asarray(np.minimum(end, s * l))
    xj, xt = _pair(rng.standard_normal(n_cols), np.float32)
    got = ops.seg_spmv(vt, ct, lt, et, xt, m, mode="seg_scan")
    _close(got, ref_ops.seg_spmv(vj, cj, lj, ej, xj, m, mode="seg_scan"))
    raw = np.asarray(ref_ops.seg_spmv(vj, cj, lj, jnp.asarray(end), xj, m,
                                      mode="seg_scan"))
    past = end > s * l
    touch = past | np.concatenate([np.zeros((t, 1), bool), past[:, :-1]], 1)
    _close(got.numpy()[~touch], raw[~touch])
    r0 = (np.arange(t) * (m // 2)).astype(np.int32)
    r0j, r0t = _pair(r0, np.int32)
    n_rows = int(r0[-1]) + m // 2 + 1
    for k in (1, 3):
        _close(ops.seg_spmv_fused(vt, ct, lt, et, r0t, xt, m, n_rows=n_rows,
                                  mode="seg_scan", tiles_per_step=k),
               ref_ops.seg_spmv_fused(vj, cj, lj, ej, r0j, xj, m,
                                      n_rows=n_rows,
                                      n_out=int(r0.max()) + m,
                                      mode="seg_scan", tiles_per_step=k))
