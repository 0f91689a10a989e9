"""The multi-RHS (SpMM) path of the port on the CPU, held against the
reference: the plain versions of K7-K11 against the reference's Pallas
kernels in interpret mode (shapes of tests/test_spmm.py and
tests/test_fused.py, B in {1, 3, 8}, fp32/int32 and bf16/int16 storage,
``tiles_per_step`` in {1, 3}), the whole builder on (n_cols, B) inputs
against the reference's programs, a searched ``batch_size=4`` compile
against the float64 oracle, and a reference plan saved with
``batch_size=4`` loading in the port.

Kernel tolerance ``1e-5 * max|want| + 1e-6``: both sides take the same
fp32 products and sums, only in another order. Program tolerance
``1e-4 * max|oracle|`` for fp32 storage, ``2e-2`` for bf16 storage. The
CUDA kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core.graph import OperatorGraph as RefGraph
from repro.core.graph import run_graph as ref_run_graph
from repro.core.kernel_builder import build_program as ref_build_program
from repro.core.matrices import make_suite, powerlaw_matrix
from repro.core.search import _graph_to_jsonable
from repro.design.registry import OpSpec as RefOpSpec
from repro.kernels import ops as ref_ops

import repro_torch
from repro_torch.core import matrices as tm
from repro_torch.core.graph import run_graph
from repro_torch.core.kernel_builder import build_kernel, plan_format
from repro_torch.core.search import _graph_from_jsonable
from repro_torch.kernels import ops

STORAGE = {"fp32": (np.float32, np.int32), "bf16": ("bfloat16", np.int16)}
BATCHES = [1, 3, 8]


def _close(got, want, rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    tol = rel * np.abs(want).max() + 1e-6
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


# ------------------------- kernel-level parity ------------------------------

@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("t,r,w", [(3, 8, 16), (4, 16, 5), (2, 32, 33),
                                   (1, 16, 397), (2, 8, 400)])
def test_ell_spmm_plain_versions_match_pallas(t, r, w, b, storage):
    """K7, K8 and K9 (row0 > 0, n_rows cutting the last tile, K in 1, 3)."""
    rng = np.random.default_rng(t * 100 + r + w + b)
    n_cols = 128
    vdt, cdt = STORAGE[storage]
    v, c = _rand_ell(rng, t, r, w, n_cols)
    (vj, vt), (cj, ct) = _pair(v, vdt), _pair(c, cdt)
    xj, xt = _pair(rng.standard_normal((n_cols, b)), np.float32)
    _close(ops.ell_spmm(vt, ct, xt), ref_ops.ell_spmm(vj, cj, xj))
    _close(ops.ell_spmm_direct(vt, ct, xt),
           ref_ops.ell_spmm_direct(vj, cj, xj))
    row0, n_rows = 3, 3 + t * r - r // 2
    for k in (1, 3):
        _close(ops.ell_spmm_fused(vt, ct, xt, row0=row0, n_rows=n_rows,
                                  tiles_per_step=k),
               ref_ops.ell_spmm_fused(vj, cj, xj, row0=row0, n_rows=n_rows,
                                      tiles_per_step=k))


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("mode", ["seg_scan", "onehot_mxu"])
@pytest.mark.parametrize("t,s,l,m", [(2, 4, 8, 8), (3, 4, 16, 16)])
def test_seg_spmm_plain_versions_match_pallas(mode, t, s, l, m, b, storage):
    """K10a/K10b (all M slots) and K11 with rows straddling tiles, K in
    1, 3."""
    rng = np.random.default_rng(t + s + l + m + b)
    n_cols = 90
    vdt, cdt = STORAGE[storage]
    v, c, local, end = _rand_seg(rng, t, s, l, m, n_cols)
    (vj, vt), (cj, ct) = _pair(v, vdt), _pair(c, cdt)
    (lj, lt), (ej, et) = _pair(local, np.int32), _pair(end, np.int32)
    xj, xt = _pair(rng.standard_normal((n_cols, b)), np.float32)
    _close(ops.seg_spmm(vt, ct, lt, et, xt, m, mode=mode),
           ref_ops.seg_spmm(vj, cj, lj, ej, xj, m, mode=mode))
    r0 = (np.arange(t) * (m // 2)).astype(np.int32)
    r0j, r0t = _pair(r0, np.int32)
    n_rows = int(r0[-1]) + m // 2 + 1
    for k in (1, 3):
        _close(ops.seg_spmm_fused(vt, ct, lt, et, r0t, xt, m, n_rows=n_rows,
                                  mode=mode, tiles_per_step=k),
               ref_ops.seg_spmm_fused(vj, cj, lj, ej, r0j, xj, m,
                                      n_rows=n_rows,
                                      n_out=int(r0.max()) + m, mode=mode,
                                      tiles_per_step=k))


def _pairs(v, c, local, end, x, m, mode, storage, pallas_end=None):
    """(port, Pallas) pairs of K10 and K11 on the same tiles: K11 with
    tiles overlapping by half a tile, n_rows cutting into the last, and
    tiles_per_step 1 and 3. The Pallas side takes ``pallas_end`` for
    seg_end where one is given."""
    vdt, cdt = STORAGE[storage]
    (vj, vt), (cj, ct) = _pair(v, vdt), _pair(c, cdt)
    (lj, lt), (_, et) = _pair(local, np.int32), _pair(end, np.int32)
    ej = jnp.asarray(end if pallas_end is None else pallas_end, jnp.int32)
    xj, xt = _pair(x, np.float32)
    out = [(ops.seg_spmm(vt, ct, lt, et, xt, m, mode=mode),
            ref_ops.seg_spmm(vj, cj, lj, ej, xj, m, mode=mode))]
    t = v.shape[0]
    r0 = (np.arange(t) * (m // 2)).astype(np.int32)
    r0j, r0t = _pair(r0, np.int32)
    n_rows = int(r0[-1]) + m // 2 + 1
    for k in (1, 3):
        out.append((ops.seg_spmm_fused(vt, ct, lt, et, r0t, xt, m,
                                       n_rows=n_rows, mode=mode,
                                       tiles_per_step=k),
                    ref_ops.seg_spmm_fused(vj, cj, lj, ej, r0j, xj, m,
                                           n_rows=n_rows,
                                           n_out=int(r0.max()) + m,
                                           mode=mode, tiles_per_step=k)))
    return out


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("t,s,l,m", [(3, 4, 16, 16), (2, 3, 7, 5)])
def test_onehot_spmm_plain_versions_match_pallas_on_any_local_row(
        t, s, l, m, b, storage):
    """K10b and K11 in one-hot mode on unsorted local rows with entries
    outside [0, M) (-1, M, M + 100): a slot adds into the row it names
    wherever it sits in the tile, and an out-of-range slot adds nothing,
    as a row of zeros in the Pallas kernel's one-hot matrix does. The CUDA
    kernels sum runs of equal rows, and must keep this for rows in any
    order."""
    rng = np.random.default_rng(t * s + l + m + b)
    n_cols = 120
    v, c, _, end = _rand_seg(rng, t, s, l, m, n_cols)
    local = rng.integers(0, m, (t, s * l))
    bad = rng.random(local.shape) < 0.2
    local[bad] = rng.choice([-1, m, m + 100], int(bad.sum()))
    local[0, :3] = [-1, m, m + 100]
    local = local.astype(np.int32).reshape(t, s, l)
    x = rng.standard_normal((n_cols, b))
    for got, want in _pairs(v, c, local, end, x, m, "onehot_mxu", storage):
        _close(got, want)


def _ends(rng, case, t, c, m):
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


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("case", ["descending", "repeated", "past_c",
                                  "negative", "mixed"])
def test_seg_scan_spmm_plain_versions_match_pallas_on_any_ends(case, b):
    """K10a and K11 in seg_scan mode on ends the packer never writes. The
    Pallas kernel's g[m] is cs[end[m] - 1] (0 where end[m] <= 0), so a
    descending pair gives a negated range sum and a repeated end an exact
    zero. Past the tile's C slots the reference reads out of range (NaN in
    interpret mode); the port (plain and CUDA) defines g there as the whole
    tile's sum, which is the Pallas kernel on the ends clamped to C. On the
    raw ends, the segments that touch no end past C agree."""
    rng = np.random.default_rng(b + len(case))
    t, s, l, m, n_cols = 3, 4, 16, 16, 110
    v, c, local, _ = _rand_seg(rng, t, s, l, m, n_cols)
    end = _ends(rng, case, t, s * l, m)
    x = rng.standard_normal((n_cols, b))
    clamped = np.minimum(end, s * l)
    for got, want in _pairs(v, c, local, end, x, m, "seg_scan", "fp32",
                            pallas_end=clamped):
        _close(got, want)
    vj, cj, ej, xj = (jnp.asarray(a) for a in (v, c, end, x.astype(np.float32)))
    raw = np.asarray(ref_ops.seg_spmm(vj, cj, jnp.asarray(local), ej, xj, m,
                                      mode="seg_scan"))
    past = end > s * l
    touch = past | np.concatenate([np.zeros((t, 1), bool), past[:, :-1]], 1)
    got = ops.seg_spmm(*(torch.from_numpy(a) for a in (
        v, c, local, end, x.astype(np.float32))), m, mode="seg_scan")
    _close(got.numpy()[~touch], raw[~touch])


def test_seg_spmm_padding_tile_and_bf16_x():
    """A padding tile (every end 0, every val 0) gives zero partials in
    both modes, and a bf16 x is upcast before the product."""
    rng = np.random.default_rng(3)
    v, c, local, end = _rand_seg(rng, 3, 4, 16, 16, 64)
    v[-1] = 0.0
    end[-1] = 0
    (vj, vt), (cj, ct) = _pair(v, np.float32), _pair(c, np.int32)
    (lj, lt), (ej, et) = _pair(local, np.int32), _pair(end, np.int32)
    xj, xt = _pair(rng.standard_normal((64, 5)), "bfloat16")
    for mode in ("seg_scan", "onehot_mxu"):
        got = ops.seg_spmm(vt, ct, lt, et, xt, 16, mode=mode)
        assert torch.count_nonzero(got[-1]) == 0
        _close(got, ref_ops.seg_spmm(vj, cj, lj, ej, xj, 16, mode=mode))


def test_spmm_columns_match_spmv():
    """Column b of every SpMM plain version is the 1-RHS plain version of
    x[:, b] (ELL and both seg modes)."""
    rng = np.random.default_rng(9)
    v, c = _rand_ell(rng, 3, 8, 16, 100)
    vt, ct = torch.from_numpy(v), torch.from_numpy(c)
    x = torch.from_numpy(rng.standard_normal((100, 3)).astype(np.float32))
    got = ops.ell_spmm(vt, ct, x)
    for i in range(3):
        _close(got[..., i], ops.ell_spmv(vt, ct, x[:, i].contiguous()))
    v, c, local, end = map(torch.from_numpy, _rand_seg(rng, 2, 4, 8, 8, 100))
    for mode in ("seg_scan", "onehot_mxu"):
        got = ops.seg_spmm(v, c, local, end, x, 8, mode=mode)
        for i in range(3):
            _close(got[..., i], ops.seg_spmv(v, c, local, end,
                                             x[:, i].contiguous(), 8,
                                             mode=mode))


# ------------------------- whole builder (2-D x) ----------------------------

def _chain(*ops_):
    return RefGraph.chain(*(RefOpSpec.make(n, **p) for n, p in ops_))


FAMILIES = {
    "ell": _chain(("COMPRESS", {}), ("TILE_ROW_BLOCK", {"rows": 16}),
                  ("LANE_ROW_BLOCK", {}), ("LANE_TOTAL_RED", {})),
    "ell_grid_sorted": _chain(("COMPRESS", {}), ("SORT", {}),
                              ("TILE_ROW_BLOCK", {"rows": 16}),
                              ("LANE_ROW_BLOCK", {}),
                              ("LANE_TOTAL_RED", {"combine": "grid_acc"})),
    "seg_scan": _chain(("COMPRESS", {}),
                       ("LANE_NNZ_BLOCK", {"chunk": 64, "lanes": 8}),
                       ("SEG_SCAN_RED", {})),
    "onehot": _chain(("COMPRESS", {}),
                     ("LANE_NNZ_BLOCK", {"chunk": 64, "lanes": 8}),
                     ("ONEHOT_MXU_RED", {})),
    "gmem_atom": _chain(("COMPRESS", {}),
                        ("LANE_NNZ_BLOCK", {"chunk": 64, "lanes": 8}),
                        ("GMEM_ATOM_RED", {})),
}
SUITE = sorted(make_suite("small"))


def _port(m):
    return tm.SparseMatrix(m.n_rows, m.n_cols, m.rows, m.cols, m.vals)


def _port_graph(g):
    return _graph_from_jsonable(json.loads(json.dumps(_graph_to_jsonable(g))))


def _xs(m, b, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (m.n_cols, b)).astype(np.float32)


def _assert_close(y, want, tol):
    y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    assert y.dtype == np.float32 and y.shape == want.shape
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(y, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("name", SUITE)
def test_torch_program_matches_reference_jax_on_2d_x(name):
    """For each make_suite matrix and every graph family: the port's
    ``torch`` program against the reference's ``jax`` program on an
    (n_cols, 3) x, and both against the float64 oracle."""
    m = make_suite("small")[name]
    x = _xs(m, 3)
    oracle = m.spmm_dense_oracle(x)
    for family, g in FAMILIES.items():
        try:
            meta_ref = ref_run_graph(m, g)
        except ValueError:
            # the Designer rejects this graph for this matrix; the port
            # must reject it too
            with pytest.raises(ValueError):
                run_graph(_port(m), _port_graph(g))
            continue
        ref = ref_build_program(meta_ref, backend="jax")
        fmt, spec = plan_format(run_graph(_port(m), _port_graph(g)),
                                fuse_combine=False, device="cpu")
        assert json.dumps(spec) == json.dumps(ref.spec), family
        y = build_kernel(spec, backend="torch")(fmt, torch.from_numpy(x))
        _assert_close(y, np.asarray(ref(x), np.float64), 1e-5)
        _assert_close(y, oracle, 1e-4)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cuda_dispatch_spmm_on_cpu_tensors_matches_reference(family, fuse):
    """The cuda backend's step interpreter on an (n_cols, B) x, with CPU
    tensors (each SpMM wrapper takes its plain version), against the
    reference's pallas program with the same fuse setting and
    tiles_per_step."""
    tiles = 3 if fuse else 1
    g = FAMILIES[family]
    for m in (powerlaw_matrix(120, 120, 5.0, 1.2, seed=3),):
        ref = ref_build_program(ref_run_graph(m, g), backend="pallas",
                                interpret=True, fuse_combine=fuse,
                                tiles_per_step=tiles)
        fmt, spec = plan_format(run_graph(_port(m), _port_graph(g)),
                                fuse_combine=fuse, tiles_per_step=tiles,
                                device="cpu")
        assert json.dumps(spec) == json.dumps(ref.spec)
        for b in (1, 4):
            x = _xs(m, b, seed=tiles + b)
            y = build_kernel(spec, backend="cuda")(fmt, torch.from_numpy(x))
            _assert_close(y, np.asarray(ref(x), np.float64), 1e-5)
            _assert_close(y, m.spmm_dense_oracle(x), 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_searched_batch_compile_matches_spmm_oracle(dtype):
    """``batch_size=4`` checks and times candidates on (n_cols, 4) inputs
    against ``spmm_dense_oracle``; GFLOP/s counts 2*nnz*B."""
    m = _port(powerlaw_matrix(300, 280, 6.0, 1.0, seed=4))
    cfg = repro_torch.SearchConfig(max_seconds=6, max_structures=1,
                                   coarse_samples=1, timing_repeats=1,
                                   use_cost_model=False, seed=0)
    plan = repro_torch.compile(m, repro_torch.Target(
        backend="torch", batch_size=4, dtype=dtype), budget=cfg)
    res = plan.search_result
    assert res.fallback is False and res.n_evaluations > 0
    assert not {"crash", "wrong_result", "oom"} & set(res.failure_counts)
    assert res.gflops == pytest.approx(
        2.0 * m.nnz * 4 / res.best_seconds / 1e9)
    x = _xs(m, 4)
    # a bfloat16 Target feeds x as bf16, whatever storage the search chose
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    y = plan(x)
    assert y.shape == (m.n_rows, 4)
    _assert_close(y, m.spmm_dense_oracle(x), tol)
    # the 1-D call still works on a plan searched for B = 4
    _assert_close(plan(x[:, 0]), m.spmv_dense_oracle(x[:, 0]), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_batch_plan_loads_in_port(tmp_path, dtype):
    m = powerlaw_matrix(150, 140, 5.0, 1.2, seed=7)
    ref = repro.compile(m, repro.Target(backend="pallas", batch_size=4,
                                        dtype=dtype),
                        graph=FAMILIES["seg_scan"])
    path = tmp_path / "ref.plan.npz"
    ref.save(path)
    plan = repro_torch.load_plan(path, backend="torch")
    assert plan.target.batch_size == 4 and plan.target.dtype == dtype
    assert plan.spec_json == ref.spec_json
    assert sorted(plan.fmt) == sorted(ref.fmt)
    for k, a in ref.fmt.items():
        a = np.asarray(a)
        b = plan.fmt[k]
        if b.dtype == torch.bfloat16:
            assert np.array_equal(a.view(np.uint16),
                                  b.view(torch.int16).numpy().view(np.uint16))
        else:
            assert np.array_equal(a, b.numpy()) and a.dtype == b.numpy().dtype
    x = _xs(m, 4)
    _assert_close(plan(x), np.asarray(ref(x), np.float64),
                  2e-2 if dtype == "bfloat16" else 1e-5)
