"""The folded sharded call (``repro_torch.dist.spmv.fold_operands``) on
the CPU: where every shard of a mesh sits on one device, a sharded plan
runs its body once over all shards' tiles, one family kernel and one
combine a step, instead of once per shard.

Each case holds the folded call, with ``torch.equal``, to a per-shard
loop that the test builds itself from the plan's stacks (``build_kernel``
on one stack slice at a time, then the bands or the shard-order sum), on
the ``torch`` backend and on the ``cuda`` body dispatching to the plain
versions on CPU tensors; to the float64 oracle within the reference's
dist tolerances (``1e-4 * max|oracle|`` for fp32 storage, ``2e-2`` for
bf16); and each shard's part of the folded output to the reference's
``build_kernel`` on the same stack slice, within the same tolerances.
"""
import itertools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernel_builder import build_kernel as ref_build_kernel

import repro_torch
from repro_torch.core import matrices as tm
from repro_torch.core.graph import OperatorGraph
from repro_torch.core.kernel_builder import (SPEC_VERSION, build_kernel,
                                             combine_orders)
from repro_torch.design.registry import OpSpec
from repro_torch.dist import make_data_mesh
from repro_torch.dist.mesh import DataMesh
from repro_torch.dist import spmv as dist
from repro_torch.dist.search import (ShardedSearchConfig, dist_search,
                                     shard_fault_hook)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SHARDS = (1, 2, 3, 4, 8)


def _matrix(seed=3):
    # rows 180-239 and columns 150-229 are empty, so 8-way splits by rows
    # and by columns leave the last shards without entries
    m = tm.powerlaw_matrix(240, 230, 6.0, 1.2, seed=seed)
    keep = (m.rows < 180) & (m.cols < 150)
    return tm.SparseMatrix(m.n_rows, m.n_cols, m.rows[keep], m.cols[keep],
                           m.vals[keep])


def _x(n_cols, b, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n_cols,) if b == 1 else (n_cols, b)
    return rng.standard_normal(shape).astype(np.float32)


def _oracle(m, x):
    return m.spmv_dense_oracle(x) if x.ndim == 1 else m.spmm_dense_oracle(x)


def _geometry(prog):
    """(n_out, sizes) of a ShardedSpmvProgram."""
    n_out = prog.band_rows if prog.mode == "row" else prog.n_rows
    return n_out, [s.size for s in prog.shards]


def _padded(x, n_cols, n):
    width = -(-n_cols // n)
    out = np.zeros((width * n,) + x.shape[1:], np.float32)
    out[:n_cols] = x
    return out, width


def per_shard_loop(steps, stacks, mode, n_out, sizes, n_cols, x, backend):
    """The sharded call as one run of ``build_kernel`` a shard over stack
    slice i (its own combine orders), then the bands in order (row mode)
    or the partials added in shard order (col mode)."""
    n = len(sizes)
    spec = {"version": SPEC_VERSION, "n_rows": n_out, "steps": steps}
    run = build_kernel(spec, backend=backend)
    xp, width = _padded(x, n_cols, n)
    outs = []
    for i in range(n):
        fmt = {k: v[i] for k, v in stacks.items()}
        xi = xp[i * width:(i + 1) * width] if mode == "col" else x
        outs.append(run(fmt, torch.from_numpy(np.ascontiguousarray(xi)),
                        combine_orders(spec, fmt, backend)))
    if mode == "row":
        return torch.cat([o[:s] for o, s in zip(outs, sizes)])
    y = outs[0].clone()
    for o in outs[1:]:
        y += o
    return y


def folded_call(prog, x, backend):
    """The program's call through ``make_stacked_fn`` on ``backend``."""
    n_out, sizes = _geometry(prog)
    fn = dist.make_stacked_fn(prog.steps, prog.mode, n_out, prog.mesh,
                              "data", backend=backend)
    return dist.stacked_call(fn, prog.operands, x, prog.mode, prog.n_cols,
                             sizes, "cpu")


def _check(prog, m, storage, backends=("torch", "cuda"), bs=(1, 8)):
    n_out, sizes = _geometry(prog)
    assert prog.operands.folded is not None
    for b in bs:
        x = _x(m.n_cols, b, seed=b)
        oracle = _oracle(m, x)
        for backend in backends:
            got = folded_call(prog, x, backend)
            want = per_shard_loop(prog.steps, prog.stacks, prog.mode, n_out,
                                  sizes, m.n_cols, x, backend)
            assert got.dtype == torch.float32 and got.shape == oracle.shape
            assert torch.equal(got, want), (backend, b)
            err = np.abs(got.numpy() - oracle).max()
            assert err <= TOL[storage] * np.abs(oracle).max(), (backend, b)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["row", "col"])
@pytest.mark.parametrize("n", SHARDS)
def test_folded_call_equals_the_per_shard_loop(n, mode, storage):
    m = _matrix()
    prog = dist.shard_map_spmv(m, make_data_mesh(n, device="cpu"),
                               mode=mode, balance="rows", backend="torch",
                               storage_dtype=storage)
    if n == 8:
        assert any(s.is_empty for s in prog.shards)
    _check(prog, m, storage)
    # the plan's own call is the folded one
    x = _x(m.n_cols, 1)
    assert torch.equal(prog(x), folded_call(prog, x, "torch"))


def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["row", "col"])
@pytest.mark.parametrize("n", SHARDS)
def test_folded_parts_match_reference_build_kernel(n, mode, storage):
    """Shard i's part of the folded output, before the bands are cut or
    the partials summed, against the reference's ``build_kernel`` on
    stack slice i (the reference's per-shard body)."""
    m = _matrix(seed=5)
    prog = dist.shard_map_spmv(m, make_data_mesh(n, device="cpu"),
                               mode=mode, balance="rows", backend="torch",
                               storage_dtype=storage)
    n_out, _ = _geometry(prog)
    folded = prog.operands.folded
    run = build_kernel({"version": SPEC_VERSION, "n_rows": n * n_out,
                        "steps": prog.steps}, backend="torch")
    ref_run = ref_build_kernel({"version": 2, "n_rows": n_out,
                                "steps": prog.steps}, backend="jax")
    for b in (1, 8):
        x = _x(m.n_cols, b, seed=10 + b)
        xp, width = _padded(x, m.n_cols, n)
        xin = xp if mode == "col" else x
        parts = run(folded.fmt, torch.from_numpy(xin), folded.order)
        parts = parts.view((n, n_out) + x.shape[1:]).numpy()
        for i in range(n):
            xi = xp[i * width:(i + 1) * width] if mode == "col" else x
            want = np.asarray(ref_run(
                {k: _to_jax(v[i]) for k, v in prog.stacks.items()}, xi))
            scale = np.abs(want).max() + 1e-30
            np.testing.assert_allclose(parts[i], want, rtol=0,
                                       atol=TOL[storage] * scale)


def _seg(red):
    return OperatorGraph.chain(
        OpSpec.make("COMPRESS"),
        OpSpec.make("LANE_NNZ_BLOCK", chunk=128, lanes=8), OpSpec.make(red))


MIXED = [dist.ELL_GRAPH, _seg("SEG_SCAN_RED"), _seg("ONEHOT_MXU_RED"),
         _seg("GMEM_ATOM_RED")]


@pytest.mark.parametrize("mode", ["row", "col"])
@pytest.mark.parametrize("n", [3, 4])
def test_heterogeneous_families_are_padding_on_most_shards(n, mode):
    """Each shard designed with another family (ELL, seg_scan, one-hot,
    gmem_atom, whose torch body adds its stored rows with one
    ``index_add_``): every family's stack is padding on the other shards."""
    m = tm.powerlaw_matrix(240, 230, 6.0, 1.2, seed=7)
    graphs = itertools.cycle(MIXED)
    prog = dist.shard_map_spmv(m, make_data_mesh(n, device="cpu"),
                               mode=mode, backend="torch",
                               graph_for=lambda sub: next(graphs))
    assert len(prog.steps) == n
    assert any(k.endswith("_rows") for k in prog.stacks) == (n == 4)
    _check(prog, m, "float32")


@pytest.mark.parametrize("mode", ["row", "col"])
def test_crashed_shard_falls_back_and_folds(mode):
    """``dist_search`` with shard 0's search crashing: shard 0 takes the
    baseline design, whose family the other shards lack."""
    m = tm.powerlaw_matrix(400, 380, 8.0, 1.3, seed=9)
    cfg = ShardedSearchConfig(
        mode=mode, min_nnz_for_search=1, backend="torch",
        search=repro_torch.SearchConfig(max_seconds=2, max_structures=2,
                                        coarse_samples=1,
                                        fine_eval_budget=0,
                                        timing_repeats=1,
                                        use_cost_model=False, seed=0))

    def crash(shard):
        if shard.index == 0:
            raise RuntimeError("injected shard crash")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with shard_fault_hook(crash):
            res = dist_search(m, make_data_mesh(4, device="cpu"), cfg)
    assert res.failed_shards() == [0]
    _check(res.program, m, "float32")


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_wide_folded_columns_widen_to_int32(storage):
    """Col mode with n * width > 32767: the stored columns of a bf16 plan
    stay int16 (each shard's slice fits), the folded ones are int32; a
    narrower matrix keeps int16 folded."""
    rng = np.random.default_rng(4)
    n_rows, n_cols, nnz = 64, 40000, 3000
    key = np.unique(rng.integers(0, n_rows * n_cols, nnz))
    m = tm.SparseMatrix(n_rows, n_cols, (key // n_cols).astype(np.int32),
                        (key % n_cols).astype(np.int32),
                        rng.standard_normal(key.size).astype(np.float32))
    prog = dist.shard_map_spmv(m, make_data_mesh(2, device="cpu"),
                               mode="col", backend="torch",
                               storage_dtype=storage)
    for st in prog.steps:
        k = st["cols"]["key"]
        want = torch.int16 if storage == "bfloat16" else torch.int32
        assert prog.stacks[k].dtype == want
        assert prog.operands.folded.fmt[k].dtype == torch.int32
    assert prog.operands.folded_bytes > 0
    _check(prog, m, storage)
    narrow = tm.SparseMatrix(n_rows, 30000, m.rows, m.cols % 30000, m.vals)
    prog = dist.shard_map_spmv(narrow, make_data_mesh(2, device="cpu"),
                               mode="col", backend="torch",
                               storage_dtype="bfloat16")
    for st in prog.steps:
        assert prog.operands.folded.fmt[st["cols"]["key"]].dtype \
            == torch.int16


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["row", "col"])
def test_loaded_plan_folds_the_same(mode, storage, tmp_path):
    """A saved-and-loaded sharded plan rebuilds the same folded operands
    (the same arrays and orders) and answers with the same bits."""
    m = _matrix(seed=11)
    mesh = make_data_mesh(4, device="cpu")
    plan = repro_torch.compile(m, repro_torch.Target(
        backend="torch", mesh=mesh, partition=mode, dtype=storage))
    path = tmp_path / "sharded.plan.npz"
    plan.save(path)
    loaded = repro_torch.load_plan(path, mesh=mesh)
    xs = [_x(m.n_cols, b, seed=b) for b in (1, 8)]
    ys = [plan(x) for x in xs]
    assert all(torch.equal(loaded(x), y) for x, y in zip(xs, ys))
    a, b = plan.operands.folded, loaded.operands.folded
    assert sorted(a.fmt) == sorted(b.fmt) and sorted(a.order) == sorted(
        b.order)
    for k in a.fmt:
        assert a.fmt[k].dtype == b.fmt[k].dtype and torch.equal(
            a.fmt[k].float(), b.fmt[k].float()), k
    for k in a.order:
        assert all(torch.equal(s, t) for s, t in zip(a.order[k],
                                                     b.order[k])), k
    assert plan.operands.folded_bytes == loaded.operands.folded_bytes


@pytest.mark.parametrize("mode", ["row", "col"])
def test_separate_devices_keep_the_per_shard_run(mode):
    """A mesh whose shards name two devices (``cpu`` and ``cpu:0``
    compare unequal) has no folded set and runs the body once per shard;
    it answers with the folded call's bits."""
    m = _matrix()
    two = DataMesh(tuple(torch.device("cpu", i % 2) if i % 2 else
                         torch.device("cpu") for i in range(4)))
    assert two.shared_device is None
    apart = dist.shard_map_spmv(m, two, mode=mode, backend="torch")
    one = dist.shard_map_spmv(m, make_data_mesh(4, device="cpu"), mode=mode,
                              backend="torch")
    assert apart.operands.folded is None and apart.operands.folded_bytes == 0
    for b in (1, 8):
        x = _x(m.n_cols, b)
        assert torch.equal(apart(x), one(x))


def test_placing_needs_the_mode_and_col_width():
    """``place_operands`` takes the mode and the column count from its
    caller (a col-mode fold without them would read the wrong slice of
    x), and a col-mode fold refuses a slice width that is not positive."""
    m = _matrix()
    prog = dist.shard_map_spmv(m, make_data_mesh(4, device="cpu"),
                               mode="col", backend="torch")
    with pytest.raises(TypeError):
        dist.place_operands(prog.stacks, prog.steps, prog.mesh, prog.n_rows)
    with pytest.raises(ValueError, match="width"):
        dist.fold_operands(prog.stacks, prog.steps, prog.n_rows, "col", 0)
    again = dist.place_operands(prog.stacks, prog.steps, prog.mesh,
                                prog.n_rows, "col", prog.n_cols)
    _, sizes = _geometry(prog)
    x = _x(m.n_cols, 8)
    assert torch.equal(dist.stacked_call(prog._fn, again, x, "col",
                                         prog.n_cols, sizes, "cpu"), prog(x))
