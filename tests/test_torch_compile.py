"""End to end on the CPU: ``repro_torch.compile`` against ``repro.compile``
on the same matrix and graph, the cuda dispatch path with CPU tensors
(each wrapper then runs its plain version), a searched compile against the
oracle, the save/load round trip, loading a plan saved by the reference,
and the rule that the default Target never runs on the CPU.

Tolerance ``1e-4 * max|oracle|`` for fp32 storage (the fp32 sums of both
packages against the float64 oracle), 2e-2 for bf16 storage.
"""
import json

import numpy as np
import pytest
import torch

import repro
from repro.core.graph import OperatorGraph as RefGraph
from repro.core.graph import run_graph as ref_run_graph
from repro.core.kernel_builder import build_program as ref_build_program
from repro.core.matrices import (banded_matrix, powerlaw_matrix,
                                 random_uniform_matrix)
from repro.core.search import _graph_to_jsonable
from repro.design.registry import OpSpec as RefOpSpec

import repro_torch
from repro_torch.core import matrices as tm
from repro_torch.core.graph import run_graph
from repro_torch.core.kernel_builder import build_kernel, combine_orders, \
    plan_format
from repro_torch.core.search import _graph_from_jsonable


def _chain(*ops):
    return RefGraph.chain(*(RefOpSpec.make(n, **p) for n, p in ops))


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


def _mats():
    return {"banded": banded_matrix(120, 3, seed=1),
            "powerlaw": powerlaw_matrix(120, 120, 5.0, 1.2, seed=3)}


def _port(m):
    return tm.SparseMatrix(m.n_rows, m.n_cols, m.rows, m.cols, m.vals)


def _port_graph(g):
    return _graph_from_jsonable(json.loads(json.dumps(_graph_to_jsonable(g))))


def _x(m, seed=0):
    return np.random.default_rng(seed).standard_normal(
        m.n_cols).astype(np.float32)


def _assert_close(y, want, tol):
    y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    assert y.dtype == np.float32 and y.shape == want.shape
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(y, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_torch_backend_matches_reference_pallas(family, dtype):
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    g = FAMILIES[family]
    for m in _mats().values():
        ref = repro.compile(m, repro.Target(backend="pallas", dtype=dtype),
                            graph=g)
        plan = repro_torch.compile(_port(m), repro_torch.Target(
            backend="torch", dtype=dtype), graph=_port_graph(g))
        assert plan.spec["storage_dtype"] == ref.spec["storage_dtype"]
        x = _x(m)
        _assert_close(plan(x), np.asarray(ref(x), np.float64), tol)
        _assert_close(plan(x), m.spmv_dense_oracle(x), tol)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cuda_dispatch_on_cpu_tensors_matches_reference(family, fuse):
    """The cuda backend's step interpreter (fused combines, direct
    slabs, gmem_atom through seg_scan) run on CPU tensors, where every
    kernel wrapper takes its plain version, against the reference's
    pallas program with the same fuse setting and tiles_per_step (which
    only the fused kernels read)."""
    tiles = 3 if fuse else 1
    g = FAMILIES[family]
    for m in _mats().values():
        ref = ref_build_program(ref_run_graph(m, g), backend="pallas",
                                interpret=True, fuse_combine=fuse,
                                tiles_per_step=tiles)
        fmt, spec = plan_format(run_graph(_port(m), _port_graph(g)),
                                fuse_combine=fuse, tiles_per_step=tiles,
                                device="cpu")
        assert json.dumps(spec) == json.dumps(ref.spec)
        x = _x(m, seed=tiles)
        y = build_kernel(spec, backend="cuda")(
            fmt, torch.from_numpy(x), combine_orders(spec, fmt, "cuda"))
        _assert_close(y, np.asarray(ref(x), np.float64), 1e-5)
        _assert_close(y, m.spmv_dense_oracle(x), 1e-4)


def test_searched_compile_matches_oracle(tmp_path):
    m = _port(powerlaw_matrix(300, 280, 6.0, 1.0, seed=4))
    cfg = repro_torch.SearchConfig(max_seconds=30, max_structures=2,
                                   coarse_samples=2, timing_repeats=1,
                                   seed=0)
    plan = repro_torch.compile(m, repro_torch.Target(backend="torch"),
                               budget=cfg)
    res = plan.search_result
    assert res.fallback is False and res.n_evaluations > 0
    assert not {"crash", "wrong_result", "oom"} & set(res.failure_counts)
    x = _x(m)
    _assert_close(plan(x), m.spmv_dense_oracle(x), 1e-4)
    assert "SpmvPlan 300x280" in plan.describe()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_load_round_trip_bit_identical(tmp_path, dtype):
    m = _port(random_uniform_matrix(128, 120, 0.05, seed=6))
    plan = repro_torch.compile(
        m, repro_torch.Target(backend="torch", dtype=dtype),
        graph=_port_graph(FAMILIES["seg_scan"]))
    path = tmp_path / "p.plan.npz"
    plan.save(path)
    loaded = repro_torch.load_plan(path)
    assert loaded.spec_json == plan.spec_json
    assert loaded.graph.label() == plan.graph.label()
    assert loaded.target == plan.target
    assert sorted(loaded.fmt) == sorted(plan.fmt)
    for k, a in plan.fmt.items():
        b = loaded.fmt[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16
                           else a, b.view(torch.uint8)
                           if b.dtype == torch.bfloat16 else b), k
    x = _x(m)
    assert torch.equal(loaded(x), plan(x))
    # a corrupted payload fails the reference's checksum rule
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    key = next(k for k in arrays if k.startswith("fmt::"))
    arrays[key] = arrays[key].copy()
    arrays[key].reshape(-1)[0] += 1
    bad = tmp_path / "bad.plan.npz"
    np.savez(bad, **arrays)
    with pytest.raises(repro_torch.PlanIntegrityError):
        repro_torch.load_plan(bad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_saved_plan_loads_in_port(tmp_path, dtype):
    m = powerlaw_matrix(150, 140, 5.0, 1.2, seed=7)
    ref = repro.compile(m, repro.Target(backend="pallas", dtype=dtype),
                        graph=FAMILIES["ell"])
    path = tmp_path / "ref.plan.npz"
    ref.save(path)
    plan = repro_torch.load_plan(path, backend="torch")
    assert plan.target.backend == "torch"
    assert plan.target.dtype == dtype
    assert plan.spec_json == ref.spec_json
    for k, a in ref.fmt.items():
        a = np.asarray(a)
        b = plan.fmt[k]
        if b.dtype == torch.bfloat16:
            assert np.array_equal(a.view(np.uint16),
                                  b.view(torch.int16).numpy().view(np.uint16))
        else:
            assert np.array_equal(a, b.numpy()) and a.dtype == b.numpy().dtype
    x = _x(m)
    _assert_close(plan(x), np.asarray(ref(x), np.float64),
                  2e-2 if dtype == "bfloat16" else 1e-5)
    # without an override the reference's pallas backend maps to cuda
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            repro_torch.load_plan(path)


def test_default_target_is_cuda_and_never_runs_on_cpu():
    assert repro_torch.Target().backend == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default Target runs there")
    m = _port(banded_matrix(64, 2, seed=0))
    with pytest.raises(RuntimeError, match="CUDA device"):
        repro_torch.compile(m, repro_torch.Target(),
                            graph=_port_graph(FAMILIES["ell"]))
    with pytest.raises(RuntimeError, match="CUDA device"):
        repro_torch.compile(m, budget=5)


def test_later_slices_raise():
    """What the port refuses, as the reference does (the multi-RHS path is
    ported: tests/test_torch_spmm.py; dynamic-sparsity updates too:
    tests/test_torch_dyn.py, here only an empty delta; the learned and
    portfolio strategies: tests/test_torch_corpus.py; sharded targets:
    tests/test_torch_dist.py). A sharded plan refuses an in-place update
    (a delta can cross shard bounds), and a mesh must be a
    ``repro_torch.dist.DataMesh``."""
    from repro_torch.dist import make_data_mesh
    from repro_torch.dyn import PatternDelta
    m = _port(banded_matrix(64, 2, seed=0))
    plan = repro_torch.compile(m, repro_torch.Target(backend="torch"),
                               graph=_port_graph(FAMILIES["ell"]))
    delta = PatternDelta.from_matrices(m, m)
    upd = plan.update(delta)
    assert upd.plan_version == plan.plan_version + 1
    assert all(torch.equal(upd.fmt[k], t) for k, t in plan.fmt.items())
    sharded = repro_torch.compile(m, repro_torch.Target(
        backend="torch", mesh=make_data_mesh(2, device="cpu")))
    with pytest.raises(NotImplementedError):
        sharded.update(delta)
    with pytest.raises(TypeError, match="DataMesh"):
        repro_torch.Target(backend="torch", mesh=object())


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("family,dtype", [
    ("ell", "float32"), ("ell", "bfloat16"), ("ell_grid_sorted", "float32"),
    ("seg_scan", "float32"), ("onehot", "float32")])
def test_cost_analysis_counts_format_x_and_y(family, dtype, batch):
    """Bytes: every format tensor once (the torch backend scatters a fused
    seg step through rowmap, so it never reads r0), x of the activation
    dtype and fp32 y; flops: 2 per stored slot and right-hand side."""
    from repro_torch.dyn.capacity import capacity_report
    m = _port(powerlaw_matrix(150, 140, 5.0, 1.2, seed=7))
    plan = repro_torch.compile(
        m, repro_torch.Target(backend="torch", dtype=dtype),
        graph=_port_graph(FAMILIES[family]))
    x_item = 2 if dtype == "bfloat16" else 4
    fmt_bytes = sum(t.numel() * t.element_size()
                    for k, t in plan.fmt.items() if not k.endswith("_r0"))
    slots = sum(t.numel() for k, t in plan.fmt.items()
                if k.endswith("_vals"))
    got = plan.cost_analysis(batch)
    assert got["bytes accessed"] == (fmt_bytes + m.n_cols * batch * x_item
                                     + m.n_rows * batch * 4)
    assert got["flops"] == 2 * slots * batch
    assert slots >= m.nnz
    assert got["capacity"] == capacity_report(plan)


def test_cost_analysis_defaults_to_the_target_batch():
    m = _port(banded_matrix(64, 2, seed=0))
    plan = repro_torch.compile(
        m, repro_torch.Target(backend="torch", batch_size=4),
        graph=_port_graph(FAMILIES["ell"]))
    assert plan.cost_analysis() == plan.cost_analysis(4)
    assert plan.cost_analysis()["flops"] == 4 * plan.cost_analysis(1)["flops"]


def test_target_from_dict_maps_reference_backends():
    from repro_torch.api import _target_from_dict
    for ref_backend, ours in (("pallas", "cuda"), ("jax", "torch")):
        d = repro.Target(backend=ref_backend, batch_size=8).spec_dict()
        t = _target_from_dict(d)
        assert t.backend == ours and t.batch_size == 8 and t.mesh is None
    t = repro_torch.Target(backend="torch", dtype="bfloat16")
    assert _target_from_dict(t.spec_dict()) == t


def test_search_maps_cuda_errors_onto_the_taxonomy():
    """CUDA out-of-memory is a failed candidate ("oom"); any other CUDA
    error leaves compile, since it poisons the process's CUDA context."""
    from repro_torch.core.search import fault_hook
    from repro_torch.kernels.build import CudaKernelError
    m = _port(powerlaw_matrix(200, 180, 5.0, 1.2, seed=1))
    cfg = repro_torch.SearchConfig(max_seconds=10, max_structures=0,
                                   coarse_samples=1, timing_repeats=1)
    target = repro_torch.Target(backend="torch")

    def oom(graph, y):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    with fault_hook(oom), pytest.warns(RuntimeWarning):
        plan = repro_torch.compile(m, target, budget=cfg)
    res = plan.search_result
    assert res.fallback and res.failure_counts["oom"] == res.n_evaluations
    x = _x(m)
    _assert_close(plan(x), m.spmv_dense_oracle(x), 1e-4)

    def fault(graph, y):
        raise CudaKernelError("ell_rows: CUDA error 700 (illegal address)")

    with fault_hook(fault), pytest.raises(CudaKernelError):
        repro_torch.compile(m, target, budget=cfg)
