"""Sharded SpMV on PyTorch (``repro_torch.dist``) on the CPU: the
reference's dist tests case for case on the ``torch`` backend over an
in-process ``make_data_mesh(n, device="cpu")`` mesh, and parity with the
reference.

The reference fakes n devices with ``XLA_FLAGS`` in a subprocess; the
port's mesh names its devices explicitly, so the 8- and 4-shard cases run
here in-process. Parity needs no multi-device jax: ``partition_matrix``
and ``pack_operand_format`` are held bit-identical to the reference's, the
per-shard body is held against the reference's ``build_kernel`` on the
same stack slices, and sharded plan files load both ways on one shard.

Tolerances are the reference tests' own: ``1e-4 * max|oracle|`` for fp32
storage, ``2e-2`` for bf16.
"""
import dataclasses
import hashlib
import json
import warnings

import numpy as np
import pytest
import torch

import repro
from repro.core.graph import run_graph as ref_run_graph
from repro.core.kernel_builder import build_kernel as ref_build_kernel
from repro.core.kernel_builder import build_program as ref_build_program
from repro.core.matrices import (banded_matrix, powerlaw_matrix,
                                 random_uniform_matrix)
from repro.dist import spmv as ref_dist

import repro_torch
from repro_torch.core import matrices as tm
from repro_torch.core.graph import run_graph
from repro_torch.core.kernel_builder import build_kernel, build_program, \
    combine_orders
from repro_torch.core.search import SearchConfig
from repro_torch.dist import make_data_mesh
from repro_torch.dist import search as dsearch
from repro_torch.dist import spmv as dist
from repro_torch.dist.search import (ShardedSearchConfig, dist_search,
                                     shard_fault_hook)

BACKEND = "torch"


def _port(m):
    return tm.SparseMatrix(m.n_rows, m.n_cols, m.rows, m.cols, m.vals)


def _mesh(n=1):
    return make_data_mesh(n, device="cpu")


def _x(m, b=1, seed=0):
    rng = np.random.default_rng(seed)
    shape = (m.n_cols,) if b == 1 else (m.n_cols, b)
    return rng.standard_normal(shape).astype(np.float32)


def _oracle(m, x):
    return m.spmv_dense_oracle(x) if x.ndim == 1 else m.spmm_dense_oracle(x)


def _rel_err(y, oracle):
    y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    assert y.shape == oracle.shape and y.dtype == np.float32
    return float(np.abs(y - oracle).max() / (np.abs(oracle).max() + 1e-30))


def _bits(t):
    """A tensor's bits as numpy (bf16 through uint16)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _ref_bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def small_irregular():
    return _port(powerlaw_matrix(400, 350, 6.0, 1.0, seed=11))


@pytest.fixture(scope="module")
def small_uniform():
    return _port(random_uniform_matrix(256, 256, 0.02, seed=13))


def _tiny_search_cfg(**kw):
    return ShardedSearchConfig(
        search=SearchConfig(max_seconds=20, max_structures=2,
                            coarse_samples=2, fine_eval_budget=0,
                            timing_repeats=1, use_cost_model=False, seed=7),
        min_nnz_for_search=1, backend=BACKEND, **kw)


# ------------------------- partitioning (no mesh) ---------------------------

def _rebuild(shards, m, mode):
    """Reassemble the global triplets from shard-local index space."""
    rows, cols, vals = [], [], []
    for s in shards:
        if mode == "row":
            rows.append(s.matrix.rows + s.start)
            cols.append(s.matrix.cols)
        else:
            rows.append(s.matrix.rows)
            cols.append(s.matrix.cols + s.start)
        vals.append(s.matrix.vals)
    return tm.SparseMatrix(m.n_rows, m.n_cols,
                           np.concatenate(rows).astype(np.int32),
                           np.concatenate(cols).astype(np.int32),
                           np.concatenate(vals).astype(np.float32)).canonical()


@pytest.mark.parametrize("mode", ["row", "col"])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_partition_is_exact_cover(mode, n_shards):
    m = _port(powerlaw_matrix(200, 180, 5.0, 1.0, seed=3))
    shards = dist.partition_matrix(m, n_shards, mode=mode)
    assert len(shards) == n_shards
    assert sum(s.matrix.nnz for s in shards) == m.nnz
    got = _rebuild(shards, m, mode)
    assert np.array_equal(got.rows, m.rows)
    assert np.array_equal(got.cols, m.cols)
    np.testing.assert_allclose(got.vals, m.vals)


def test_partition_nnz_balance_on_powerlaw():
    """nnz balancing must beat row balancing on a skewed matrix."""
    m = _port(powerlaw_matrix(600, 400, 8.0, 0.7, seed=4))
    assert m.is_irregular()
    by_nnz = dist.partition_matrix(m, 8, balance="nnz")
    by_rows = dist.partition_matrix(m, 8, balance="rows")
    imb = lambda sh: max(s.matrix.nnz for s in sh) / (m.nnz / len(sh))
    assert imb(by_nnz) <= imb(by_rows) + 1e-9
    assert imb(by_nnz) < 2.0    # no shard holds >2x its fair share


def test_col_partition_degenerate_trailing_shards():
    m = _port(powerlaw_matrix(60, 10, 3.0, 1.0, seed=6))
    shards = dist.partition_matrix(m, 8, mode="col")
    assert shards[-1].stop == m.n_cols
    assert sum(s.matrix.n_cols for s in shards) == m.n_cols
    assert all(s.stop >= s.start for s in shards)
    assert sum(s.matrix.nnz for s in shards) == m.nnz


def test_partition_handles_empty_shards():
    m = tm.SparseMatrix(64, 8, np.array([0, 0, 1], np.int32),
                        np.array([0, 2, 1], np.int32), np.ones(3, np.float32))
    shards = dist.partition_matrix(m, 8, balance="rows")
    assert sum(s.is_empty for s in shards) >= 6
    assert sum(s.matrix.nnz for s in shards) == 3
    assert shards[0].start == 0 and shards[-1].stop == 64
    for a, b in zip(shards, shards[1:]):
        assert a.stop == b.start


# ------------------------------ execution -----------------------------------

@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("mode", ["row", "col"])
def test_shard_map_spmv_matches_oracle(mode, n_shards, small_irregular):
    m = small_irregular
    prog = dist.shard_map_spmv(m, _mesh(n_shards), mode=mode,
                               backend=BACKEND)
    x = _x(m)
    assert _rel_err(prog(x), _oracle(m, x)) < 1e-4
    assert prog.nnz == m.nnz


@pytest.mark.parametrize("n_shards", [1, 4])
def test_shard_map_spmv_empty_matrix(n_shards):
    m = tm.SparseMatrix(16, 8, np.zeros(0, np.int32), np.zeros(0, np.int32),
                        np.zeros(0, np.float32))
    for mode in ("row", "col"):
        prog = dist.shard_map_spmv(m, _mesh(n_shards), mode=mode,
                                   backend=BACKEND)
        assert prog.steps == [] and prog.stacks == {}
        y = prog(np.ones(8, np.float32))
        assert y.shape == (16,) and bool((y == 0).all())


def test_sharded_program_batched_matches_dense():
    from repro_torch.serve import sparsify_linear_sharded
    rng = np.random.default_rng(5)
    w = rng.standard_normal((96, 80)).astype(np.float32)
    sl = sparsify_linear_sharded(w, _mesh(), density=0.15,
                                 dist_config=ShardedSearchConfig(
                                     backend=BACKEND))
    assert isinstance(sl.program, repro_torch.ShardedSpmvPlan)
    X = rng.standard_normal((3, 80)).astype(np.float32)
    want = X @ sl.matrix.to_dense().T.astype(np.float32)
    np.testing.assert_allclose(sl(X).numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sl(X[0]).numpy(), want[0], rtol=1e-4,
                               atol=1e-4)


def test_sharded_program_batched_convention():
    """ShardedSpmvProgram takes (n_cols, B) tiles like SpmvProgram."""
    m = _port(powerlaw_matrix(120, 90, 4.0, 1.0, seed=8))
    for mode in ("row", "col"):
        prog = dist.shard_map_spmv(m, _mesh(), mode=mode, backend=BACKEND)
        assert prog.supports_batch
        X = _x(m, 5, seed=1)
        Y = prog(X)
        assert tuple(Y.shape) == (m.n_rows, 5)
        assert _rel_err(Y, _oracle(m, X)) < 1e-4


# the reference's SCRIPT_8DEV, in-process on 8 CPU shards
EIGHT_SHARD_CASES = {
    "regular": lambda: banded_matrix(320, 3, seed=1),
    "powerlaw": lambda: powerlaw_matrix(400, 350, 6.0, 1.0, seed=2),
    # nearly-empty: most of the 8 row shards hold zero nnz
    "sparse_rows": lambda: repro.SparseMatrix(
        64, 32, np.array([0, 0, 1], np.int32),
        np.array([0, 5, 9], np.int32), np.ones(3, np.float32)),
    # n_cols < n_shards * width: degenerate trailing col shards
    "narrow": lambda: powerlaw_matrix(60, 10, 3.0, 1.0, seed=6),
}


@pytest.mark.parametrize("name", sorted(EIGHT_SHARD_CASES))
def test_shard_map_spmv_8_shards(name):
    m = _port(EIGHT_SHARD_CASES[name]())
    mesh = _mesh(8)
    x = _x(m)
    for mode in ("row", "col"):
        prog = dist.shard_map_spmv(m, mesh, mode=mode,
                                   balance="rows" if name == "sparse_rows"
                                   else "nnz", backend=BACKEND)
        assert _rel_err(prog(x), _oracle(m, x)) < 1e-4, mode
        if name in ("regular", "powerlaw"):
            # operand passing: per-device bytes undercut every shard's
            # format on every device
            assert (prog.replicated_format_bytes
                    / max(prog.per_device_format_bytes, 1)) > 1.2, mode


def test_dist_stacks_carry_narrowed_dtypes():
    m = _port(random_uniform_matrix(96, 96, 0.06, seed=10))
    f32 = dist.shard_map_spmv(m, _mesh(), backend=BACKEND)
    b16 = dist.shard_map_spmv(m, _mesh(), backend=BACKEND,
                              storage_dtype="bfloat16")
    vals_dts = {v.dtype for k, v in b16.stacks.items()
                if k.endswith("_vals")}
    assert vals_dts == {torch.bfloat16}
    assert b16.per_device_format_bytes < f32.per_device_format_bytes
    x = _x(m)
    assert _rel_err(b16(x), _oracle(m, x)) < 2e-2


def test_sharded_dedup_vs_closure_baseline():
    m = _port(powerlaw_matrix(400, 360, 6.0, 1.2, seed=5))
    prog = dist.shard_map_spmv(m, _mesh(), mode="row", backend=BACKEND)
    assert prog.per_device_format_bytes <= 4 * prog.replicated_format_bytes
    assert prog.per_device_format_bytes > 0


def test_cuda_dispatch_on_cpu_operands_matches_torch(small_irregular):
    """The ``cuda`` body on CPU operands: each kernel wrapper and the
    ordered combine take their plain versions, and agree with the
    ``torch`` body (the tensors are the same; only the dispatch differs)."""
    m = small_irregular
    for mode in ("row", "col"):
        prog = dist.shard_map_spmv(m, _mesh(4), mode=mode, backend=BACKEND)
        n_out = prog.band_rows if mode == "row" else prog.n_rows
        fn = dist.make_stacked_fn(prog.steps, mode, n_out, prog.mesh, "data",
                                  backend="cuda")
        for b in (1, 8):
            x = _x(m, b)
            got = dist.stacked_call(fn, prog.operands, x, mode, m.n_cols,
                                    [s.size for s in prog.shards], "cpu")
            np.testing.assert_allclose(got.numpy(), prog(x).numpy(),
                                       rtol=0, atol=1e-6)


def test_combine_order_is_stable_and_fixed():
    from repro_torch.kernels.combine import combine_order, rowmap_combine
    rm = torch.tensor([[3, -1, 0], [3, 0, -1], [1, 3, 3]], dtype=torch.int32)
    perm, offsets = combine_order(rm, 5)
    assert perm.tolist() == [2, 4, 6, 0, 3, 7, 8]
    assert offsets.tolist() == [0, 2, 3, 3, 7, 7]
    flat = torch.arange(9, dtype=torch.float32) + 1
    y = rowmap_combine(torch.zeros(5), flat, perm, offsets)
    assert y.tolist() == [3 + 5, 7, 0, 1 + 4 + 8 + 9, 0]
    with pytest.raises(ValueError, match="row 3"):
        combine_order(rm, 3)


# ------------------------------ sharded plans -------------------------------

@pytest.mark.parametrize("mode", ["row", "col"])
def test_sharded_plan_matches_oracle(mode, small_irregular):
    m = small_irregular
    t = repro_torch.Target(backend=BACKEND, mesh=_mesh(4), partition=mode)
    plan = repro_torch.compile(m, t)
    assert isinstance(plan, repro_torch.ShardedSpmvPlan)
    for b in (1, 8):
        x = _x(m, b)
        assert _rel_err(plan(x), _oracle(m, x)) < 1e-4


def test_sharded_plan_roundtrip_and_bytes(small_irregular, tmp_path):
    mesh = _mesh()
    plan = repro_torch.compile(small_irregular,
                               repro_torch.Target(backend=BACKEND, mesh=mesh))
    assert plan.per_device_format_bytes > 0
    assert plan.replicated_format_bytes > 0
    path = tmp_path / "sharded.plan.npz"
    plan.save(path)
    # loading without a mesh yields a plan that refuses to run...
    detached = repro_torch.load_plan(path)
    with pytest.raises(ValueError, match="mesh"):
        detached(_x(small_irregular))
    # ...re-attaching a mesh restores bit-exact execution
    loaded = repro_torch.SpmvPlan.load(path, mesh=mesh)
    for b in (1, 8):
        x = _x(small_irregular, b)
        assert torch.equal(loaded(x), plan(x))
        assert torch.equal(plan(x), plan(x))
    with pytest.raises(ValueError, match="compiled for 1 shards"):
        repro_torch.load_plan(path, mesh=_mesh(2))
    with pytest.raises(NotImplementedError):
        plan.update(None)


def test_sharded_compile_budgets_and_store(small_uniform, tmp_path):
    """budget=None, a fixed graph, a ShardedSearchConfig and plain
    seconds all give a ShardedSpmvPlan; a PlanStore keys, reloads (with
    the Target's mesh) and watches it."""
    m = small_uniform
    mesh = _mesh(2)
    t = repro_torch.Target(backend=BACKEND, mesh=mesh)
    x = _x(m)
    plans = {
        "default": repro_torch.compile(m, t),
        "graph": repro_torch.compile(m, t, graph=dist.SEG_GRAPH),
        "sharded_cfg": repro_torch.compile(m, t, budget=_tiny_search_cfg()),
        "seconds": repro_torch.compile(m, t, budget=2.0),
    }
    for name, plan in plans.items():
        assert isinstance(plan, repro_torch.ShardedSpmvPlan), name
        assert plan.n_shards == 2, name
        assert _rel_err(plan(x), _oracle(m, x)) < 1e-4, name
    assert plans["sharded_cfg"].search_result is not None
    assert {s["reduce"] for s in plans["graph"].steps} == {"seg_scan"}
    store = repro_torch.PlanStore(tmp_path / "plans")
    watch = store.watch(m, t)
    first = repro_torch.compile(m, t, store=store)
    hit = repro_torch.compile(m, t, store=store)
    assert (store.misses, store.hits) == (1, 1)
    assert torch.equal(hit(x), first(x))
    polled = watch.poll()
    assert isinstance(polled, repro_torch.ShardedSpmvPlan)
    assert torch.equal(polled(x), first(x))
    assert store.verify()["corrupt"] == []


def test_sharded_cost_analysis_counts_the_stacks(small_irregular):
    plan = repro_torch.compile(small_irregular, repro_torch.Target(
        backend=BACKEND, mesh=_mesh(4), partition="col"))
    cost = plan.cost_analysis()
    slots = sum(plan.stacks[f"{s['key']}_vals"].numel() for s in plan.steps)
    assert cost["flops"] == 2 * slots
    assert plan.cost_analysis(8)["flops"] == 8 * cost["flops"]
    assert cost["bytes accessed"] > plan.per_device_format_bytes


# ------------------------- per-shard search ---------------------------------

def test_dist_search_deterministic_under_fixed_seed(small_uniform):
    runs = []
    for _ in range(2):
        res = dist_search(small_uniform, _mesh(), _tiny_search_cfg())
        runs.append([tuple(r.structure for r in rep.result.records)
                     for rep in res.reports if rep.result is not None])
    assert runs[0] == runs[1]


def test_dist_search_program_correct(small_uniform):
    res = dist_search(small_uniform, _mesh(), _tiny_search_cfg())
    x = _x(small_uniform, seed=1)
    assert _rel_err(res.program(x), _oracle(small_uniform, x)) < 1e-4
    assert all(rep.searched for rep in res.reports if not rep.shard.is_empty)


def test_search_survives_wrong_program(small_uniform):
    """A wrong generated program is a failed candidate (warned, memoised
    inf), not an uncaught AssertionError."""
    from repro_torch.core.search import AlphaSparseSearch
    s = AlphaSparseSearch(small_uniform,
                          SearchConfig(max_seconds=5, max_structures=1,
                                       coarse_samples=1, timing_repeats=1,
                                       use_cost_model=False,
                                       backend=BACKEND))
    s._oracle = s._oracle + 1e6        # force every correctness check to fail
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with pytest.raises(RuntimeError, match="no valid program"):
            s.run()
    assert any("WRONG" in str(w.message) for w in caught)
    assert all(v == np.inf for v in s._memo.values())


def test_dist_search_parallel_matches_sequential_4_shards():
    """Pooled per-shard searches are positionally identical to the
    sequential path (the reference's SCRIPT_PARALLEL, in-process)."""
    m = _port(powerlaw_matrix(320, 300, 6.0, 1.0, seed=2))
    cfg = ShardedSearchConfig(
        search=SearchConfig(max_seconds=60, max_structures=2,
                            coarse_samples=1, fine_eval_budget=0,
                            timing_repeats=1, use_cost_model=False, seed=7),
        min_nnz_for_search=1, backend=BACKEND)
    x = _x(m)
    runs, errs = {}, {}
    for tag, workers in (("seq", 1), ("par", 4)):
        res = dist_search(m, _mesh(4),
                          dataclasses.replace(cfg, max_workers=workers))
        runs[tag] = [[r.structure for r in rep.result.records]
                     for rep in res.reports if rep.result is not None]
        errs[tag] = _rel_err(res.program(x), _oracle(m, x))
    assert len(runs["seq"]) >= 2          # the pool actually engaged
    assert runs["seq"] == runs["par"]
    assert errs["seq"] < 1e-4 and errs["par"] < 1e-4


def test_shard_search_failure_degrades_to_baseline():
    m = _port(banded_matrix(64, 4, seed=0))

    def crash(shard):
        raise RuntimeError("injected shard crash")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with shard_fault_hook(crash):
            res = dist_search(m, _mesh(), _tiny_search_cfg())
    assert res.failed_shards() == [0]
    rep = res.reports[0]
    assert rep.failed and not rep.searched
    assert rep.failure == "crash" and "injected shard crash" in rep.error
    assert res.failure_counts.get("fallback") == 1
    x = np.ones(m.n_cols, np.float32)
    assert np.allclose(res.program(x).numpy(), m.spmv_dense_oracle(x),
                       atol=1e-3)


def test_sharded_plan_failure_counts_roundtrip(tmp_path):
    m = _port(banded_matrix(64, 4, seed=0))
    mesh = _mesh()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with shard_fault_hook(lambda s: (_ for _ in ()).throw(
                MemoryError("injected shard oom"))):
            res = dist_search(m, mesh, _tiny_search_cfg())
    assert res.reports[0].failure == "oom"
    plan = repro_torch.ShardedSpmvPlan.from_program(
        res.program, repro_torch.Target(backend=BACKEND, mesh=mesh),
        search_result=res)
    counts = dict(plan.failure_counts)
    assert counts.get("fallback") == 1
    assert "shard-search failures:" in plan.describe()
    p = tmp_path / "sharded.plan.npz"
    plan.save(p)
    loaded = repro_torch.load_plan(p, mesh=mesh)
    assert dict(loaded.failure_counts) == counts
    x = np.ones(m.n_cols, np.float32)
    assert np.allclose(loaded(x).numpy(), m.spmv_dense_oracle(x), atol=1e-3)


def test_dist_search_derives_distinct_per_shard_seeds(monkeypatch):
    """Every shard gets SearchConfig.seed = cfg.seed + search.seed +
    shard_id."""
    from repro_torch.core.search import SearchResult
    m = _port(powerlaw_matrix(400, 400, 6.0, 1.0, seed=9))
    seen = []

    def spy(matrix, cfg, cache=None, strategy=None, warm_start=None):
        seen.append(cfg.seed)
        g = dist.default_shard_graph(matrix)
        prog = build_program(run_graph(matrix, g), backend=BACKEND)
        return SearchResult(best_graph=g, best_program=prog,
                            best_seconds=1e-3, gflops=1.0, n_evaluations=1,
                            n_structures=1, wall_seconds=0.0, records=[],
                            cost_model_mad=None, pruned_ops=())

    monkeypatch.setattr(dsearch, "run_search", spy)

    class FakeMesh:             # only _axis_size reads .shape
        shape = {"data": 2}

    cfg = ShardedSearchConfig(
        search=SearchConfig(max_seconds=5, max_structures=1,
                            coarse_samples=1, fine_eval_budget=0,
                            timing_repeats=1, use_cost_model=False, seed=7),
        min_nnz_for_search=1, backend=BACKEND)
    try:
        dsearch.dist_search(m, FakeMesh(), cfg)
    except Exception:
        pass   # placing the program needs a real mesh; the searches ran
    assert seen == [7, 8]


def test_shard_walks_diverge_under_derived_seeds(small_uniform):
    from repro_torch.design.space import DesignSpace
    from repro_torch.design.strategies import AnnealStrategy
    cfg = SearchConfig(max_seconds=600.0, max_structures=3,
                       coarse_samples=100, use_cost_model=False,
                       timing_repeats=1, backend=BACKEND)
    orders = []
    for seed in (7, 8):
        space = DesignSpace(small_uniform,
                            dataclasses.replace(cfg, seed=seed))
        strat = AnnealStrategy()
        strat.reset(space, np.random.default_rng(seed), cfg)
        orders.append([s.label() for s in strat._queue])
    assert orders[0][:4] == orders[1][:4]      # same mandatory seed pass
    assert orders[0] != orders[1]              # diverging walk after it


def test_placement_refuses_the_wrong_device():
    with pytest.raises(ValueError, match="cpu"):
        repro_torch.Target(backend="cuda", mesh=_mesh(2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            make_data_mesh(2)
        with pytest.raises(RuntimeError, match="GPU"):
            make_data_mesh(2, device="cuda:0")
    mesh = _mesh(3)
    assert mesh.shape == {"data": 3} and mesh.axis_names == ("data",)
    assert mesh.devices == (torch.device("cpu"),) * 3


# ------------------------- parity with the reference ------------------------

@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("balance", ["nnz", "rows"])
@pytest.mark.parametrize("mode", ["row", "col"])
def test_partition_matrix_bit_identical(mode, balance, n_shards):
    cases = [powerlaw_matrix(200, 180, 5.0, 1.0, seed=3),
             # empty shards; degenerate trailing col shards
             repro.SparseMatrix(64, 8, np.array([0, 0, 1], np.int32),
                                np.array([0, 2, 1], np.int32),
                                np.ones(3, np.float32)),
             powerlaw_matrix(60, 10, 3.0, 1.0, seed=6)]
    for m in cases:
        ref = ref_dist.partition_matrix(m, n_shards, mode=mode,
                                        balance=balance)
        ours = dist.partition_matrix(_port(m), n_shards, mode=mode,
                                     balance=balance)
        assert len(ref) == len(ours)
        for a, b in zip(ref, ours):
            assert (a.index, a.start, a.stop, a.mode) == (b.index, b.start,
                                                          b.stop, b.mode)
            assert (a.matrix.n_rows, a.matrix.n_cols) == (b.matrix.n_rows,
                                                          b.matrix.n_cols)
            for f in ("rows", "cols", "vals"):
                x, y = getattr(a.matrix, f), getattr(b.matrix, f)
                assert x.dtype == y.dtype and np.array_equal(x, y), f


# per-shard graphs that give several families at once: ELL buckets, two
# seg reduce kinds and gmem_atom's row stream
_MIXED = (ref_dist.ELL_GRAPH, ref_dist.SEG_GRAPH,
          repro.OperatorGraph.chain(
              repro.OpSpec.make("COMPRESS"),
              repro.OpSpec.make("LANE_NNZ_BLOCK", chunk=64, lanes=8),
              repro.OpSpec.make("ONEHOT_MXU_RED")),
          repro.OperatorGraph.chain(
              repro.OpSpec.make("COMPRESS"),
              repro.OpSpec.make("LANE_NNZ_BLOCK", chunk=128, lanes=8),
              repro.OpSpec.make("GMEM_ATOM_RED")))


def _graph_json(g):
    from repro.core.search import _graph_to_jsonable
    from repro_torch.core.search import _graph_from_jsonable
    return _graph_from_jsonable(json.loads(json.dumps(_graph_to_jsonable(g))))


def _both_packings(m, n_shards, mode, storage, graphs):
    """(reference, port) pack_operand_format of per-shard programs built
    by each package from the same graphs. ``storage="mixed"`` stores the
    odd shards in bf16 and the even ones in fp32, so the stacks widen."""
    ref_progs, our_progs = [], []
    for i, (rs, ps) in enumerate(zip(
            ref_dist.partition_matrix(m, n_shards, mode=mode),
            dist.partition_matrix(_port(m), n_shards, mode=mode))):
        sd = {"float32": None, "bfloat16": "bfloat16",
              "mixed": "bfloat16" if i % 2 else None}[storage]
        if rs.is_empty:
            ref_progs.append(None)
            our_progs.append(None)
            continue
        g = graphs(rs.matrix, i)
        ref_progs.append(ref_build_program(ref_run_graph(rs.matrix, g),
                                           backend="jax", jit=False,
                                           storage_dtype=sd))
        our_progs.append(build_program(run_graph(ps.matrix, _graph_json(g)),
                                       backend=BACKEND, storage_dtype=sd))
    return (ref_dist.pack_operand_format(ref_progs),
            dist.pack_operand_format(our_progs))


PACK_CASES = {
    "default": (lambda: powerlaw_matrix(300, 280, 6.0, 1.0, seed=21),
                lambda sub, i: ref_dist.default_shard_graph(sub)),
    "mixed": (lambda: powerlaw_matrix(300, 280, 6.0, 1.0, seed=22),
              lambda sub, i: _MIXED[i % len(_MIXED)]),
    "banded": (lambda: banded_matrix(256, 5, seed=4),
               lambda sub, i: ref_dist.ELL_GRAPH),
}


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "mixed"])
@pytest.mark.parametrize("mode", ["row", "col"])
@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_operand_format_bit_identical(case, mode, storage):
    make, graphs = PACK_CASES[case]
    m = make()
    (rsteps, rstacks), (steps, stacks) = _both_packings(m, 4, mode, storage,
                                                        graphs)
    if storage == "mixed":       # where shards disagree the stack widens
        assert any(stacks[f"{s['key']}_vals"].dtype == torch.float32
                   for s in steps)
    assert json.dumps(steps) == json.dumps(rsteps)
    assert sorted(stacks) == sorted(rstacks)
    for k, a in rstacks.items():
        a, b = _ref_bits(a), _bits(stacks[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


@pytest.mark.parametrize("mode", ["row", "col"])
@pytest.mark.parametrize("case", ["default", "mixed"])
def test_shard_body_matches_reference_build_kernel(case, mode):
    """The per-shard body: the reference's ``build_kernel`` on the
    synthetic spec over ``stacks[k][i]`` against the port's on the same
    slice (1-D x and B = 8)."""
    make, graphs = PACK_CASES[case]
    m = make()
    n = 4
    (rsteps, rstacks), (steps, stacks) = _both_packings(m, n, mode,
                                                        "float32", graphs)
    shards = dist.partition_matrix(_port(m), n, mode=mode)
    n_out = (max(s.size for s in shards) if mode == "row" else m.n_rows)
    spec = {"version": 2, "n_rows": n_out, "steps": steps}
    ref_run = ref_build_kernel(spec, backend="jax")
    our_run = build_kernel(spec, backend=BACKEND)
    width = -(-m.n_cols // n)
    for b in (1, 8):
        x = _x(m, b)
        for i, s in enumerate(shards):
            xi = x
            if mode == "col":
                pad = np.zeros((width * n,) + x.shape[1:], np.float32)
                pad[:m.n_cols] = x
                xi = pad[i * width:(i + 1) * width]
            want = np.asarray(ref_run({k: v[i] for k, v in rstacks.items()},
                                      xi))
            fmt_i = {k: v[i] for k, v in stacks.items()}
            got = our_run(fmt_i, torch.from_numpy(np.ascontiguousarray(xi)),
                          combine_orders(spec, fmt_i, BACKEND))
            scale = np.abs(want).max() + 1e-30
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * scale)


def _jax_mesh1():
    import jax
    return jax.make_mesh((1,), ("data",))


def _ref_key(spec_dict):
    blob = json.dumps(spec_dict, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:8]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["row", "col"])
def test_sharded_plan_files_load_both_ways(tmp_path, mode, dtype):
    """A reference-saved sharded plan (one shard) loads in the port and
    answers the same, and back. The port writes its own backend name
    (``torch``), which the reference's Target refuses, so the way back
    rewrites the header's backend to ``jax`` and re-checksums it with the
    reference's rule."""
    from repro.api import _content_checksum
    m = powerlaw_matrix(300, 260, 6.0, 1.0, seed=31)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    ref_t = repro.Target(backend="jax", mesh=_jax_mesh1(), partition=mode,
                         dtype=dtype)
    ref = repro.compile(m, ref_t)
    path = tmp_path / "ref.plan.npz"
    ref.save(path)
    mesh = _mesh()
    ours = repro_torch.load_plan(path, mesh=mesh)
    assert isinstance(ours, repro_torch.ShardedSpmvPlan)
    assert ours.target.backend == BACKEND and ours.target.dtype == dtype
    assert ours.steps_json == ref.steps_json
    assert (ours.bounds, ours.band_rows, ours.nnz) == (ref.bounds,
                                                       ref.band_rows, ref.nnz)
    for k, a in ref.stacks.items():
        assert np.array_equal(_ref_bits(a), _bits(ours.stacks[k])), k
    for b in (1, 8):
        x = _x(m, b)
        want = np.asarray(ref(x), np.float64)
        scale = np.abs(want).max() + 1e-30
        np.testing.assert_allclose(ours(x).numpy(), want, rtol=0,
                                   atol=tol * scale)
    # Target.key(): the port's key is the reference's over the same fields
    assert ours.target.spec_dict()["mesh"] == ref_t.spec_dict()["mesh"]
    assert _ref_key({**ours.target.spec_dict(), "backend": "jax"}) == \
        ref_t.key()

    # ... and back: a port-compiled plan in the reference
    plan = repro_torch.compile(_port(m), repro_torch.Target(
        backend=BACKEND, mesh=mesh, partition=mode, dtype=dtype))
    mine = tmp_path / "port.plan.npz"
    plan.save(mine)
    with np.load(mine) as z:
        arrays = {k: z[k] for k in z.files if k != "__plan__"}
        header = json.loads(str(z["__plan__"]))
    header["target"]["backend"] = "jax"
    header["checksum"] = _content_checksum(header, arrays)
    back = tmp_path / "back.plan.npz"
    np.savez(back, __plan__=np.str_(json.dumps(header)), **arrays)
    theirs = repro.load_plan(back, mesh=_jax_mesh1())
    assert theirs.steps_json == plan.steps_json
    for k, t in plan.stacks.items():
        assert np.array_equal(_ref_bits(theirs.stacks[k]), _bits(t)), k
    for b in (1, 8):
        x = _x(m, b, seed=2)
        want = np.asarray(theirs(x), np.float64)
        scale = np.abs(want).max() + 1e-30
        np.testing.assert_allclose(plan(x).numpy(), want, rtol=0,
                                   atol=tol * scale)
