"""repro_torch.dyn against the reference's repro.dyn, on the CPU.

Case for case after tests/test_dyn.py: PatternDelta extraction, capacity
reporting, MoE routing churn through the port's ``models.moe``,
patch-in-place updates (oracle-exact, bit-exact against a fresh port
compile, same dispatch), out-of-capacity rollback, executor admission,
the DynamicSparsityManager control loop and its watchdog, and the
pruning loop. Parity with the reference on shared inputs: the same
deltas, the same capacity report of one saved plan, the same patched
arrays (fp32 and the bf16 bits) and the same refusals, and
``seg_position_rows`` on adversarial segment ends. The port runs on the
``torch`` backend; oracle tolerances are the reference test's.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import repro
from repro.core.graph import OperatorGraph as RefGraph
from repro.core.matrices import SparseMatrix as RefMatrix
from repro.core.matrices import powerlaw_matrix as ref_powerlaw
from repro.core.operators import OpSpec as RefOpSpec
from repro.dyn import PatternDelta as RefDelta
from repro.dyn import PlanPatcher as RefPatcher
from repro.dyn import capacity_report as ref_capacity_report
from repro.dyn.capacity import seg_position_rows as ref_seg_position_rows
from repro.train.dynamic import capacity_graph as ref_capacity_graph

import repro_torch
import repro_torch.api as api_mod
from repro_torch.core.graph import OperatorGraph
from repro_torch.core.matrices import SparseMatrix, powerlaw_matrix
from repro_torch.core.search import SearchConfig
from repro_torch.design.registry import OpSpec
from repro_torch.dyn import (CapacityError, DriftPolicy,
                             DynamicSparsityManager, PatternDelta,
                             PlanPatcher, capacity_report, check_capacity,
                             pattern_stats, same_pattern)
from repro_torch.dyn.capacity import seg_position_rows
from repro_torch.serve.executor import PlanExecutor, SwapRejected
from repro_torch.serve.sparse_linear import SparseLinear
from repro_torch.train.dynamic import capacity_graph, run_pruning_loop

TORCH = repro_torch.Target(backend="torch")
RESEARCH = SearchConfig(max_seconds=2, max_structures=2)


def _base_matrix(seed=3):
    return powerlaw_matrix(96, 96, 12.0, 1.2, seed=seed)


@pytest.fixture(scope="module")
def base_plan():
    m = _base_matrix()
    return m, repro_torch.compile(m, TORCH, graph=capacity_graph())


def _seg_graph(graph_cls, spec_cls):
    return graph_cls.chain(
        spec_cls.make("COMPRESS"),
        spec_cls.make("LANE_NNZ_BLOCK", chunk=64, lanes=8),
        spec_cls.make("SEG_SCAN_RED"))


def _mutated_arrays(m, seed=0, frac_rev=0.1, frac_drop=0.05, n_add=8):
    """The reference test's ``_mutate`` on bare arrays: revalue, drop, and
    add entries into rows that just lost one (so the adds always fit)."""
    rng = np.random.default_rng(seed)
    rows = np.asarray(m.rows)
    cols = np.asarray(m.cols)
    vals = np.array(m.vals, np.float32)
    nnz = vals.size
    rev = rng.choice(nnz, max(1, int(nnz * frac_rev)), replace=False)
    vals[rev] = rng.standard_normal(rev.size).astype(np.float32) + 0.1
    drop = rng.choice(nnz, max(n_add, int(nnz * frac_drop)), replace=False)
    keep = np.ones(nnz, bool)
    keep[drop] = False
    add_rows, add_cols, add_vals = [], [], []
    taken = {(int(r), int(c)) for r, c in zip(rows, cols)}
    for i in drop[:n_add]:
        r = int(rows[i])
        for _ in range(20):
            c = int(rng.integers(0, m.n_cols))
            if (r, c) not in taken:
                taken.add((r, c))
                add_rows.append(r)
                add_cols.append(c)
                add_vals.append(float(rng.standard_normal()) + 0.1)
                break
    return (m.n_rows, m.n_cols,
            np.concatenate([rows[keep], np.array(add_rows, np.int32)]),
            np.concatenate([cols[keep], np.array(add_cols, np.int32)]),
            np.concatenate([vals[keep], np.array(add_vals, np.float32)]))


def _mutate(m, **kw):
    return SparseMatrix(*_mutated_arrays(m, **kw)).canonical()


def _x(m, seed=0):
    return np.random.default_rng(seed).standard_normal(
        m.n_cols).astype(np.float32)


def _y(program, x):
    return program(x).cpu().numpy()


def _assert_oracle(m, program, rtol=1e-5):
    x = _x(m)
    want = m.spmv_dense_oracle(x)
    got = _y(program, x).astype(np.float64)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0)


def _delta_fields(d):
    return {f.name: np.asarray(getattr(d, f.name))
            for f in dataclasses.fields(d)}


def _assert_same_delta(port, ref):
    a, b = _delta_fields(port), _delta_fields(ref)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------- PatternDelta ------------------------------------

def test_delta_from_matrices_roundtrip():
    m0 = _base_matrix()
    m1 = _mutate(m0, seed=1)
    d = PatternDelta.from_matrices(m0, m1)
    assert d.n_added > 0 and d.n_removed > 0 and d.n_revalued > 0
    assert not d.is_empty
    m2 = d.apply_to(m0)
    assert same_pattern(m2, m1)
    np.testing.assert_array_equal(m2.vals, m1.vals)
    assert PatternDelta.from_matrices(m1, m1).is_empty
    assert "PatternDelta" in repr(d)
    assert d.affected_rows().size > 0
    # the reference extracts the same delta from the same matrices
    r0 = ref_powerlaw(96, 96, 12.0, 1.2, seed=3)
    r1 = RefMatrix(*_mutated_arrays(r0, seed=1)).canonical()
    _assert_same_delta(d, RefDelta.from_matrices(r0, r1))
    np.testing.assert_array_equal(d.affected_rows(),
                                  RefDelta.from_matrices(r0, r1)
                                  .affected_rows())


@pytest.mark.parametrize("with_old_weights", [False, True])
def test_delta_from_masks(with_old_weights):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, 16)).astype(np.float32)
    old = np.abs(w) > 1.0
    new = np.abs(w) > 0.8
    w_old = (w + 0.01 * rng.standard_normal(w.shape).astype(np.float32)
             if with_old_weights else None)
    d = PatternDelta.from_masks(w, old, new, old_weights=w_old)
    if not with_old_weights:
        assert d.n_added == int((new & ~old).sum())
        assert d.n_removed == int((old & ~new).sum())
    else:
        assert d.n_revalued > 0
    _assert_same_delta(d, RefDelta.from_masks(w, old, new,
                                              old_weights=w_old))


# ------------------------- capacity reporting ------------------------------

def test_capacity_report_and_describe(base_plan):
    m, plan = base_plan
    rep = capacity_report(plan)
    assert rep["live_nnz"] == m.nnz
    assert rep["ell_slack"] > 0          # LANE_PAD provisioned headroom
    assert rep["plan_version"] == 0
    assert rep["int16_col_margin"] is None or rep["int16_col_margin"] >= 0
    for step in rep["steps"]:
        assert step["slots"] >= step["used"]
    # the same numbers surface in describe() (cost_analysis is not ported)
    assert "capacity" in plan.describe()


@pytest.fixture(scope="module")
def ref_plans(tmp_path_factory):
    """Reference plans saved to disk, each with its reference matrix:
    the capacity ELL design in fp32 and bf16, and a seg_scan design."""
    d = tmp_path_factory.mktemp("ref_plans")
    m = ref_powerlaw(96, 96, 12.0, 1.2, seed=3)
    plans = {
        "fp32": repro.compile(m, repro.Target(), graph=ref_capacity_graph()),
        "bf16": repro.compile(m, repro.Target(dtype="bfloat16"),
                              graph=ref_capacity_graph()),
        "seg": repro.compile(m, repro.Target(),
                             graph=_seg_graph(RefGraph, RefOpSpec)),
    }
    out = {}
    for name, plan in plans.items():
        path = d / f"{name}.plan.npz"
        plan.save(path)
        out[name] = (m, plan, path)
    return out


@pytest.mark.parametrize("kind", ["fp32", "bf16", "seg"])
def test_capacity_report_matches_reference(ref_plans, kind):
    _, ref_plan, path = ref_plans[kind]
    port_plan = repro_torch.load_plan(path, backend="torch")
    assert capacity_report(port_plan) == ref_capacity_report(ref_plan)


def _npz(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files if k != "__plan__"}


@pytest.mark.parametrize("kind", ["fp32", "bf16", "seg"])
def test_same_delta_on_a_saved_plan_matches_reference(ref_plans, kind,
                                                      tmp_path):
    rm, ref_plan, path = ref_plans[kind]
    port_plan = repro_torch.load_plan(path, backend="torch")
    arrays = _mutated_arrays(rm, seed=2, n_add=4 if kind == "seg" else 8)
    ref_upd = ref_plan.update(RefDelta.from_matrices(
        rm, RefMatrix(*arrays).canonical()))
    pm = SparseMatrix(rm.n_rows, rm.n_cols, rm.rows, rm.cols, rm.vals)
    port_upd = port_plan.update(PatternDelta.from_matrices(
        pm, SparseMatrix(*arrays).canonical()))
    assert port_upd.plan_version == ref_upd.plan_version == 1
    ref_upd.save(tmp_path / "ref.plan.npz")
    port_upd.save(tmp_path / "port.plan.npz")
    a, b = _npz(tmp_path / "ref.plan.npz"), _npz(tmp_path / "port.plan.npz")
    assert sorted(a) == sorted(b)
    if kind == "bf16":     # the stored bf16 bits travel as uint16 views
        assert any(k.startswith("fmt::bf16!") for k in b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), f"{kind}: {k} differs"


def _row_flood(rows, cols, n_rows, n_cols, r):
    """Every column of row ``r`` not yet stored, as (rows, cols, vals)."""
    taken = set(np.asarray(cols)[np.asarray(rows) == r].tolist())
    new = np.array([c for c in range(n_cols) if c not in taken], np.int32)
    return np.full(new.size, r, np.int32), new, np.ones(new.size, np.float32)


def test_out_of_capacity_matches_reference(ref_plans):
    rm, ref_plan, path = ref_plans["fp32"]
    port_plan = repro_torch.load_plan(path, backend="torch")
    r = int(rm.rows[0])
    ar, ac, av = _row_flood(rm.rows, rm.cols, rm.n_rows, rm.n_cols, r)
    # a removal and a revalue first: the rollback must undo them too
    fields = dict(add_rows=ar, add_cols=ac, add_vals=av,
                  drop_rows=rm.rows[5:6].copy(), drop_cols=rm.cols[5:6].copy(),
                  reval_rows=rm.rows[9:10].copy(),
                  reval_cols=rm.cols[9:10].copy(),
                  reval_vals=np.array([3.0], np.float32))
    ref_patcher = RefPatcher(ref_plan)
    port_patcher = PlanPatcher(port_plan)
    before = [(s.vals.copy(), s.cols.copy()) for s in port_patcher.steps]
    ref_check = ref_patcher.check(RefDelta(rm.n_rows, rm.n_cols, **fields))
    port_check = port_patcher.check(PatternDelta(rm.n_rows, rm.n_cols,
                                                 **fields))
    assert not port_check and port_check.reasons == ref_check.reasons
    with pytest.raises(repro.dyn.CapacityError) as ref_err:
        ref_patcher.apply(RefDelta(rm.n_rows, rm.n_cols, **fields))
    with pytest.raises(CapacityError) as port_err:
        port_patcher.apply(PatternDelta(rm.n_rows, rm.n_cols, **fields))
    assert str(port_err.value) == str(ref_err.value)
    # the same rollback: both working copies are back where they started
    for (v0, c0), ps, rs in zip(before, port_patcher.steps,
                                ref_patcher.steps):
        np.testing.assert_array_equal(ps.vals, v0)
        np.testing.assert_array_equal(ps.cols, c0)
        np.testing.assert_array_equal(ps.vals, rs.vals)
        np.testing.assert_array_equal(ps.cols, rs.cols)
    assert port_patcher.plan is port_plan


SEG_END_CASES = ["ascending", "descending", "repeated", "below_zero",
                 "past_c"]


def _seg_ends(rng, case, t, c, m):
    if case == "ascending":
        e = np.sort(rng.integers(0, c + 1, (t, m)), axis=1)
    elif case == "descending":
        e = -np.sort(-rng.integers(0, c + 1, (t, m)), axis=1)
    elif case == "repeated":
        e = np.repeat(rng.integers(0, c + 1, (t, (m + 2) // 3)), 3,
                      axis=1)[:, :m]
    elif case == "below_zero":
        e = rng.integers(-5, c // 2, (t, m))
    else:
        e = rng.integers(c // 2, c + 9, (t, m))
    # one end at or past C a tile keeps every position's segment index
    # inside the rowmap (as the packers' absent segments do)
    e[np.arange(t), rng.integers(0, m, t)] = c + rng.integers(0, 3, t)
    return e.astype(np.int32)


@pytest.mark.parametrize("case", SEG_END_CASES)
def test_seg_position_rows_matches_reference(case):
    rng = np.random.default_rng(SEG_END_CASES.index(case))
    t, s, l, m = 7, 4, 8, 11
    c = s * l
    fmt = {"k_vals": rng.standard_normal((t, s, l)).astype(np.float32),
           "k_rowmap": rng.integers(-1, 500, (t, m)).astype(np.int32),
           "k_end": _seg_ends(rng, case, t, c, m)}
    step = {"key": "k"}
    want = ref_seg_position_rows(step, fmt)
    got = seg_position_rows(step, {k: torch.from_numpy(v)
                                   for k, v in fmt.items()})
    assert got.dtype == want.dtype and got.shape == (t, c)
    np.testing.assert_array_equal(got, want)


# ------------------------- patch-in-place ----------------------------------

def test_update_bitexact_vs_fresh_compile(base_plan):
    m, plan = base_plan
    m1 = _mutate(m, seed=2)
    delta = PatternDelta.from_matrices(m, m1)
    assert check_capacity(plan, delta)
    upd = plan.update(delta)
    fresh = repro_torch.compile(m1, TORCH, graph=capacity_graph())
    x = _x(m)
    np.testing.assert_array_equal(_y(upd, x), _y(fresh, x))
    _assert_oracle(m1, upd)
    # version advances; the source plan is untouched
    assert upd.plan_version == plan.plan_version + 1
    _assert_oracle(m, plan)


def test_update_keeping_row_lengths_packs_the_fresh_format(base_plan):
    """A delta that re-adds into every row that lost an entry keeps each
    row's length, so the fresh compile designs the same layout (SORT_TILE
    orders rows by length): then every patched tensor equals the fresh
    plan's, not only the output."""
    m, plan = base_plan
    n_drop = int(m.nnz * 0.05)
    m1 = _mutate(m, seed=12, n_add=n_drop)
    np.testing.assert_array_equal(m1.row_lengths(), m.row_lengths())
    upd = plan.update(PatternDelta.from_matrices(m, m1))
    fresh = repro_torch.compile(m1, TORCH, graph=capacity_graph())
    assert sorted(upd.fmt) == sorted(fresh.fmt)
    for k, t in fresh.fmt.items():
        assert torch.equal(upd.fmt[k], t), k
    x = _x(m)
    np.testing.assert_array_equal(_y(upd, x), _y(fresh, x))


def test_update_same_dispatch(base_plan):
    """The port's analogue of "no retrace": the patched plan keeps the spec,
    the format keys and every tensor's shape, dtype and device, and so
    gets the very same interpreted kernel function."""
    m, plan = base_plan
    before = {k: t.clone() for k, t in plan.fmt.items()}
    upd = plan.update(PatternDelta.from_matrices(m, _mutate(m, seed=4)))
    assert upd.spec_json == plan.spec_json
    assert upd.target == plan.target and upd.graph_json == plan.graph_json
    assert sorted(upd.fmt) == sorted(plan.fmt)
    changed = 0
    for k, t in plan.fmt.items():
        u = upd.fmt[k]
        assert (u.shape, u.dtype, u.device) == (t.shape, t.dtype, t.device)
        assert torch.equal(t, before[k])          # never written in place
        if not torch.equal(u, t):
            changed += 1
            assert u.data_ptr() != t.data_ptr()   # a new tensor
    assert changed > 0
    assert (api_mod._dense_kernel(upd.spec_json, upd.target.backend)
            is api_mod._dense_kernel(plan.spec_json, plan.target.backend))


def test_update_out_of_capacity_rolls_back(base_plan):
    m, plan = base_plan
    r = int(m.rows[0])
    ar, ac, av = _row_flood(m.rows, m.cols, m.n_rows, m.n_cols, r)
    big = SparseMatrix(m.n_rows, m.n_cols, np.concatenate([m.rows, ar]),
                       np.concatenate([m.cols, ac]),
                       np.concatenate([m.vals, av])).canonical()
    delta = PatternDelta.from_matrices(m, big)
    check = check_capacity(plan, delta)
    assert not check and check.reasons
    with pytest.raises(CapacityError):
        plan.update(delta)
    _assert_oracle(m, plan)


def test_update_seg_family(base_plan):
    m, _ = base_plan
    plan = repro_torch.compile(m, TORCH,
                               graph=_seg_graph(OperatorGraph, OpSpec))
    # removals create holes; later adds into the same rows refill them
    m1 = _mutate(m, seed=5, n_add=4)
    upd = plan.update(PatternDelta.from_matrices(m, m1))
    _assert_oracle(m1, upd)
    _assert_oracle(m, plan)


def test_update_bf16_quantizes_through_storage(base_plan):
    m, _ = base_plan
    plan = repro_torch.compile(
        m, repro_torch.Target(backend="torch", dtype="bfloat16"),
        graph=capacity_graph())
    m1 = _mutate(m, seed=6)
    upd = plan.update(PatternDelta.from_matrices(m, m1))
    assert upd.fmt["b0k0_vals"].dtype == torch.bfloat16
    # bf16 storage rounds values to ~2^-8 relative precision
    _assert_oracle(m1, upd, rtol=2e-2)


def test_sparse_linear_update(base_plan):
    m, plan = base_plan
    layer = SparseLinear.from_plan(plan, m)
    m1 = _mutate(m, seed=7)
    new_layer = layer.update(PatternDelta.from_matrices(m, m1))
    assert same_pattern(new_layer.matrix, m1)
    _assert_oracle(m1, new_layer)
    _assert_oracle(m, layer)            # the old layer is untouched


def test_plan_version_save_load_roundtrip(base_plan, tmp_path):
    m, plan = base_plan
    upd = plan.update(PatternDelta.from_matrices(m, _mutate(m, seed=8)))
    upd = dataclasses.replace(upd, plan_version=7)
    path = tmp_path / "p.plan.npz"
    upd.save(path)
    back = repro_torch.load_plan(path)
    assert back.plan_version == 7
    x = _x(m)
    np.testing.assert_array_equal(_y(back, x), _y(upd, x))


# ------------------------- executor admission ------------------------------

def test_executor_rejects_stale_version_and_applies_updates(base_plan):
    m, plan = base_plan
    ex = PlanExecutor(plan, matrix=m)
    m1 = _mutate(m, seed=9)
    upd = plan.update(PatternDelta.from_matrices(m, m1))
    ex.apply_update(upd, m1)
    assert ex.update_count == 1
    assert ex.plan.plan_version == 1
    # re-publishing the stale birth plan must not clobber the live one
    with pytest.raises(SwapRejected):
        ex.swap_plan(plan)
    assert ex.rejected_swaps == 1
    assert ex.plan is upd
    # spot-check runs against the *current* matrix: a fresh compile of
    # the mutated pattern (same version) is admitted
    fresh = repro_torch.compile(m1, TORCH, graph=capacity_graph())
    fresh = dataclasses.replace(fresh, plan_version=2)
    ex.swap_plan(fresh)
    assert ex.swap_count == 1
    out = ex.execute(_x(m)[None, :])
    want = m1.spmv_dense_oracle(_x(m))
    np.testing.assert_allclose(out[0], want,
                               atol=1e-5 * (np.abs(want).max() + 1e-30),
                               rtol=0)


# ------------------------- manager control loop ----------------------------

def _drift_drop(m, frac=0.35, seed=0):
    """Pure-removal mutation: always fits capacity, but drops enough nnz
    to walk the stats past DriftPolicy's 1.3x fold-change."""
    rng = np.random.default_rng(seed)
    keep = np.ones(m.nnz, bool)
    keep[rng.choice(m.nnz, int(m.nnz * frac), replace=False)] = False
    m1 = SparseMatrix(m.n_rows, m.n_cols, m.rows[keep], m.cols[keep],
                      m.vals[keep]).canonical()
    return m1, PatternDelta.from_matrices(m, m1)


def test_manager_drift_research_publish(base_plan, tmp_path):
    m, plan = base_plan
    store = repro_torch.PlanStore(tmp_path)
    store.put(m, plan.target, None, None, plan)
    watch = store.watch(m, plan.target)
    watch.poll()                         # arm: birth plan already seen
    ex = PlanExecutor(plan, matrix=m, watch=watch)
    mgr = DynamicSparsityManager(m, plan, executor=ex, store=store,
                                 research_budget=RESEARCH,
                                 research_deadline_s=8.0)
    try:
        m1, d = _drift_drop(m)
        out = mgr.apply(d)
        assert out["action"] == "update+research"
        assert mgr.drift_events == 1
        _assert_oracle(m1, mgr.plan)
        assert mgr.quiesce(timeout=120.0)
        res = mgr.poll()
    finally:
        mgr.quiesce(timeout=120.0)
    assert res is None or res["action"] in ("adopted", "research_restart")
    assert mgr.researches_landed >= 1
    assert mgr.plan.plan_version >= 1
    _assert_oracle(mgr.matrix, mgr.plan)
    # the publication went through the store and wakes the serving watch
    assert ex.maybe_reload()
    assert ex.swap_count == 1
    _assert_oracle(m1, ex.layer)


def test_manager_out_of_capacity_defers_and_recovers(base_plan):
    m, plan = base_plan
    mgr = DynamicSparsityManager(m, plan, research_budget=RESEARCH,
                                 research_deadline_s=8.0)
    try:
        ar, ac, av = _row_flood(m.rows, m.cols, m.n_rows, m.n_cols,
                                int(m.rows[0]))
        z = np.zeros(0, np.int32)
        d = PatternDelta(m.n_rows, m.n_cols, add_rows=ar, add_cols=ac,
                         add_vals=av, drop_rows=z, drop_cols=z,
                         reval_rows=z, reval_cols=z,
                         reval_vals=np.zeros(0, np.float32))
        out = mgr.apply(d)
        assert out["action"] == "research"
        assert mgr.out_of_capacity == 1
        assert mgr.stats()["serving_stale"]
        # further mutations fold into the pending target
        m2 = _mutate(mgr.target_matrix, seed=11, n_add=0)
        out2 = mgr.apply(PatternDelta.from_matrices(mgr.target_matrix, m2))
        assert out2["action"] == "deferred"
        assert mgr.quiesce(timeout=120.0)
    finally:
        mgr.quiesce(timeout=120.0)
    assert mgr.researches_landed >= 1
    assert not mgr.stats()["serving_stale"]
    assert same_pattern(mgr.matrix, m2)
    _assert_oracle(m2, mgr.plan)


def test_manager_research_failure_observable(base_plan, monkeypatch):
    """A raising re-search does not vanish into the daemon thread: the
    traceback lands in stats()['last_error']."""
    def dying_compile(*a, **kw):
        raise RuntimeError("injected research death")

    monkeypatch.setattr(api_mod, "compile", dying_compile)
    m, plan = base_plan
    mgr = DynamicSparsityManager(m, plan, max_research_strikes=2,
                                 research_backoff_s=0.01,
                                 research_deadline_s=8.0)
    try:
        m1, d = _drift_drop(m)
        out = mgr.apply(d)
        assert out["action"] == "update+research"
        assert mgr.join(timeout=30.0)
        st = mgr.stats()
        assert st["researches_failed"] >= 1
        assert "injected research death" in st["last_error"]
        assert "Traceback" in st["last_error"]        # full tb, not repr()
        assert st["research_strikes"] >= 1
        assert mgr.quiesce(timeout=30.0)
    finally:
        mgr.quiesce(timeout=30.0)
    st = mgr.stats()
    assert st["research_dead"] and st["watchdog_restarts"] == 1
    assert st["researches_failed"] == 2
    _assert_oracle(m1, mgr.plan)


def test_manager_watchdog_restarts_and_lands(base_plan, monkeypatch):
    """One injected death, then the real compile: the owner-thread pump
    restarts the search with backoff and the retry lands + publishes."""
    real_compile = api_mod.compile
    deaths = {"n": 0}

    def flaky_compile(*a, **kw):
        if deaths["n"] < 1:
            deaths["n"] += 1
            raise RuntimeError("transient research death")
        return real_compile(*a, **kw)

    monkeypatch.setattr(api_mod, "compile", flaky_compile)
    m, plan = base_plan
    mgr = DynamicSparsityManager(m, plan, max_research_strikes=3,
                                 research_backoff_s=0.05,
                                 research_budget=RESEARCH,
                                 research_deadline_s=8.0)
    try:
        m1, d = _drift_drop(m)
        assert mgr.apply(d)["action"] == "update+research"
        adopted = None
        t0 = time.monotonic()
        while time.monotonic() - t0 < 120.0:
            res = mgr.poll()                 # pumps watchdog_tick()
            if res and res["action"] == "adopted":
                adopted = res
                break
            time.sleep(0.01)
        assert adopted is not None, "watchdog retry never landed"
    finally:
        mgr.quiesce(timeout=120.0)
    st = mgr.stats()
    assert deaths["n"] == 1 and st["researches_failed"] == 1
    assert st["watchdog_restarts"] == 1
    assert st["researches_landed"] >= 1
    assert not st["research_dead"]
    assert st["research_strikes"] == 0       # landing clears the strikes
    assert "(watchdog retry 1)" in st["last_research_reason"]
    _assert_oracle(mgr.matrix, mgr.plan)


def test_manager_strikeout_escalates_to_ft(base_plan, monkeypatch):
    """After max_research_strikes consecutive failures the manager stops
    retrying and reports dyn-research unhealthy to the ft machine."""
    from repro_torch.ft import FaultToleranceManager
    monkeypatch.setattr(
        api_mod, "compile",
        lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("always dies")))
    m, plan = base_plan
    ft = FaultToleranceManager()
    mgr = DynamicSparsityManager(m, plan, ft=ft, max_research_strikes=2,
                                 research_backoff_s=0.01,
                                 research_deadline_s=8.0)
    try:
        m1, d = _drift_drop(m)
        mgr.apply(d)
        assert mgr.quiesce(timeout=30.0)
    finally:
        mgr.quiesce(timeout=30.0)
    st = mgr.stats()
    assert st["research_dead"] and not st["retry_pending"]
    assert st["researches_failed"] == 2      # initial + 1 watchdog retry
    assert "dyn-research" in ft.degraded_components()
    health = ft.component_health()["dyn-research"]
    assert not health.healthy and "always dies" in health.error
    # dead means dead: further drift must not resurrect the thread
    started = st["researches_started"]
    mgr.apply(PatternDelta.from_matrices(m1, _mutate(m1, seed=21, n_add=0)))
    assert mgr.stats()["researches_started"] == started
    _assert_oracle(mgr.matrix, mgr.plan)


def test_executor_surfaces_dead_research(base_plan, monkeypatch):
    """A serving loop that only calls maybe_reload() still observes the
    struck-out background search (warned once)."""
    import warnings as _warnings
    monkeypatch.setattr(
        api_mod, "compile",
        lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("dead")))
    m, plan = base_plan
    ex = PlanExecutor(plan, matrix=m)
    mgr = DynamicSparsityManager(m, plan, executor=ex,
                                 max_research_strikes=1,
                                 research_backoff_s=0.01,
                                 research_deadline_s=8.0)
    assert ex._research_monitor is mgr       # auto-attached by the manager
    try:
        _, d = _drift_drop(m)
        mgr.apply(d)
        assert mgr.join(timeout=30.0)
        assert mgr.quiesce(timeout=30.0)
    finally:
        mgr.quiesce(timeout=30.0)
    assert mgr.stats()["research_dead"]
    with pytest.warns(RuntimeWarning, match="struck out"):
        ex.maybe_reload()
    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        ex.maybe_reload()


# ------------------------- MoE routing churn ---------------------------------

def _routes(n_tokens, n_experts, k, seed):
    r = np.random.default_rng(seed)
    idx = np.stack([r.permutation(n_experts)[:k] for _ in range(n_tokens)])
    gates = r.random((n_tokens, k)).astype(np.float32) + 0.1
    return idx, gates


def _churn(idx0, g0, n_experts, k, seed=0):
    """~25 % of tokens re-route one expert slot; all gates move."""
    rng = np.random.default_rng(seed)
    n_tokens = idx0.shape[0]
    idx1, g1 = idx0.copy(), g0 + 0.01
    for t in rng.choice(n_tokens, n_tokens // 4, replace=False):
        free = [e for e in range(n_experts) if e not in idx1[t]]
        idx1[t, rng.integers(k)] = rng.choice(free)
    return idx1, g1


def test_moe_routing_churn_patches_in_place():
    from repro_torch.models.moe import routing_matrix
    n_tokens, n_experts, k = 64, 16, 2
    idx0, g0 = _routes(n_tokens, n_experts, k, seed=1)
    m0 = routing_matrix(idx0, g0, n_experts)
    assert m0.nnz == n_tokens * k
    plan = repro_torch.compile(m0, TORCH, graph=capacity_graph())
    idx1, g1 = _churn(idx0, g0, n_experts, k)
    m1 = routing_matrix(idx1, g1, n_experts)
    delta = PatternDelta.from_matrices(m0, m1)
    assert delta.n_added > 0 and delta.n_removed > 0
    assert delta.n_added == delta.n_removed    # every token keeps k entries
    upd = plan.update(delta)                   # re-route fits the k-lane
    _assert_oracle(m1, upd)
    x = _x(m1, seed=2)
    np.testing.assert_allclose(
        _y(upd, x).astype(np.float64), m1.spmv_dense_oracle(x),
        atol=1e-5 * (np.abs(m1.spmv_dense_oracle(x)).max() + 1e-30), rtol=0)


def test_moe_routing_churn_matches_reference():
    """The same routes give a bit-identical ``routing_matrix`` in both
    packages, and the same churn the same ``PatternDelta``."""
    from repro.models.moe import routing_matrix as ref_routing_matrix
    from repro_torch.models.moe import routing_matrix
    n_tokens, n_experts, k = 64, 16, 2
    idx0, g0 = _routes(n_tokens, n_experts, k, seed=1)
    idx1, g1 = _churn(idx0, g0, n_experts, k)
    mats = []
    for i, g in ((idx0, g0), (idx1, g1)):
        port, ref = routing_matrix(i, g, n_experts), \
            ref_routing_matrix(i, g, n_experts)
        assert (port.n_rows, port.n_cols) == (ref.n_rows, ref.n_cols)
        for name in ("rows", "cols", "vals"):
            a, b = getattr(port, name), np.asarray(getattr(ref, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        mats.append((port, ref))
    _assert_same_delta(PatternDelta.from_matrices(mats[0][0], mats[1][0]),
                       RefDelta.from_matrices(mats[0][1], mats[1][1]))


# ------------------------- train/ pruning loop -----------------------------

def test_run_pruning_loop():
    from repro_torch.serve import prune_magnitude
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    m0 = prune_magnitude(w, 0.15)
    plan = repro_torch.compile(m0, TORCH, graph=capacity_graph())
    mgr = DynamicSparsityManager(m0, plan, research_budget=RESEARCH,
                                 research_deadline_s=8.0)
    rep = run_pruning_loop(w, density=0.15, n_steps=4, manager=mgr,
                           lr=0.005, seed=0)
    assert rep.steps == 4 and rep.manager is mgr
    assert rep.updates_applied >= 1
    assert rep.oracle_max_rel_err < 1e-4
    assert not rep.manager.research_active()


# ------------------------- property test (hypothesis) ----------------------
#
# For ANY in-capacity delta, patching the plan in place is bit-for-bit the
# same as compiling the mutated matrix from scratch with the same design.

def _random_in_capacity_mutation(m, rng):
    rows = np.asarray(m.rows)
    cols = np.asarray(m.cols)
    vals = np.array(m.vals, np.float32)
    nnz = vals.size
    n_rev = int(rng.integers(0, max(nnz // 4, 1)))
    n_drop = int(rng.integers(1, max(nnz // 3, 2)))
    rev = rng.choice(nnz, n_rev, replace=False)
    vals[rev] = rng.standard_normal(n_rev).astype(np.float32) + 0.25
    drop = rng.choice(nnz, n_drop, replace=False)
    keep = np.ones(nnz, bool)
    keep[drop] = False
    taken = {(int(r), int(c)) for r, c in zip(rows, cols)}
    add_r, add_c, add_v = [], [], []
    for i in drop[:int(rng.integers(0, n_drop + 1))]:
        r = int(rows[i])
        c = int(rng.integers(0, m.n_cols))
        if (r, c) not in taken:
            taken.add((r, c))
            add_r.append(r)
            add_c.append(c)
            add_v.append(float(rng.standard_normal()) + 0.25)
    return SparseMatrix(
        m.n_rows, m.n_cols,
        np.concatenate([rows[keep], np.array(add_r, np.int32)]),
        np.concatenate([cols[keep], np.array(add_c, np.int32)]),
        np.concatenate([vals[keep],
                        np.array(add_v, np.float32)])).canonical()


def test_property_update_bitexact_vs_fresh(base_plan):
    pytest.importorskip(
        "hypothesis",
        reason="optional test extra: property tests need hypothesis")
    from hypothesis import given, settings, strategies as st
    m, plan = base_plan
    x = _x(m)

    @settings(max_examples=12, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1))
    def inner(seed):
        rng = np.random.default_rng(seed)
        m1 = _random_in_capacity_mutation(m, rng)
        delta = PatternDelta.from_matrices(m, m1)
        if not check_capacity(plan, delta):   # rare: duplicate-col adds
            return
        upd = plan.update(delta)
        fresh = repro_torch.compile(m1, TORCH, graph=capacity_graph())
        np.testing.assert_array_equal(_y(upd, x), _y(fresh, x))
        assert upd.spec_json == plan.spec_json
        assert {k: (t.shape, t.dtype) for k, t in upd.fmt.items()} == \
            {k: (t.shape, t.dtype) for k, t in plan.fmt.items()}

    inner()


# ------------------------- drift policy ------------------------------------

def test_drift_policy_thresholds():
    m = _base_matrix()
    s = pattern_stats(m)
    pol = DriftPolicy()
    assert not pol.assess(s, s)
    s2 = dict(s, nnz=int(s["nnz"] * 0.6), mean=s["mean"] * 0.6)
    rep = pol.assess(s, s2)
    assert rep.drifted and rep.reasons
