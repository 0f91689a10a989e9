"""The port's matvec serving plane on the CPU (``torch`` backend), held
against the reference's: ``prune_magnitude`` bit for bit, ``decode_buckets``,
the same requests through the reference's ``SpmvEngine`` (jax backend) and
the port's on plans loaded from one saved file, hot-swap through a
``PlanStore`` watch, swap rollback, backpressure, deadlines, retries and
health (after tests/test_faults.py), the async loop and the copied ``ft``
manager.

Tolerance for served answers: ``1e-4 * max|oracle| + 1e-6`` against the
float64 oracle (fp32 storage; both packages sum the same fp32 products in
another order), and the same between the two engines.
"""
import asyncio
import time

import numpy as np
import pytest
import torch

import repro
from repro.core.matrices import banded_matrix as ref_banded
from repro.ft import FaultToleranceConfig as RefFTConfig
from repro.ft import FaultToleranceManager as RefFTManager
from repro.serve import MatvecRequest as RefRequest
from repro.serve import PlanExecutor as RefExecutor
from repro.serve import SpmvEngine as RefEngine
from repro.serve import decode_buckets as ref_decode_buckets
from repro.serve.sparse_linear import _DEFAULT_GRAPH as REF_GRAPH
from repro.serve.sparse_linear import prune_magnitude as ref_prune

import repro_torch
from repro_torch.core.matrices import banded_matrix
from repro_torch.design.registry import OpSpec
from repro_torch.ft import FaultToleranceConfig, FaultToleranceManager
from repro_torch.serve import (MatvecRequest, PlanExecutor, SparseLinear,
                               SpmvEngine, SwapRejected, decode_buckets,
                               prune_magnitude, sparsify_linear)
from repro_torch.serve.sparse_linear import _DEFAULT_GRAPH

TORCH = repro_torch.Target(backend="torch", batch_size=4)
SEG_GRAPH = repro_torch.OperatorGraph.chain(
    OpSpec.make("COMPRESS"), OpSpec.make("LANE_NNZ_BLOCK", chunk=64, lanes=8),
    OpSpec.make("SEG_SCAN_RED"))


def _ok(y, want):
    y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    assert np.isfinite(y).all()
    tol = 1e-4 * np.abs(want).max() + 1e-6
    assert np.abs(y.astype(np.float64) - want).max() <= tol


@pytest.fixture(scope="module")
def matrix():
    return banded_matrix(64, 4, seed=0)


@pytest.fixture(scope="module")
def plan(matrix):
    return repro_torch.compile(matrix, TORCH, graph=_DEFAULT_GRAPH)


def _reqs(n_cols, n, seed=0, rid0=0):
    rng = np.random.default_rng(seed)
    return [MatvecRequest(rid0 + i, rng.standard_normal(n_cols)
                          .astype(np.float32)) for i in range(n)]


# ------------------------------ prune_magnitude -----------------------------

def _prune_cases():
    rng = np.random.default_rng(0)
    return {
        "random": (rng.standard_normal((64, 64)), 0.1),
        "all_ties": (np.ones((16, 16), np.float32), 0.25),
        "mixed_ties": (np.array([[3.0, 1.0, 1.0, 1.0],
                                 [1.0, 1.0, 1.0, 0.5]], np.float32), 0.5),
        "int_ties": (rng.integers(-3, 4, (40, 30)).astype(np.float32), 0.3),
        "k_is_one": (rng.standard_normal((7, 5)).astype(np.float32), 1e-6),
        "signed_ties": (np.array([[-2.0, 2.0, 0.0], [2.0, -2.0, 1.0]],
                                 np.float32), 0.5),
    }


@pytest.mark.parametrize("case", sorted(_prune_cases()))
def test_prune_magnitude_bit_identical_to_reference(case):
    w, density = _prune_cases()[case]
    got, want = prune_magnitude(w, density), ref_prune(w, density)
    assert (got.n_rows, got.n_cols, got.nnz) == (want.n_rows, want.n_cols,
                                                  want.nnz)
    for a, b in ((got.rows, want.rows), (got.cols, want.cols),
                 (got.vals, want.vals)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # exactly k entries, ties broken toward the lower flat index
    assert got.nnz == max(1, int(w.size * density))


# ------------------------------ buckets, layer ------------------------------

@pytest.mark.parametrize("b,top", [(1, None), (2, None), (4, None),
                                   (6, None), (8, None), (3, 16)])
def test_decode_buckets_match_reference(matrix, b, top):
    port = repro_torch.compile(matrix, repro_torch.Target(
        backend="torch", batch_size=b), graph=_DEFAULT_GRAPH)
    ref = repro.compile(ref_banded(64, 4, seed=0),
                        repro.Target(batch_size=b), graph=REF_GRAPH)
    assert decode_buckets(port, top) == ref_decode_buckets(ref, top)
    ex = PlanExecutor(port)
    assert ex.bucket_for(1) == 1 and ex.bucket_for(10 ** 6) == ex.max_bucket


def test_sparse_linear_batched_and_density(matrix, plan):
    layer = SparseLinear.from_plan(plan)
    assert layer.density == pytest.approx(
        matrix.nnz / (matrix.n_rows * matrix.n_cols))
    x = np.random.default_rng(1).standard_normal(
        (3, matrix.n_cols)).astype(np.float32)
    y = layer(torch.from_numpy(x))
    assert y.shape == (3, matrix.n_rows)
    _ok(y, x.astype(np.float64) @ matrix.to_dense().T)
    _ok(layer(x[0]), matrix.spmv_dense_oracle(x[0]))
    opaque = SparseLinear(None, None, object())
    with pytest.warns(RuntimeWarning, match="density is unknown"):
        assert opaque.density is None
    # dynamic sparsity (tests/test_torch_dyn.py): an empty delta gives a
    # new layer at the next plan version with the same answers
    from repro_torch.dyn import PatternDelta
    new = SparseLinear.from_plan(plan, matrix).update(
        PatternDelta.from_matrices(matrix, matrix))
    assert new.program.plan_version == plan.plan_version + 1
    _ok(new(x[0]), matrix.spmv_dense_oracle(x[0]))


def test_sparsify_linear_shim_on_cpu():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((96, 80)).astype(np.float32)
    cfg = repro_torch.SearchConfig(backend="torch", batch_size=3)
    with pytest.warns(DeprecationWarning):
        sl = sparsify_linear(w, density=0.15, search_config=cfg,
                             do_search=False)
    assert sl.program.target.batch_size == 3
    x = rng.standard_normal((3, 80)).astype(np.float32)
    _ok(sl(x), x.astype(np.float64) @ sl.matrix.to_dense().T)


# ------------------------ the two engines side by side ----------------------

def test_engines_agree_on_one_saved_plan(tmp_path):
    """A reference plan saved with batch_size=4 serves the same ragged
    waves through the reference's engine (jax) and the port's (torch)."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    m_ref = ref_prune(w, 0.15)
    ref_plan = repro.compile(m_ref, repro.Target(batch_size=4),
                             graph=REF_GRAPH)
    path = tmp_path / "p.plan.npz"
    ref_plan.save(path)
    port_plan = repro_torch.load_plan(path)          # jax -> torch
    assert port_plan.target.backend == "torch"
    m = prune_magnitude(w, 0.15)
    ref_eng = RefEngine(RefExecutor(repro.load_plan(path), m_ref))
    eng = SpmvEngine(PlanExecutor(port_plan, m))
    xs = rng.standard_normal((23, 40)).astype(np.float32)
    for lo, hi in ((0, 13), (13, 18), (18, 19), (19, 21), (21, 23)):
        want = [RefRequest(i, xs[i]) for i in range(lo, hi)]
        got = [MatvecRequest(i, xs[i]) for i in range(lo, hi)]
        ref_eng.run(want)
        out = eng.run(got)
        assert out["failed"] == 0 and out["dropped"] == 0
        for a, b in zip(got, want):
            assert a.status == b.status == "ok"
            _ok(a.y, np.asarray(b.y, np.float64))
            _ok(a.y, m.spmv_dense_oracle(a.x))
    assert eng.completed == ref_eng.completed == 23


# ------------------------------ hot-swap ------------------------------------

def test_plan_hot_swap_under_load(tmp_path, matrix, plan):
    store = repro_torch.PlanStore(tmp_path)
    store.put(matrix, TORCH, None, None, plan)
    ex = PlanExecutor(plan, matrix, watch=store.watch(matrix, TORCH))
    eng = SpmvEngine(ex)
    dense = matrix.to_dense()

    def wave(rid0, n):
        reqs = _reqs(matrix.n_cols, n, seed=rid0, rid0=rid0)
        for r in reqs:
            eng.enqueue(r)
        while eng.queue:
            eng.step()
        for r in reqs:
            assert r.status == "ok"
            _ok(r.y, dense @ r.x)

    wave(0, 9)
    assert eng.hot_swaps == 0
    better = repro_torch.compile(matrix, TORCH, graph=SEG_GRAPH)
    store.put(matrix, TORCH, None, None, better)
    wave(9, 9)
    assert eng.hot_swaps == 1 and ex.swap_count == 1
    assert ex.plan.spec_json == better.spec_json


def test_plan_watch_poll_semantics(tmp_path, matrix, plan):
    store = repro_torch.PlanStore(tmp_path)
    store.put(matrix, TORCH, None, None, plan)
    watch = store.watch(matrix, TORCH)
    assert watch.poll() is None          # stamp taken at creation
    store.put(matrix, TORCH, None, None, plan)
    reloaded = watch.poll()
    assert reloaded is not None and reloaded.spec_json == plan.spec_json
    assert watch.poll() is None
    target8 = repro_torch.Target(backend="torch", batch_size=8)
    early = store.watch(matrix, target8)
    assert early.poll() is None
    store.put(matrix, target8, None, None,
              repro_torch.compile(matrix, target8, graph=_DEFAULT_GRAPH))
    assert early.poll() is not None


def test_plan_store_hit_verify_repair_suggest(tmp_path, matrix):
    store = repro_torch.PlanStore(tmp_path)
    first = repro_torch.compile(matrix, TORCH, graph=_DEFAULT_GRAPH,
                                store=store)
    hit = repro_torch.compile(matrix, TORCH, graph=_DEFAULT_GRAPH,
                              store=store)
    assert store.hits == 1 and store.misses == 1
    assert hit.spec_json == first.spec_json
    for k, a in first.fmt.items():
        assert torch.equal(a, hit.fmt[k])
    suggested = store.suggest(matrix)
    assert suggested is not None
    assert suggested.label() == _DEFAULT_GRAPH.label()
    assert store.verify()["corrupt"] == []
    path = next(tmp_path.glob("*.plan.npz"))
    path.write_bytes(path.read_bytes()[:100])
    assert len(store.verify()["corrupt"]) == 1
    assert store.repair() == [path.name[:-len(".plan.npz")]]
    assert not path.exists() and (tmp_path / "quarantine" / path.name).exists()
    again = repro_torch.compile(matrix, TORCH, graph=_DEFAULT_GRAPH,
                                store=store)
    assert again.spec_json == first.spec_json and store.misses == 2


def test_searched_compile_through_store_warm_starts(tmp_path, matrix):
    """A second matrix with the same statistics gets the stored winner as
    its warm start; both plans serve (n_cols, 4) batches correctly."""
    store = repro_torch.PlanStore(tmp_path)
    cfg = repro_torch.SearchConfig(max_seconds=4, max_structures=1,
                                   coarse_samples=1, timing_repeats=1,
                                   use_cost_model=False, seed=0)
    p1 = repro_torch.compile(matrix, TORCH, budget=cfg, store=store)
    other = banded_matrix(64, 4, seed=1)
    assert store.suggest(other) is not None
    p2 = repro_torch.compile(other, TORCH, budget=cfg, store=store)
    assert any(r.structure == "warm" for r in p2.search_result.records
               + p2.search_result.failed_records)
    x = np.random.default_rng(2).standard_normal(
        (matrix.n_cols, 4)).astype(np.float32)
    _ok(p1(x), matrix.spmm_dense_oracle(x))
    _ok(p2(x), other.spmm_dense_oracle(x))


def test_swap_rollback_on_wrong_plan(matrix):
    ex = PlanExecutor(repro_torch.compile(matrix, TORCH, graph=_DEFAULT_GRAPH),
                      matrix)
    ex.warmup()
    bad = repro_torch.compile(matrix, TORCH, graph=_DEFAULT_GRAPH)
    bad.fmt = {k: (v + 1.0 if v.dtype == torch.float32 else v)
               for k, v in bad.fmt.items()}
    with pytest.raises(SwapRejected):
        ex.swap_plan(bad)
    assert ex.rejected_swaps == 1 and ex.swap_count == 0
    x = np.ones((1, matrix.n_cols), np.float32)
    _ok(ex.execute(x)[0], matrix.spmv_dense_oracle(x[0]))
    stale = repro_torch.compile(matrix, TORCH, graph=_DEFAULT_GRAPH)
    ex.plan.plan_version = 2
    with pytest.raises(SwapRejected, match="stale"):
        ex.swap_plan(stale)
    stale.plan_version = 2
    ex.swap_plan(stale)
    assert ex.swap_count == 1 and ex.rejected_swaps == 2


def test_maybe_reload_rejects_bad_store_entry(tmp_path, matrix, plan):
    store = repro_torch.PlanStore(tmp_path)
    store.put(matrix, TORCH, None, None, plan)
    ex = PlanExecutor(plan, matrix, watch=store.watch(matrix, TORCH))
    bad = repro_torch.compile(matrix, TORCH, graph=_DEFAULT_GRAPH)
    bad.fmt = {k: (v * -1.0 if v.dtype == torch.float32 else v)
               for k, v in bad.fmt.items()}
    store.put(matrix, TORCH, None, None, bad)
    with pytest.warns(RuntimeWarning, match="spot-check"):
        assert ex.maybe_reload() is False
    assert ex.rejected_swaps == 1 and ex.plan is plan


def test_apply_update_and_reference_matrix(matrix, plan):
    """An in-place update is adopted against the matrix it encodes; a
    plan for another matrix fails the spot-check against the current
    reference, and passes once the reference moves to that matrix."""
    ex = PlanExecutor(plan, matrix)
    other = banded_matrix(64, 4, seed=3)
    other_plan = repro_torch.compile(other, TORCH, graph=_DEFAULT_GRAPH)
    with pytest.raises(SwapRejected):
        ex.swap_plan(other_plan)
    ex.set_reference_matrix(other)
    ex.swap_plan(other_plan)
    assert ex.swap_count == 1
    ex.apply_update(plan, matrix=matrix)
    assert ex.update_count == 1 and ex.plan is plan
    x = np.ones((1, matrix.n_cols), np.float32)
    _ok(ex.execute(x)[0], matrix.spmv_dense_oracle(x[0]))


def test_corrupt_store_entry_recompiles(tmp_path, matrix):
    store = repro_torch.PlanStore(tmp_path)
    repro_torch.compile(matrix, TORCH, graph=_DEFAULT_GRAPH, store=store)
    path = next(tmp_path.glob("*.plan.npz"))
    path.write_bytes(path.read_bytes()[:-64])
    with pytest.warns(RuntimeWarning, match="unusable"):
        plan = repro_torch.compile(matrix, TORCH, graph=_DEFAULT_GRAPH,
                                   store=store)
    assert store.hits == 0 and store.misses == 2
    x = np.ones(matrix.n_cols, np.float32)
    _ok(plan(x), matrix.spmv_dense_oracle(x))
    assert store.verify()["corrupt"] == []      # the recompile rewrote it


def test_execute_chunks_wide_batches(matrix, plan):
    ex = PlanExecutor(plan, matrix)
    xs = np.random.default_rng(3).standard_normal(
        (11, matrix.n_cols)).astype(np.float32)
    ys = ex.execute(xs)
    assert ys.shape == (11, matrix.n_rows) and ys.dtype == np.float32
    _ok(ys, xs.astype(np.float64) @ matrix.to_dense().T)


# ------------------------- degraded-mode serving ----------------------------

def test_backpressure_and_deadline_responses(matrix, plan):
    eng = SpmvEngine(PlanExecutor(plan, matrix), max_queue=4)
    reqs = _reqs(matrix.n_cols, 10)
    admitted = [r for r in reqs if eng.enqueue(r)]
    rejected = [r for r in reqs if r.status == "rejected"]
    assert len(admitted) == 4 and len(rejected) == 6
    assert all(r.retry_after_s is not None and r.error for r in rejected)
    expired = MatvecRequest(99, np.ones(matrix.n_cols, np.float32),
                            deadline_s=1e-4)
    eng.step()
    assert eng.enqueue(expired)
    time.sleep(0.01)
    stats = eng.run([])
    assert expired.status == "timeout" and expired.error
    assert stats["dropped"] == 0
    assert stats["rejected"] == 6 and stats["timed_out"] == 1
    for r in admitted:
        assert r.status == "ok"
        _ok(r.y, matrix.spmv_dense_oracle(r.x))


def test_retry_recovers_and_health_heals(matrix, plan):
    ex = PlanExecutor(plan, matrix)
    eng = SpmvEngine(ex, max_retries=2, retry_backoff_s=0.001, heal_after=2)
    orig, calls = ex.execute, {"n": 0}

    def flaky(xs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient")
        return orig(xs)

    ex.execute = flaky
    r = MatvecRequest(0, np.ones(matrix.n_cols, np.float32))
    eng.enqueue(r)
    eng.step()
    assert r.status == "ok" and eng.health == "degraded"
    assert eng.recovery_latencies and eng.recovery_latencies[0] > 0
    ex.execute = orig
    for i in range(2):
        eng.enqueue(MatvecRequest(1 + i, np.ones(matrix.n_cols, np.float32)))
        eng.step()
    assert eng.health == "healthy"


def test_exhausted_retries_fail_explicitly(matrix, plan):
    ex = PlanExecutor(plan, matrix)
    eng = SpmvEngine(ex, max_retries=1, retry_backoff_s=0.001)

    def dead(xs):
        raise RuntimeError("permanent")

    ex.execute = dead
    r = MatvecRequest(0, np.ones(matrix.n_cols, np.float32))
    eng.enqueue(r)
    out = eng.step()
    assert r in out and r.status == "failed" and "permanent" in r.error
    assert eng.health == "failed" and eng.failed == 1
    stats = eng.run([])
    assert stats["failed"] == 1 and stats["dropped"] == 0


def test_ft_heartbeats_flag_stuck_steps(matrix, plan):
    ft = FaultToleranceManager()
    ex = PlanExecutor(plan, matrix)
    eng = SpmvEngine(ex, ft=ft)
    for r in _reqs(matrix.n_cols, 12):
        eng.enqueue(r)
        eng.step()
    orig = ex.execute

    def slow(xs):
        time.sleep(0.25)
        return orig(xs)

    ex.execute = slow
    eng.enqueue(MatvecRequest(99, np.ones(matrix.n_cols, np.float32)))
    eng.step()
    assert eng.stuck_steps >= 1 and eng.health == "degraded"
    assert ft.stragglers()


def test_research_monitor_is_pumped(matrix, plan):
    class Monitor:
        ticks = 0

        def watchdog_tick(self):
            self.ticks += 1
            return "restarted" if self.ticks == 1 else None

        def stats(self):
            return {"research_dead": self.ticks >= 2}

    ex = PlanExecutor(plan, matrix)
    mon = Monitor()
    ex.attach_research_monitor(mon)
    assert ex.maybe_reload() is False and ex.research_alerts == 1
    with pytest.warns(RuntimeWarning, match="struck out"):
        ex.maybe_reload()
    assert mon.ticks == 2


def test_spmv_engine_async_loop(matrix, plan):
    eng = SpmvEngine(PlanExecutor(plan, matrix), max_queue=100)
    xs = [r.x for r in _reqs(matrix.n_cols, 6, seed=13)]

    async def main():
        server = asyncio.ensure_future(eng.serve_forever())
        futs = [eng.submit_async(x) for x in xs]
        ys = await asyncio.wait_for(asyncio.gather(*futs), timeout=60)
        eng.shutdown()
        await server
        return ys

    for x, y in zip(xs, asyncio.run(main())):
        _ok(y, matrix.spmv_dense_oracle(x))


# --------------------------------- ft copy ----------------------------------

def test_ft_manager_copy_matches_reference():
    clock = {"t": 0.0}
    now = lambda: clock["t"]                                  # noqa: E731
    mgrs = [cls(cfg(heartbeat_timeout_s=5.0), clock=now)
            for cls, cfg in ((FaultToleranceManager, FaultToleranceConfig),
                             (RefFTManager, RefFTConfig))]
    times = [0.1, 0.11, 0.09, 0.1, 0.12, 0.1, 0.095, 0.105, 0.1, 0.5, 0.1]
    for step, dt in enumerate(times):
        clock["t"] += dt
        reps = [m.observe_step("n0", step, dt) for m in mgrs]
        assert (reps[0] is None) == (reps[1] is None)
        if reps[0] is not None:
            assert reps[0].z_score == pytest.approx(reps[1].z_score)
    for m in mgrs:
        m.register("n1")
        m.report_component("dyn-research", False, "boom")
    clock["t"] += 10.0
    got, want = mgrs
    assert got.dead_nodes() == want.dead_nodes() == ["n0", "n1"]
    assert got.should_restart() and want.should_restart()
    assert got.degraded_components() == want.degraded_components()
    assert got.elastic_plan(3, 4) == want.elastic_plan(3, 4)
    assert len(got.stragglers()) == len(want.stragglers()) == 1
