"""``repro_torch.corpus`` against ``repro.corpus``: tests/test_corpus.py case
for case on the port (``torch`` backend, the reference's smoke sizes and
``_TINY`` budget), then parity on the same inputs:

* corpus entries, fingerprints and built matrices are bit-identical;
* a store and journal written by the reference's ``run_sweep`` train, in
  the port, a ``CorpusModel`` with the same fingerprint, label ranking and
  suggested graphs;
* a journal line written by either package loads in the other;
* ``PortfolioStrategy.propose`` on the same store, model and seed proposes
  the same graphs.

Plans are held to the float64 oracle within ``1e-4 * max|oracle|``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np
import pytest

import repro
import repro.corpus.datasets as ref_datasets
from repro.core.search import SearchConfig as RefSearchConfig
from repro.core.search import _graph_to_jsonable as ref_graph_to_jsonable
from repro.corpus.model import train_from_store as ref_train_from_store
from repro.corpus.sweep import SweepRecord as RefSweepRecord
from repro.corpus.sweep import load_records as ref_load_records
from repro.corpus.sweep import run_sweep as ref_run_sweep

import repro_torch
from repro_torch.core.cost_model import (GBTRegressor, gbt_from_arrays,
                                         gbt_to_arrays)
from repro_torch.core.matrices import (banded_matrix, powerlaw_matrix,
                                       random_uniform_matrix)
from repro_torch.core.search import SearchConfig, _graph_to_jsonable
from repro_torch.corpus.datasets import (CORPUS_FAMILIES, CorpusEntry,
                                         holdout_corpus, load_suitesparse,
                                         register_family, suitesparse_entry,
                                         synthetic_corpus)
from repro_torch.corpus.features import CORPUS_FEATURE_NAMES, matrix_features
from repro_torch.corpus.model import (CorpusModel, PSEUDO_LABELS,
                                      default_model_path, structure_label_of,
                                      train_from_store)
from repro_torch.corpus.sweep import (RECORDS_FILENAME, SweepRecord,
                                      load_records, run_sweep, training_rows)

ROOT = Path(__file__).resolve().parents[1]
TORCH = repro_torch.Target(backend="torch")

# per-compile budget for the sweep fixture: coarse-only, no cost model,
# so every structure walk is timing-independent and seconds-cheap
_TINY = SearchConfig(max_seconds=15, max_structures=2, coarse_samples=1,
                     fine_eval_budget=0, timing_repeats=1,
                     use_cost_model=False, seed=0)
_REF_TINY = RefSearchConfig(**dataclasses.asdict(_TINY))


def _assert_correct(m, plan, rtol=1e-4):
    x = np.random.default_rng(0).standard_normal(m.n_cols).astype(np.float32)
    oracle = m.spmv_dense_oracle(x)
    y = plan(x).numpy()
    scale = np.abs(oracle).max() + 1e-30
    np.testing.assert_allclose(y, oracle, atol=rtol * scale, rtol=0)


def _record(**kw):
    base = dict(name="a", n_rows=1, n_cols=1, nnz=1, features=[],
                label_times={}, label=None, graph=None, gflops=None,
                wall_seconds=0.0, n_evaluations=0, failure_counts={})
    base.update(kw)
    return SweepRecord(**base)


# ------------------------------- datasets -----------------------------------

def test_corpus_registry_and_determinism():
    a = synthetic_corpus("smoke")
    b = synthetic_corpus("smoke")
    assert a == b and len(a) == 10
    assert all(e.family in CORPUS_FAMILIES for e in a)
    m1, m2 = a[0].build(), a[0].build()
    assert np.array_equal(m1.rows, m2.rows)
    assert np.array_equal(m1.cols, m2.cols)
    np.testing.assert_array_equal(m1.vals, m2.vals)
    # holdout never collides with a training entry
    assert not {e.name for e in holdout_corpus("smoke")} & {e.name for e in a}
    with pytest.raises(ValueError, match="unknown corpus scale"):
        synthetic_corpus("galactic")


@register_family("_test_unavailable")
def _unavailable(seed: int = 0):
    return None   # stands in for an offline SuiteSparse entry


def test_suitesparse_reads_the_cache_and_degrades_without_it(tmp_path):
    """The loader never fetches: a cached .mtx loads, a missing one warns
    and gives None (what the reference does offline)."""
    m = powerlaw_matrix(40, 30, 4.0, 1.0, seed=5)
    (tmp_path / "G").mkdir()
    from repro_torch.core.matrices import write_matrix_market
    write_matrix_market(m, str(tmp_path / "G" / "tiny.mtx"))
    entry = suitesparse_entry("G", "tiny", cache_dir=tmp_path)
    got = entry.build()
    assert (got.n_rows, got.n_cols, got.nnz) == (m.n_rows, m.n_cols, m.nnz)
    assert entry.name == "ss_G_tiny" and entry.family == "suitesparse"
    with pytest.warns(UserWarning, match="unavailable"):
        assert load_suitesparse("G", "absent", cache_dir=tmp_path) is None
    with pytest.warns(UserWarning, match="unavailable"):
        assert suitesparse_entry("G", "absent",
                                 cache_dir=tmp_path).build() is None


# ------------------------------- features -----------------------------------

def test_matrix_features_contract():
    regular = banded_matrix(300, 3, seed=12)
    irregular = powerlaw_matrix(400, 350, 6.0, 1.0, seed=11)
    phi = matrix_features(regular)
    assert phi.shape == (len(CORPUS_FEATURE_NAMES),)
    assert np.all(np.isfinite(phi))
    np.testing.assert_array_equal(phi, matrix_features(regular))
    # a banded and a power-law matrix must be distinguishable
    assert not np.array_equal(phi, matrix_features(irregular))


def test_structure_label_of_matches_structure_labels():
    """The model's label vocabulary (rebuilt from stored bound graphs)
    must be exactly the Structure.label() strings strategies propose."""
    from repro_torch.design.space import DesignSpace
    space = DesignSpace(random_uniform_matrix(256, 256, 0.02, seed=13),
                        SearchConfig())
    checked = 0
    for s in space.structures()[:6]:
        for g in space.bind(s, "coarse")[:1]:
            assert structure_label_of(g) == s.label()
            checked += 1
    assert checked >= 3


# ----------------------------- GBT persistence ------------------------------

def test_gbt_arrays_roundtrip_bit_exact():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((64, 5))
    y = 2.0 * X[:, 0] + np.sin(X[:, 1])
    gbt = GBTRegressor(n_trees=8, max_depth=3).fit(X, y)
    clone = gbt_from_arrays(gbt_to_arrays(gbt))
    np.testing.assert_array_equal(gbt.predict(X), clone.predict(X))


# ------------------------- sweep + model pipeline ---------------------------

@pytest.fixture(scope="module")
def warm_store(tmp_path_factory):
    """Sweep 3 tiny matrices (+1 unavailable entry) into a fresh store on
    the torch backend, then train + save the corpus model next to it."""
    store_dir = tmp_path_factory.mktemp("corpus-store")
    store = repro_torch.PlanStore(store_dir)
    entries = synthetic_corpus("smoke")[:3]
    entries.append(CorpusEntry(name="offline", family="_test_unavailable",
                               params=()))
    recs = run_sweep(entries, store, budget=_TINY, target=TORCH)
    model = train_from_store(store_dir)
    model.save(default_model_path(store_dir))
    return store, store_dir, entries, recs, model


def test_sweep_fills_store_and_records(warm_store):
    store, store_dir, entries, recs, _ = warm_store
    assert len(recs) == 3                       # unavailable entry skipped
    assert not any(r.error for r in recs)
    assert all(r.label and r.graph for r in recs)
    assert len(list(store_dir.glob("*.stats.json"))) == 3
    # records round-trip through the JSONL file
    loaded = load_records(store_dir / RECORDS_FILENAME)
    assert [r.name for r in loaded] == [r.name for r in recs]
    rows = training_rows(loaded)
    assert rows and all(lab not in PSEUDO_LABELS for _, lab, _ in rows)
    assert all(slow >= 1.0 for *_, slow in rows)


def test_model_train_save_load_fingerprint(warm_store):
    _, store_dir, entries, _, model = warm_store
    assert model.labels and len(model.exemplar_labels) == 3
    clone = CorpusModel.load(default_model_path(store_dir))
    assert clone.fingerprint() == model.fingerprint()
    phi = matrix_features(entries[0].build())
    assert model.rank_labels(phi) == clone.rank_labels(phi)
    graphs = model.suggest_graphs(phi, k=2)
    assert 1 <= len(graphs) <= 2
    assert len({lab for lab, _ in graphs}) == len(graphs)


def test_model_gbt_path_and_fallback():
    rng = np.random.default_rng(1)
    feats = [rng.standard_normal(len(CORPUS_FEATURE_NAMES)) for _ in range(6)]
    exemplars = [(feats[i], "A" if i % 2 else "B", {"g": i}, 1.0)
                 for i in range(6)]
    # label "B" always 2x slower: the GBT must learn to rank "A" first
    rows = [(f, lab, 1.0 if lab == "A" else 2.0)
            for f in feats for lab in ("A", "B")]
    model = CorpusModel.fit(rows, exemplars)
    assert model.gbt is not None and model.mad is not None
    assert model.rank_labels(feats[0])[0][1] == "A"
    # too few rows -> nearest-exemplar fallback, still ranks all labels
    small = CorpusModel.fit(rows[:2], exemplars)
    assert small.gbt is None
    assert {lab for _, lab in small.rank_labels(feats[0])} == {"A", "B"}
    # fingerprints are content hashes: different training data differs
    assert model.fingerprint() != small.fingerprint()


def test_train_from_empty_store_raises(tmp_path):
    with pytest.raises(ValueError, match="no exemplars"):
        train_from_store(tmp_path)


# --------------------------- strategies end-to-end --------------------------

def test_learned_and_portfolio_registered():
    from repro_torch.corpus.portfolio import PortfolioStrategy
    from repro_torch.design.strategies import (LearnedStrategy,
                                               STRATEGY_REGISTRY,
                                               make_strategy)
    assert "learned" in STRATEGY_REGISTRY
    assert isinstance(make_strategy("learned"), LearnedStrategy)
    # "portfolio" resolves through the lazy corpus module hook
    assert isinstance(make_strategy("portfolio"), PortfolioStrategy)


def test_compile_learned_strategy_correct(warm_store):
    store, _, _, _, _ = warm_store
    m = holdout_corpus("smoke")[0].build()
    plan = repro_torch.compile(m, TORCH, budget=_TINY, strategy="learned",
                               store=store)
    _assert_correct(m, plan)
    res = plan.search_result
    assert res is not None and res.strategy_name == "learned"


def test_compile_portfolio_reuse_fast_path(warm_store):
    """Same matrix as a swept entry, different strategy key: the store
    misses on the exact key but suggest() reuse hits at distance 0, so
    the anneal refinement is skipped and the compile stays tiny."""
    store, _, entries, _, _ = warm_store
    m = entries[0].build()
    plan = repro_torch.compile(m, TORCH, budget=_TINY, strategy="portfolio",
                               store=store)
    _assert_correct(m, plan)
    res = plan.search_result
    assert res is not None and res.strategy_name == "portfolio"
    # the suggested graph is timed exactly once: either as compile()'s
    # automatic "warm" start or as the portfolio's own "reuse" proposal
    # (whichever runs first memoises the other)
    assert any(r.structure in ("warm", "reuse") for r in res.records)
    # reuse + learned predictions only — no full walk behind them
    assert res.n_evaluations <= 16


# ---------------------- fleet sweeps: resume + fault domains ----------------

def test_entry_fingerprint_deterministic():
    a = synthetic_corpus("smoke")
    fps = [e.fingerprint() for e in a]
    assert fps == [e.fingerprint() for e in synthetic_corpus("smoke")]
    assert len(set(fps)) == len(fps)            # resume keys never collide
    assert all(len(fp) == 16 for fp in fps)
    # the key is content-derived, not positional: same params => same key
    assert a[0].fingerprint() == dataclasses.replace(a[0]).fingerprint()


def test_load_records_tolerates_torn_tail_silently(tmp_path):
    """A kill -9 mid-append leaves one partial final line with no trailing
    newline — the expected crash shape, loaded without complaint."""
    rec = _record(fingerprint="f" * 16)
    p = tmp_path / RECORDS_FILENAME
    p.write_text(rec.to_json() + "\n" + rec.to_json()[:37])   # torn append
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loaded = load_records(p)
    assert [r.name for r in loaded] == ["a"]


def test_load_records_warns_on_malformed_interior_lines(tmp_path):
    rec = _record()
    p = tmp_path / RECORDS_FILENAME
    p.write_text("{corrupt\n" + rec.to_json() + "\nalso not json\n")
    with pytest.warns(UserWarning, match="2 malformed journal line"):
        loaded = load_records(p)
    assert [r.name for r in loaded] == ["a"]
    # warn=False (the resume path) stays silent on the same file
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert len(load_records(p, warn=False)) == 1


def test_run_sweep_resume_skips_journaled_entries(warm_store):
    """Resuming over an already-complete journal is a no-op: zero compiles,
    zero new journal lines."""
    store, store_dir, entries, _, _ = warm_store
    path = store_dir / RECORDS_FILENAME
    n_lines = path.read_text().count("\n")
    recs = run_sweep(entries, store, budget=_TINY, target=TORCH, resume=True)
    assert recs == []
    assert path.read_text().count("\n") == n_lines


def test_run_sweep_retries_transient_failures(tmp_path, monkeypatch):
    import repro_torch.api as api_mod
    calls = {"n": 0}

    def flaky_compile(*a, **kw):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError(f"transient #{calls['n']}")
        return types.SimpleNamespace(search_result=None, search_gflops=None,
                                     graph_json=None)

    monkeypatch.setattr(api_mod, "compile", flaky_compile)
    store = types.SimpleNamespace(cache_dir=tmp_path)
    entry = synthetic_corpus("smoke")[0]
    t0 = time.perf_counter()
    recs = run_sweep([entry], store, budget=_TINY, retries=3,
                     retry_backoff_s=0.01)
    assert time.perf_counter() - t0 < 30
    assert calls["n"] == 3
    assert len(recs) == 1 and recs[0].error is None
    assert recs[0].attempts == 3
    # the journal holds ONE line for the entry, not one per attempt
    loaded = load_records(tmp_path / RECORDS_FILENAME)
    assert len(loaded) == 1 and loaded[0].attempts == 3

    # exhausted retries surface the last error, still exactly one record
    calls["n"] = -10   # never reaches 3: every attempt raises
    recs = run_sweep([entry], store, budget=_TINY, retries=2,
                     retry_backoff_s=0.01)
    assert recs[0].error and "transient" in recs[0].error
    assert recs[0].attempts == 3                # 1 + 2 retries


def test_run_sweep_isolate_mode_validation(tmp_path):
    store = types.SimpleNamespace(cache_dir=tmp_path)
    with pytest.raises(ValueError, match="unknown isolate mode"):
        run_sweep([], store, isolate="thread")
    with pytest.raises(ValueError, match="strategy \\*name\\*"):
        run_sweep([], store, isolate="process",
                  strategy=object())


def test_run_sweep_isolated_child_compiles_into_the_store(tmp_path):
    """isolate="process": the child (repro_torch.corpus.sweep's own
    entry point) compiles into the shared store and hands its record
    back; the parent journals it."""
    store = repro_torch.PlanStore(tmp_path)
    entry = synthetic_corpus("smoke")[3]
    recs = run_sweep([entry], store, budget=_TINY, target=TORCH,
                     isolate="process")
    assert len(recs) == 1 and recs[0].error is None, recs[0].error
    assert recs[0].fingerprint == entry.fingerprint() and recs[0].label
    assert len(list(tmp_path.glob("*.stats.json"))) == 1
    assert [r.name for r in load_records(tmp_path / RECORDS_FILENAME)] == [
        entry.name]


# The child journals its first entry and then waits in its progress hook,
# so the kill always lands with the sweep in flight.
_KILL_SWEEP_SCRIPT = """
import sys, time
import repro_torch
from repro_torch.core.search import SearchConfig
from repro_torch.corpus.datasets import synthetic_corpus
from repro_torch.corpus.sweep import run_sweep

budget = SearchConfig(max_seconds=15, max_structures=2, coarse_samples=1,
                      fine_eval_budget=0, timing_repeats=1,
                      use_cost_model=False, seed=0)
run_sweep(synthetic_corpus("smoke")[:3], repro_torch.PlanStore(sys.argv[1]),
          budget=budget, target=repro_torch.Target(backend="torch"),
          progress=lambda msg: time.sleep(120))
"""


def test_sweep_sigkill_then_resume_no_duplicates(tmp_path):
    """kill -9 a live sweep, resume, and verify the journal — every entry
    present exactly once, only the un-journaled tail re-swept."""
    import signal
    store_dir = tmp_path / "store"
    journal = store_dir / RECORDS_FILENAME
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL_SWEEP_SCRIPT, str(store_dir)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env)
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            if journal.is_file() and journal.read_text().count("\n") >= 1:
                break
            if proc.poll() is not None:
                raise RuntimeError("sweep child exited before it could "
                                   "be killed mid-run")
            time.sleep(0.05)
        else:
            raise RuntimeError("sweep child never journaled an entry")
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.kill()
        proc.wait()
    before = load_records(journal, warn=False)
    n_before = len(before)
    assert 1 <= n_before < 3, "child must die with the sweep in flight"

    entries = synthetic_corpus("smoke")[:3]
    store = repro_torch.PlanStore(store_dir)
    resumed = run_sweep(entries, store, budget=_TINY, target=TORCH,
                        resume=True)
    assert len(resumed) == len(entries) - n_before
    assert not any(r.error for r in resumed)

    after = load_records(journal)          # warn=True: journal must be clean
    assert len(after) == len(entries)
    fps = [r.fingerprint for r in after]
    assert len(set(fps)) == len(fps), "resume must never duplicate a record"
    assert set(fps) == {e.fingerprint() for e in entries}


# --------------------------- parity with repro ------------------------------

@pytest.mark.parametrize("scale", ["smoke", "small", "medium"])
def test_entries_and_matrices_bit_identical_to_reference(scale):
    for ours, ref in ((synthetic_corpus(scale),
                       ref_datasets.synthetic_corpus(scale)),
                      (holdout_corpus(scale),
                       ref_datasets.holdout_corpus(scale))):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            assert (a.name, a.family, a.params, a.seed) == (
                b.name, b.family, b.params, b.seed)
            assert a.fingerprint() == b.fingerprint()
            ma, mb = a.build(), b.build()
            assert (ma.n_rows, ma.n_cols) == (mb.n_rows, mb.n_cols)
            for f in ("rows", "cols", "vals"):
                x, y = getattr(ma, f), getattr(mb, f)
                assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.fixture(scope="module")
def ref_store(tmp_path_factory):
    """A store and journal written by the reference's run_sweep (its jax
    backend on the CPU), with the reference's model trained from it."""
    store_dir = tmp_path_factory.mktemp("ref-corpus-store")
    ref_run_sweep(ref_datasets.synthetic_corpus("smoke")[:3],
                  repro.PlanStore(store_dir), budget=_REF_TINY)
    return store_dir, ref_train_from_store(store_dir)


def test_reference_store_trains_the_same_model(ref_store):
    store_dir, ref_model = ref_store
    model = train_from_store(store_dir)
    assert model.fingerprint() == ref_model.fingerprint()
    assert model.labels == ref_model.labels
    for e in synthetic_corpus("smoke") + holdout_corpus("smoke"):
        phi = matrix_features(e.build())
        assert model.rank_labels(phi) == ref_model.rank_labels(phi)
        assert model.suggest_graphs(phi, k=3) == ref_model.suggest_graphs(
            phi, k=3)
    # the saved artifact crosses over too
    ref_model.save(store_dir / "ref_model.npz")
    assert (CorpusModel.load(store_dir / "ref_model.npz").fingerprint()
            == ref_model.fingerprint())


def test_journal_lines_load_in_both_packages(ref_store, warm_store):
    ref_journal = ref_store[0] / RECORDS_FILENAME
    ours = load_records(ref_journal)
    theirs = ref_load_records(ref_journal)
    assert len(ours) == len(theirs) == 3
    assert [dataclasses.asdict(r) for r in ours] == [
        dataclasses.asdict(r) for r in theirs]
    port_journal = warm_store[1] / RECORDS_FILENAME
    theirs = ref_load_records(port_journal)
    ours = load_records(port_journal)
    assert len(theirs) == len(ours) >= 3
    assert [dataclasses.asdict(r) for r in theirs] == [
        dataclasses.asdict(r) for r in ours]
    # one line, both directions
    rec = _record(name="x", fingerprint="0" * 16, label="L",
                  label_times={"L": 1e-3}, attempts=2)
    assert dataclasses.asdict(RefSweepRecord.from_json(rec.to_json())) == \
        dataclasses.asdict(rec)
    assert dataclasses.asdict(SweepRecord.from_json(
        RefSweepRecord.from_json(rec.to_json()).to_json())) == \
        dataclasses.asdict(rec)


def test_portfolio_proposes_the_same_graphs(ref_store):
    from repro.corpus.portfolio import PortfolioStrategy as RefPortfolio
    from repro.design.space import DesignSpace as RefSpace

    from repro_torch.corpus.portfolio import PortfolioStrategy
    from repro_torch.design.space import DesignSpace
    store_dir, ref_model = ref_store
    model = train_from_store(store_dir)
    entry = holdout_corpus("smoke")[2]
    runs = []
    for strat_cls, space_cls, store, mdl, cfg, m, to_json in (
            (PortfolioStrategy, DesignSpace, repro_torch.PlanStore(store_dir),
             model, dataclasses.replace(_TINY, backend="torch"),
             entry.build(), _graph_to_jsonable),
            (RefPortfolio, RefSpace, repro.PlanStore(store_dir), ref_model,
             _REF_TINY, ref_datasets.holdout_corpus("smoke")[2].build(),
             ref_graph_to_jsonable)):
        strat = strat_cls(store=store, model=mdl)
        space = space_cls(m, cfg)
        strat.reset(space, np.random.default_rng(cfg.seed), cfg)
        batches = []
        for _ in range(3):        # reuse, learned predictions, first walk
            props = strat.propose(space, [])
            batches.append([(p.label, json.dumps(to_json(p.graph)))
                            for p in props])
        runs.append(batches)
    assert runs[0] == runs[1]
    assert sum(len(b) for b in runs[0]) > 0
