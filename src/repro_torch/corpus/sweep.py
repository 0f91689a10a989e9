"""Budgeted corpus sweeps: fill a PlanStore, emit training records.

Port of ``repro.corpus.sweep``; the journal format is the reference's, so
a journal written by either package loads in the other. ``run_sweep``
compiles every corpus entry through ``repro_torch.compile(...,
store=...)`` under one budget, so each matrix leaves two artifacts
behind:

* the stored plan + ``*.stats.json`` sidecar (PlanStore — exemplars for
  the learned model and ``suggest()`` reuse), and
* a :class:`SweepRecord` line in ``sweep_records.jsonl`` next to the
  store: features, per-structure best timings, the winning graph,
  failure taxonomy — the relative-slowdown supervision the GBT ranks
  structures with.

Records are append-only JSONL so repeated sweeps (new scales, more
seeds) accumulate into one growing training set.

Fleet fault domains (the paper sweeps 843 matrices; a fleet-scale run is
hours long and must survive its own harness dying):

* the journal doubles as a crash-safe resume log — each record is one
  fingerprint-keyed line written with a single fsync'd append, so
  ``run_sweep(resume=True)`` after a kill -9 skips everything already
  journaled and loses at most the in-flight entry;
* a torn final line (the append that was interrupted by the kill) is
  expected and tolerated; any *other* malformed line is counted and
  warned about by :func:`load_records`;
* transient compile failures retry with bounded exponential backoff
  (``retries=``), and ``isolate="process"`` runs each compile in a
  subprocess so a segfaulting/OOMing candidate kills one entry, never
  the sweep. On a GPU this is also the fault domain of a CUDA error
  other than out-of-memory: it leaves ``compile`` (the process's CUDA
  context is unusable after it) and costs one entry. The child loads the
  kernel libraries the parent already built (their file names hash the
  sources), so it never rebuilds them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import Iterable, Optional

from repro_torch.corpus.datasets import CorpusEntry
from repro_torch.corpus.model import PSEUDO_LABELS

__all__ = ["SweepRecord", "run_sweep", "load_records", "training_rows",
           "RECORDS_FILENAME"]

RECORDS_FILENAME = "sweep_records.jsonl"


@dataclasses.dataclass
class SweepRecord:
    """Everything the trainer needs about one swept matrix."""
    name: str
    n_rows: int
    n_cols: int
    nnz: int
    features: list[float]
    label_times: dict[str, float]      # structure label -> best seconds
    label: Optional[str]               # winning structure label
    graph: Optional[dict]              # winning graph, jsonable
    gflops: Optional[float]
    wall_seconds: float
    n_evaluations: int
    failure_counts: dict[str, int]
    error: Optional[str] = None        # set when the compile itself died
    cached: bool = False               # store hit: no fresh timings
    # resume key: CorpusEntry.fingerprint(); None on pre-resume journals
    fingerprint: Optional[str] = None
    attempts: int = 1                  # 1 + retries consumed by this entry

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, line: str) -> "SweepRecord":
        d = json.loads(line)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _append_record(path: Path, rec: SweepRecord) -> None:
    """Line-atomic, durable journal append: the full line goes down in one
    ``write`` on an O_APPEND stream and is fsync'd before we move on, so a
    kill -9 leaves at most one torn *final* line (which ``load_records``
    tolerates) and never interleaves or loses an acknowledged record."""
    line = rec.to_json() + "\n"
    with open(path, "a") as f:
        f.write(line)
        f.flush()
        os.fsync(f.fileno())


def run_sweep(entries: Iterable[CorpusEntry], store, budget=None,
              target=None, strategy=None, deadline_s=None,
              records_path=None, progress=None, *, resume: bool = False,
              isolate: Optional[str] = None, retries: int = 0,
              retry_backoff_s: float = 0.25) -> list[SweepRecord]:
    """Compile each entry with the shared ``store``; append records.

    Unbuildable entries (offline SuiteSparse) are skipped; a compile
    failure becomes a record with ``error`` set rather than aborting the
    sweep — fleet harnesses must survive individual bad matrices.

    ``resume=True`` skips entries whose fingerprint already appears in
    the journal (any outcome counts as swept, errors included — rerun
    without ``resume`` to re-sweep casualties). ``retries=N`` re-attempts
    a failed compile up to N times with exponential backoff starting at
    ``retry_backoff_s``. ``isolate="process"`` runs each compile in a
    subprocess so a crashing candidate (segfault, OOM kill) costs one
    entry, not the sweep; requires a mesh-free target and a
    name/None strategy (instances don't serialize)."""
    from repro_torch.corpus.features import matrix_features

    if isolate not in (None, "process"):
        raise ValueError(f"unknown isolate mode {isolate!r}; "
                         "expected None or 'process'")
    if isolate == "process":
        if target is not None and getattr(target, "mesh", None) is not None:
            raise ValueError("isolate='process' cannot ship a live mesh to "
                             "the child; sweep with a mesh-free target")
        if strategy is not None and not isinstance(strategy, str):
            raise ValueError("isolate='process' needs a strategy *name* "
                             "(or None); instances don't serialize")

    path = (Path(records_path) if records_path
            else Path(store.cache_dir) / RECORDS_FILENAME)
    path.parent.mkdir(parents=True, exist_ok=True)
    swept_fps: set[str] = set()
    swept_names: set[str] = set()
    if resume:
        for r in load_records(path, warn=False):
            if r.fingerprint:
                swept_fps.add(r.fingerprint)
            else:
                swept_names.add(r.name)   # pre-fingerprint journal lines
    out: list[SweepRecord] = []
    for entry in entries:
        fp = entry.fingerprint()
        if resume and (fp in swept_fps or entry.name in swept_names):
            if progress:
                progress(f"{entry.name}: already swept, skipped (resume)")
            continue
        m = entry.build()
        if m is None:
            if progress:
                progress(f"{entry.name}: unavailable, skipped")
            continue
        feats = matrix_features(m).tolist()
        attempt = 0
        while True:
            if isolate == "process":
                rec = _sweep_isolated(entry, m, feats, store, budget,
                                      target, strategy, deadline_s)
            else:
                rec = _sweep_one(entry, m, feats, store, budget, target,
                                 strategy, deadline_s)
            rec.attempts = attempt + 1
            if rec.error is None or attempt >= retries:
                break
            attempt += 1
            delay = retry_backoff_s * (2 ** (attempt - 1))
            if progress:
                progress(f"{entry.name}: attempt {attempt} failed "
                         f"({rec.error}); retrying in {delay:.2f}s")
            time.sleep(delay)
        out.append(rec)
        _append_record(path, rec)
        swept_fps.add(fp)
        if progress:
            progress(f"{entry.name}: "
                     + (f"error {rec.error}" if rec.error else
                        f"{rec.gflops or 0.0:.2f} gflops in "
                        f"{rec.wall_seconds:.1f}s"
                        + (" (store hit)" if rec.cached else "")))
    return out


def _sweep_one(entry, m, feats, store, budget, target, strategy,
               deadline_s) -> SweepRecord:
    """One in-process compile attempt -> one record (never raises)."""
    from repro_torch.api import compile as _compile
    t0 = time.perf_counter()
    try:
        plan = _compile(m, target, budget, strategy=strategy,
                        deadline_s=deadline_s, store=store)
        err = None
    except Exception as e:   # keep sweeping: record the casualty
        plan, err = None, repr(e)
    wall = time.perf_counter() - t0
    return _record_for(entry, m, feats, plan, err, wall)


# ------------------------------------------------------- process isolation

_CHILD_SCRIPT = (
    "import json, sys\n"
    "payload = json.loads(sys.stdin.read())\n"
    "sys.path[:0] = payload['sys_path']\n"
    "from repro_torch.corpus.sweep import _sweep_child_main\n"
    "_sweep_child_main(payload)\n")


def _budget_to_dict(budget) -> Optional[dict]:
    return None if budget is None else dataclasses.asdict(budget)


def _budget_from_dict(d: Optional[dict]):
    if d is None:
        return None
    from repro_torch.core.search import SearchConfig
    d = dict(d)
    for k in ("tiles_per_step_choices", "dtype_choices"):
        if d.get(k) is not None:
            d[k] = tuple(d[k])       # JSON round-trips tuples as lists
    return SearchConfig(**d)


def _isolation_timeout_s(budget, deadline_s) -> float:
    # generous: the child does matrix build + full search + store save.
    if deadline_s is not None:
        return 3.0 * float(deadline_s) + 60.0
    if budget is not None:
        return 5.0 * float(budget.max_seconds) + 120.0
    return 600.0


def _sweep_isolated(entry, m, feats, store, budget, target, strategy,
                    deadline_s) -> SweepRecord:
    """Run one entry's compile in a subprocess (its own fault domain).

    The child re-builds the matrix, compiles into the shared on-disk
    store, and prints its SweepRecord JSON on the last stdout line; the
    parent keeps journal ownership (one fsync'd append per entry). Any
    child death — segfault, OOM kill, hang past the timeout — becomes an
    error record, never a crash of the sweep."""
    payload = {
        "sys_path": [p for p in sys.path if p],
        "entry": {"name": entry.name, "family": entry.family,
                  "params": [list(p) for p in entry.params],
                  "seed": entry.seed},
        "store_dir": str(store.cache_dir),
        "budget": _budget_to_dict(budget),
        "target": None if target is None else target.spec_dict(),
        "strategy": strategy,
        "deadline_s": deadline_s,
    }
    timeout = _isolation_timeout_s(budget, deadline_s)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-c", _CHILD_SCRIPT],
                              input=json.dumps(payload),
                              capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        wall = time.perf_counter() - t0
        return _record_for(entry, m, feats, None,
                           f"isolated compile timed out after {timeout:.0f}s",
                           wall)
    wall = time.perf_counter() - t0
    if proc.returncode == 0:
        lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
        if lines:
            try:
                return SweepRecord.from_json(lines[-1])
            except (ValueError, TypeError, KeyError):
                pass
        err = "isolated compile produced no record"
    elif proc.returncode < 0:
        err = f"isolated compile killed by signal {-proc.returncode}"
    else:
        err = f"isolated compile exited {proc.returncode}"
    tail = proc.stderr.strip().splitlines()[-1:]
    if tail:
        err += f" ({tail[0][:200]})"
    return _record_for(entry, m, feats, None, err, wall)


def _sweep_child_main(payload: dict) -> None:
    """Entry point of the ``isolate='process'`` child (see _CHILD_SCRIPT)."""
    from repro_torch.api import PlanStore, _target_from_dict
    from repro_torch.corpus.features import matrix_features
    e = payload["entry"]
    entry = CorpusEntry(name=e["name"], family=e["family"],
                        params=tuple(tuple(p) for p in e["params"]),
                        seed=e["seed"])
    store = PlanStore(payload["store_dir"])
    budget = _budget_from_dict(payload["budget"])
    target = (None if payload["target"] is None
              else _target_from_dict(payload["target"]))
    m = entry.build()
    if m is None:
        print(json.dumps({"unavailable": True}))
        return
    feats = matrix_features(m).tolist()
    rec = _sweep_one(entry, m, feats, store, budget, target,
                     payload["strategy"], payload["deadline_s"])
    print(rec.to_json())


# ------------------------------------------------------------------ records

def _record_for(entry, m, feats, plan, err, wall) -> SweepRecord:
    from repro_torch.core.search import _graph_to_jsonable
    from repro_torch.corpus.model import structure_label_of

    label_times: dict[str, float] = {}
    label = graph_json = gflops = None
    n_evals = 0
    failures: dict[str, int] = {}
    cached = False
    if plan is not None:
        res = getattr(plan, "search_result", None)
        gflops = getattr(plan, "search_gflops", None)
        if res is not None:
            n_evals = res.n_evaluations
            failures = dict(res.failure_counts)
            for r in res.records:
                if r.structure in PSEUDO_LABELS:
                    continue
                prev = label_times.get(r.structure)
                if prev is None or r.seconds < prev:
                    label_times[r.structure] = float(r.seconds)
            graph_json = _graph_to_jsonable(res.best_graph)
            label = structure_label_of(res.best_graph)
        else:
            cached = True   # exact store hit: plan only, no fresh timings
            gj = getattr(plan, "graph_json", None)
            if gj:
                graph_json = json.loads(gj)
    return SweepRecord(name=entry.name, n_rows=m.n_rows, n_cols=m.n_cols,
                       nnz=m.nnz, features=feats, label_times=label_times,
                       label=label, graph=graph_json, gflops=gflops,
                       wall_seconds=wall, n_evaluations=n_evals,
                       failure_counts=failures, error=err, cached=cached,
                       fingerprint=entry.fingerprint())


def load_records(path, *, warn: bool = True) -> list[SweepRecord]:
    """Read a ``sweep_records.jsonl``. Malformed lines are skipped, not
    fatal — but they are *counted* and warned about, so silent journal
    rot is visible. Exception: exactly one torn **final** line on a file
    with no trailing newline is the expected kill-9-mid-append shape
    (crash resume) and is tolerated without a warning."""
    out: list[SweepRecord] = []
    p = Path(path)
    if not p.is_file():
        return out
    text = p.read_text()
    lines = text.splitlines()
    torn_tail = bool(text) and not text.endswith("\n")
    skipped = 0
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(SweepRecord.from_json(line))
        except (ValueError, TypeError, KeyError):
            if torn_tail and i == len(lines) - 1:
                continue   # interrupted final append: expected on resume
            skipped += 1
    if skipped and warn:
        warnings.warn(
            f"{p}: skipped {skipped} malformed journal line(s) "
            "(not counting a torn final line); the journal may be "
            "corrupt beyond a crash-interrupted append", stacklevel=2)
    return out


def training_rows(records: Iterable[SweepRecord]
                  ) -> list[tuple[list[float], str, float]]:
    """Flatten records into GBT rows: (features, label, relative slowdown).

    Slowdown is each structure's best time over the matrix's overall best
    — 1.0 for the winner, >1 for the rest — so the target is comparable
    across matrices of wildly different absolute cost."""
    rows = []
    for rec in records:
        if rec.error or not rec.label_times:
            continue
        best = min(rec.label_times.values())
        if not (best > 0):
            continue
        for label, seconds in rec.label_times.items():
            rows.append((rec.features, label, seconds / best))
    return rows
