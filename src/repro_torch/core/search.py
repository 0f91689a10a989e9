"""Search Engine (paper §VI): a search loop over pluggable SearchStrategies.

Port of ``repro.core.search`` to PyTorch. What changed against the
reference: candidates are timed on the device (``x`` is copied there once
per search, and each timed call is bracketed by ``torch.cuda.synchronize``),
a CUDA out-of-memory error counts as ``oom``, and any other CUDA error
leaves the search (a CUDA fault poisons the process's context, so every
later candidate would fail too).

The three-level search (structure enumeration, coarse-grid timing, cost-
model fine-grid interpolation) used to be a closed monolith here. It is
now split along the paper's own seams:

* the *design space* — what can be searched — lives in
  ``repro_torch.design.space.DesignSpace`` (structure templates, §VI-B pruning,
  parameter binding), derived from the open operator registry;
* the *search policy* — how it is walked — is a
  ``repro_torch.design.SearchStrategy`` (``propose``/``observe`` protocol).
  ``AnnealStrategy`` is the original simulated-annealing walk extracted
  verbatim (candidate-sequence parity at fixed seed); ``GridStrategy``
  and ``CostModelGuidedStrategy`` ship alongside it;
* this module keeps the *search loop*: oracle checking, timing, memoisation,
  and the ``run_search`` loop that connects the two.

Every evaluated program is checked against the float64 dense oracle —
a generated program that is fast but wrong is a bug, not a candidate
(paper §V-D: "any errors in the model would cause incorrect SpMV").
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import signal
import threading
import time
import warnings
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.design.space import DesignSpace, Structure
from repro_torch.design.strategies import CandidateResult, make_strategy
from .cost_model import program_features
from .graph import GraphError, OperatorGraph, run_graph
from .kernel_builder import SpmvProgram, build_program, resolve_device
from .matrices import SparseMatrix

__all__ = ["SearchConfig", "SearchResult", "AlphaSparseSearch",
           "run_search", "ProgramCache", "Structure", "DesignSpace",
           "CandidateTimeout", "FAILURE_BUCKETS", "fault_hook",
           "check_candidate_deadline", "sleep_checking_deadline",
           "cooperative_deadline_available", "current_search_matrix"]


# --------------------------- failure taxonomy ------------------------------

# Machine-designed candidates can fail in ways no human-vetted format
# would; the search treats each as a data point. Buckets:
#   invalid      — GraphError/ValueError from validation or the Designer
#                  (an inapplicable design; routine, cheap, not warned)
#   wrong_result — the generated program ran but disagreed with the
#                  float64 dense oracle
#   crash        — unexpected exception while building or running that is
#                  not a CUDA error (those leave the search, see
#                  ``_is_cuda_fault``)
#   oom          — MemoryError or torch.cuda.OutOfMemoryError
#   timeout      — the candidate exceeded SearchConfig.candidate_timeout_s
#   fallback     — marker bucket: every candidate failed and the baseline
#                  program was substituted
FAILURE_BUCKETS = ("invalid", "wrong_result", "crash", "oom", "timeout",
                   "fallback")

# "hard" failures count toward structure quarantine (DesignSpace): a
# structure that keeps crashing/hanging stops being proposed. "invalid"
# does not — inapplicable designs are normal pruning residue.
_HARD_FAILURES = frozenset({"wrong_result", "crash", "oom", "timeout"})


class CandidateTimeout(RuntimeError):
    """A candidate exceeded its per-candidate wall-clock deadline."""


# Test/benchmark seam: a callable ``hook(graph, y) -> y`` applied to every
# machine-designed candidate's output inside the guarded evaluation region.
# It may raise (injected crash/OOM), sleep (injected hang — bounded by the
# candidate deadline) or return a corrupted y (injected wrong result). The
# baseline fallback program deliberately bypasses it.
_FAULT_HOOK: Optional[Callable] = None


@contextlib.contextmanager
def fault_hook(hook: Optional[Callable]):
    """Install a candidate fault-injection hook for the enclosed block
    (``benchmarks/fault_inject.py`` and the fault tests use this)."""
    global _FAULT_HOOK
    prev = _FAULT_HOOK
    _FAULT_HOOK = hook
    try:
        yield
    finally:
        _FAULT_HOOK = prev


# one process-wide warning when a deadline has no SIGALRM backstop
_WARNED_NO_BACKSTOP = False

# Per-thread stack of active candidate deadlines (monotonic instants).
# The *cooperative* half of the per-candidate timeout: every thread that
# evaluates candidates pushes its deadline here, and the evaluation
# pipeline calls ``check_candidate_deadline()`` between stages — so
# timeouts fire on ANY thread (pooled per-shard searches included), not
# just where SIGALRM can reach.
_DEADLINE_TLS = threading.local()

# Per-thread current search matrix — lets fault hooks and diagnostics
# identify *which* search (e.g. which dist shard) a candidate belongs to
# when several run concurrently on a thread pool.
_SEARCH_TLS = threading.local()


def current_search_matrix():
    """The matrix of the search evaluating candidates on this thread
    (None outside a search). Fault hooks use this to target one shard of
    a pooled ``dist_search`` without guessing from output shapes."""
    return getattr(_SEARCH_TLS, "matrix", None)


def _active_deadline() -> Optional[float]:
    stack = getattr(_DEADLINE_TLS, "stack", None)
    return stack[-1] if stack else None


def check_candidate_deadline() -> None:
    """Cooperative deadline checkpoint: raise :class:`CandidateTimeout`
    when the innermost per-candidate deadline on this thread has passed.

    Safe to call from any thread and a no-op when no deadline is active,
    so long-running evaluation stages (and injected fault hooks) can
    sprinkle it freely."""
    dl = _active_deadline()
    if dl is not None and time.monotonic() > dl:
        raise CandidateTimeout(
            "candidate exceeded its wall-clock deadline "
            "(cooperative checkpoint)")


def sleep_checking_deadline(seconds: float, interval: float = 0.01) -> None:
    """Sleep in small slices, honouring the cooperative candidate
    deadline — raises :class:`CandidateTimeout` as soon as it expires.

    This is how tests/benchmarks plant a *hanging* candidate that is
    killable on worker threads, while a raw ``time.sleep`` models a C-level
    hang only SIGALRM (main thread) can interrupt."""
    end = time.monotonic() + float(seconds)
    while True:
        check_candidate_deadline()
        left = end - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(interval, left))


def cooperative_deadline_available() -> bool:
    """Self-check that the cooperative deadline path is wired: entering
    a candidate deadline must install a checkpointable deadline on this
    thread. ``dist_search`` asserts this before pooling per-shard
    searches with a candidate timeout configured."""
    with _candidate_deadline(60.0):
        return _active_deadline() is not None


@contextlib.contextmanager
def _candidate_deadline(seconds: Optional[float]):
    """Per-candidate wall-clock guard: cooperative monotonic deadline on
    every thread, SIGALRM backstop on the main thread.

    The deadline is pushed onto a thread-local stack that
    ``check_candidate_deadline()`` consults between evaluation stages,
    so candidate timeouts fire on any thread — including pooled
    per-shard ``dist_search`` workers. On the main thread SIGALRM is
    additionally armed as a backstop for *true* hangs (a candidate stuck
    inside one long call that never reaches a checkpoint); a candidate
    stuck inside a C call is only interrupted when control returns to
    Python. Off the main thread no
    such backstop exists (warned once): a non-cooperative hang is only
    caught at the next checkpoint.

    Yields "off", "cooperative", or "cooperative+signal"."""
    if not seconds or seconds <= 0:
        yield "off"
        return
    stack = getattr(_DEADLINE_TLS, "stack", None)
    if stack is None:
        stack = _DEADLINE_TLS.stack = []
    stack.append(time.monotonic() + float(seconds))
    use_signal = (hasattr(signal, "SIGALRM")
                  and threading.current_thread() is threading.main_thread())
    if not use_signal:
        global _WARNED_NO_BACKSTOP
        if not _WARNED_NO_BACKSTOP:
            _WARNED_NO_BACKSTOP = True
            warnings.warn(
                "per-candidate deadline armed without a SIGALRM backstop "
                "(worker thread or platform without SIGALRM): cooperative "
                "checkpoints will catch overruns between evaluation "
                "stages, but a candidate hung inside one non-Python call "
                "cannot be interrupted", RuntimeWarning)
        try:
            yield "cooperative"
        finally:
            stack.pop()
        return

    def _expire(signum, frame):
        raise CandidateTimeout(
            f"candidate exceeded its {seconds:g}s wall-clock deadline")

    prev_handler = signal.signal(signal.SIGALRM, _expire)
    signal.setitimer(signal.ITIMER_REAL, float(seconds))
    try:
        yield "cooperative+signal"
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, prev_handler)
        stack.pop()


def _is_cuda_fault(exc: BaseException) -> bool:
    """A CUDA error other than out-of-memory: a failed kernel launch
    (``CudaKernelError``) or an asynchronous fault that torch reports.
    It must leave the search: the CUDA context of the process is
    unusable after a fault, so every later candidate would fail too."""
    from repro_torch.kernels.build import CudaKernelError
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    if isinstance(exc, CudaKernelError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


def _classify_failure(exc: BaseException) -> str:
    if isinstance(exc, CandidateTimeout):
        return "timeout"
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return "oom"
    if isinstance(exc, (GraphError, ValueError)):
        return "invalid"
    return "crash"


# ----------------------------- configuration ------------------------------

@dataclasses.dataclass
class SearchConfig:
    max_seconds: float = 60.0          # paper caps at 8 hours on A100
    max_structures: int = 20
    coarse_samples: int = 6            # parameter combos per structure (lvl 2)
    fine_top_structures: int = 3       # structures refined at level 3
    fine_eval_budget: int = 8          # real runs granted to level 3
    sa_temperature: float = 0.5        # simulated-annealing start temp
    sa_decay: float = 0.85
    timing_repeats: int = 3
    seed: int = 0
    use_pruning: bool = True
    use_cost_model: bool = True
    allow_branch_mix: bool = True
    backend: str = "cuda"
    check_correctness: bool = True
    # number of right-hand sides the served program will see: 1 searches the
    # classic SpMV, B > 1 evaluates (and times) the fused multi-RHS SpMM
    # path, so the winning design reflects batched reuse (format traffic
    # amortised 1/B, MXU contraction terms — see cost_model).
    batch_size: int = 1
    # SET_RESOURCES knob choices woven into every candidate structure by
    # the DesignSpace: megatile width of the fused kernels and the format
    # storage dtype. None means "auto": the space stays byte-identical to
    # the pre-knob tables (strategy golden-trace parity) unless
    # ``repro_torch.compile`` widens from the Target (cuda backend ->
    # tiles_per_step, dtype="bfloat16" -> both precisions searched per
    # matrix). An EXPLICIT tuple — including ``(1,)`` / ``("float32",)``
    # — always wins, so users can pin a knob off.
    tiles_per_step_choices: Optional[tuple] = None
    dtype_choices: Optional[tuple] = None
    # -- robustness knobs (fault-tolerant compile) --
    # wall-clock deadline per candidate: an overrunning candidate is
    # killed — cooperative monotonic checkpoints between evaluation
    # stages on ANY thread (pooled per-shard searches included), plus a
    # SIGALRM backstop on the main thread for true in-call hangs — and
    # recorded as a failed EvalRecord instead of wedging the whole
    # search. None = off.
    candidate_timeout_s: Optional[float] = None
    # hard failures (crash/oom/timeout/wrong_result) from the same
    # structure before it is quarantined and no longer proposed
    quarantine_after: int = 2
    # True removes the 2x seed-pass deadline extension so the whole search
    # (seed pass included) fits inside max_seconds — set by
    # ``repro_torch.compile(..., deadline_s=...)``
    hard_deadline: bool = False


@dataclasses.dataclass
class EvalRecord:
    graph: OperatorGraph
    seconds: float                        # math.inf for failed candidates
    features: Optional[np.ndarray]        # None for failed candidates
    structure: str
    status: str = "ok"                    # "ok" or a FAILURE_BUCKETS entry


@dataclasses.dataclass
class SearchResult:
    best_graph: OperatorGraph
    best_program: SpmvProgram
    best_seconds: float
    gflops: float
    n_evaluations: int
    n_structures: int
    wall_seconds: float
    records: list[EvalRecord]
    cost_model_mad: Optional[float]
    pruned_ops: tuple[str, ...]
    cached: bool = False          # True when served from a ProgramCache
    strategy_name: str = "anneal"  # which SearchStrategy produced this
    # -- failure accounting (robustness layer) --
    # failed candidates as EvalRecords (seconds=inf, status=bucket);
    # ``records`` stays successful-only, as before
    failed_records: list = dataclasses.field(default_factory=list)
    # taxonomy bucket -> count (see FAILURE_BUCKETS); empty for cached hits
    failure_counts: dict = dataclasses.field(default_factory=dict)
    n_quarantined: int = 0        # proposals skipped via structure quarantine
    # True when every machine-designed candidate failed and the baseline
    # baseline seed program was substituted as best
    fallback: bool = False

    @property
    def n_failed_candidates(self) -> int:
        return sum(v for k, v in self.failure_counts.items()
                   if k != "fallback")

    def is_machine_designed(self) -> bool:
        """Paper §VII-G 'creativity': graph not matching any single source
        format template (i.e. uses a combination beyond the seeded ones)."""
        names = self.best_graph.op_names()
        known = {
            ("COMPRESS", "LANE_ROW_BLOCK", "LANE_TOTAL_RED"),            # ELL
            ("COMPRESS", "SORT", "TILE_ROW_BLOCK", "LANE_ROW_BLOCK",
             "LANE_TOTAL_RED"),                                          # SELL
            ("COMPRESS", "LANE_NNZ_BLOCK", "SEG_SCAN_RED"),              # merge
        }
        return names not in known


# One lock per device: concurrent searches (the per-shard searches of
# ``repro_torch.dist`` run on a thread pool, and on a one-GPU machine all
# on one card) run and time their candidates there one at a time, so no
# candidate's time includes another search's kernels. Their host-side
# Designer and packing work still overlaps.
_DEVICE_LOCKS: dict[str, threading.Lock] = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def _device_lock(device) -> threading.Lock:
    with _DEVICE_LOCKS_GUARD:
        return _DEVICE_LOCKS.setdefault(str(device), threading.Lock())


# ------------------------------ the searcher ------------------------------

class AlphaSparseSearch:
    """The search loop: owns the oracle, timing, memo and the strategies."""

    def __init__(self, matrix: SparseMatrix, config: SearchConfig = None):
        self.m = matrix
        self.cfg = config or SearchConfig()
        self.rng = np.random.default_rng(self.cfg.seed)
        bsz = max(int(self.cfg.batch_size), 1)
        if bsz > 1:
            # multi-RHS search: candidates are checked and *timed* on the
            # SpMM kernels, so the design reflects batched execution
            self._x = self.rng.standard_normal(
                (matrix.n_cols, bsz)).astype(np.float32)
            self._oracle = matrix.spmm_dense_oracle(self._x)
        else:
            self._x = self.rng.standard_normal(
                matrix.n_cols).astype(np.float32)
            self._oracle = matrix.spmv_dense_oracle(self._x)
        # copied to the device once per search, so that the timed calls
        # measure the program and not a host-to-device copy
        self._x_dev = torch.from_numpy(self._x).to(
            resolve_device(self.cfg.backend))
        self._memo: dict[OperatorGraph, float] = {}
        self.records: list[EvalRecord] = []
        self.failed_records: list[EvalRecord] = []
        self.failure_counts: dict[str, int] = {}
        self.n_quarantined = 0
        self._best: tuple[float, OperatorGraph, SpmvProgram] = (
            math.inf, None, None)
        self.pruned_ops: tuple[str, ...] = ()
        self._design_space: Optional[DesignSpace] = None
        # wall-clock instant the whole search must finish by; set by run()
        # under cfg.hard_deadline so per-candidate deadlines shrink with
        # the time remaining (compile(deadline_s=...) guarantee)
        self._deadline_at: Optional[float] = None

    def _space(self) -> DesignSpace:
        if self._design_space is None:
            self._design_space = DesignSpace(self.m, self.cfg)
            self.pruned_ops = self._design_space.pruned_ops
        return self._design_space

    # -- failure bookkeeping ----------------------------------------------
    def _fail(self, graph: OperatorGraph, label: str, bucket: str,
              exc: Optional[BaseException] = None) -> float:
        """Record a failed candidate: memoise inf, bucket it in the
        taxonomy, append a failed EvalRecord, and feed structure
        quarantine for hard failures."""
        self._memo[graph] = math.inf
        self.failure_counts[bucket] = self.failure_counts.get(bucket, 0) + 1
        self.failed_records.append(
            EvalRecord(graph, math.inf, None, label, status=bucket))
        if bucket in _HARD_FAILURES:
            # hard failures are surfaced (they indicate generator bugs or
            # fragile lowerings, not routine inapplicability) ...
            warnings.warn(
                f"candidate {label or graph.label()} failed "
                f"[{bucket.upper()}]"
                f"{'' if exc is None else f': {exc!r}'}; recorded as "
                "failed candidate", RuntimeWarning)
            # ... and count toward quarantining their structure so repeat
            # offenders stop being proposed
            self._space().note_failure(
                label, bucket, threshold=max(self.cfg.quarantine_after, 1))
        return math.inf

    # -- level 2 evaluation: run the generated program --
    def _output(self, prog) -> np.ndarray:
        return prog(self._x_dev).cpu().numpy()

    def _time_call(self, prog) -> float:
        """Seconds of one call, from launch to the device finishing it."""
        sync = (torch.cuda.synchronize if self._x_dev.is_cuda
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        prog(self._x_dev)
        sync()
        return time.perf_counter() - t0

    def _evaluate(self, graph: OperatorGraph,
                  structure_label: str) -> float:
        if graph in self._memo:
            return self._memo[graph]
        timeout = self.cfg.candidate_timeout_s
        if self._deadline_at is not None:
            # hard search deadline: no candidate may run past it, so a
            # hang near the end cannot push the search over budget
            remaining = self._deadline_at - time.perf_counter()
            timeout = min(timeout if timeout is not None else math.inf,
                          max(remaining, 0.05))
        try:
            with _candidate_deadline(timeout):
                # cooperative checkpoints between pipeline stages: a
                # candidate that overruns is caught here on any thread;
                # the SIGALRM backstop (main thread) covers true hangs
                graph.validate()
                check_candidate_deadline()
                meta = run_graph(self.m, graph)
                check_candidate_deadline()
                prog = build_program(meta, backend=self.cfg.backend)
                check_candidate_deadline()
                with _device_lock(self._x_dev.device):
                    y = self._output(prog)
                if _FAULT_HOOK is not None:
                    hooked = _FAULT_HOOK(graph, y)
                    if hooked is not None:
                        y = np.asarray(hooked)
                check_candidate_deadline()
                if self.cfg.check_correctness:
                    scale = np.abs(self._oracle).max() + 1e-30
                    # bf16-stored candidates carry ~2^-8 relative storage
                    # rounding (accumulation is still fp32); hold them to
                    # the bf16 tolerance, not the fp32 one
                    tol = (2e-2
                           if prog.spec.get("storage_dtype") == "bfloat16"
                           else 1e-3)
                    if not np.all(np.abs(y - self._oracle)
                                  <= tol * scale + 1e-5):
                        # a wrong program is a failed candidate, not a
                        # fatal error: the search moves on
                        return self._fail(graph, structure_label,
                                          "wrong_result")
                # timing: min over repeats of a synchronised call
                best = math.inf
                with _device_lock(self._x_dev.device):
                    for _ in range(self.cfg.timing_repeats):
                        check_candidate_deadline()
                        best = min(best, self._time_call(prog))
        except (GraphError, ValueError) as e:
            # routine inapplicability (validation/Designer rejection)
            return self._fail(graph, structure_label, "invalid", e)
        except KeyboardInterrupt:
            raise
        except BaseException as e:
            if _is_cuda_fault(e):
                raise
            # everything else — MemoryError, CUDA out-of-memory, crashes
            # in the generated program, the candidate deadline — is a
            # failed candidate, never a fatal search error
            return self._fail(graph, structure_label, _classify_failure(e),
                              e)
        self._memo[graph] = best
        self.records.append(EvalRecord(graph, best,
                                       program_features(
                                           meta, prog,
                                           self.cfg.batch_size),
                                       structure_label))
        if best < self._best[0]:
            self._best = (best, graph, prog)
        return best

    # -- baseline fallback: the trusted source-format program -------------
    def _baseline_program(self):
        """Build and time the baseline source-format program (no fault
        hook, no machine-designed risk) on the search's own backend, so a
        cuda search never runs a plain version. Used when every searched
        candidate failed: ``compile()`` must still return a working plan.
        """
        space = self._space()
        last_err = None
        for structure in space.seed_structures():
            for graph in space.bind(structure, "coarse")[:3]:
                try:
                    meta = run_graph(self.m, graph)
                    prog = build_program(meta, backend=self.cfg.backend)
                    with _device_lock(self._x_dev.device):
                        y = self._output(prog)
                    if self.cfg.check_correctness:
                        scale = np.abs(self._oracle).max() + 1e-30
                        if not np.all(np.abs(y - self._oracle)
                                      <= 1e-3 * scale + 1e-5):
                            continue
                    with _device_lock(self._x_dev.device):
                        return graph, prog, self._time_call(prog)
                except (GraphError, ValueError, RuntimeError) as e:
                    if _is_cuda_fault(e):
                        raise
                    last_err = e
        raise RuntimeError(
            "search found no valid program and the baseline fallback "
            f"failed too (last error: {last_err!r})")

    # -- the loop over the SearchStrategy protocol --
    def run(self, strategy=None, warm_start=()) -> SearchResult:
        # publish this search's matrix on the evaluating thread so fault
        # hooks/diagnostics can tell concurrent (per-shard) searches apart
        prev_m = getattr(_SEARCH_TLS, "matrix", None)
        _SEARCH_TLS.matrix = self.m
        try:
            return self._run(strategy, warm_start)
        finally:
            _SEARCH_TLS.matrix = prev_m

    def _run(self, strategy, warm_start) -> SearchResult:
        strategy = make_strategy(strategy)
        t_start = time.perf_counter()
        deadline = t_start + self.cfg.max_seconds
        # seed-pass candidates are the fidelity floor (the search must never
        # lose to its own source formats): they run under an extended wall —
        # unless a hard deadline was requested (compile(deadline_s=...)),
        # where the whole search must fit inside max_seconds
        seed_factor = 1.0 if self.cfg.hard_deadline else 2.0
        seed_deadline = t_start + seed_factor * self.cfg.max_seconds
        if self.cfg.hard_deadline:
            self._deadline_at = deadline
        space = self._space()
        strategy.reset(space, self.rng, self.cfg, deadline=deadline)

        history: list[CandidateResult] = []

        def _timed(graph, label) -> CandidateResult:
            n_rec = len(self.records)
            seconds = self._evaluate(graph, label)
            feats = (self.records[-1].features
                     if len(self.records) > n_rec else None)
            return CandidateResult(graph=graph, seconds=seconds,
                                   label=label, features=feats)

        # warm start (e.g. ``PlanStore.suggest``): time the suggested
        # graph(s) first so every strategy starts from the stored winner
        for g in warm_start or ():
            if g is None:
                continue
            res = _timed(g, "warm")
            history.append(res)
            strategy.observe(res)

        stopped = False
        while not stopped:
            batch = strategy.propose(space, history)
            if not batch:
                break
            for prop in batch:
                limit = seed_deadline if prop.mandatory else deadline
                if time.perf_counter() > limit:
                    if prop.mandatory:
                        continue
                    stopped = True
                    break
                if space.is_quarantined(prop.label):
                    # repeat offender structure: don't even evaluate — the
                    # strategy still observes an inf result so it moves on
                    self.n_quarantined += 1
                    res = CandidateResult(graph=prop.graph, seconds=math.inf,
                                          label=prop.label, features=None)
                    history.append(res)
                    strategy.observe(res)
                    continue
                res = _timed(prop.graph, prop.label)
                history.append(res)
                strategy.observe(res)

        best_s, best_g, best_p = self._best
        fallback = False
        if best_g is None:
            # every machine-designed candidate failed: fall back to the
            # trusted baseline source-format program rather than dying —
            # crash-riddled searches are data points, not fatalities
            best_g, best_p, best_s = self._baseline_program()
            fallback = True
            self.failure_counts["fallback"] = 1
            warnings.warn(
                "every machine-designed candidate failed "
                f"({dict(self.failure_counts)}); returning the baseline "
                "program", RuntimeWarning)
        wall = time.perf_counter() - t_start
        # useful flops: 2*nnz per right-hand side
        gflops = 2.0 * self.m.nnz * max(self.cfg.batch_size, 1) / best_s / 1e9
        return SearchResult(best_graph=best_g, best_program=best_p,
                            best_seconds=best_s, gflops=gflops,
                            n_evaluations=len(self._memo),
                            n_structures=getattr(strategy, "n_structures", 0),
                            wall_seconds=wall,
                            records=self.records,
                            cost_model_mad=getattr(strategy,
                                                   "cost_model_mad", None),
                            pruned_ops=self.pruned_ops,
                            strategy_name=strategy.name,
                            failed_records=self.failed_records,
                            failure_counts=dict(self.failure_counts),
                            n_quarantined=self.n_quarantined,
                            fallback=fallback)


# ------------------------------ program cache ------------------------------

def _graph_to_jsonable(g: OperatorGraph) -> dict:
    spec = lambda s: [s.name, [list(kv) for kv in s.params]]
    return {"converting": [spec(s) for s in g.converting],
            "branch_chains": [[spec(s) for s in c] for c in g.branch_chains],
            "shared": g.shared}


def _graph_from_jsonable(d: dict) -> OperatorGraph:
    from repro_torch.design.registry import OpSpec
    spec = lambda e: OpSpec(e[0], tuple((k, v) for k, v in e[1]))
    return OperatorGraph(
        converting=tuple(spec(e) for e in d["converting"]),
        branch_chains=tuple(tuple(spec(e) for e in c)
                            for c in d["branch_chains"]),
        shared=bool(d["shared"]))


class ProgramCache:
    """Memo of ``SearchResult``s keyed by (matrix fingerprint, SearchConfig,
    strategy, batch_size) — searches are deterministic per key, so benchmark
    reruns and serving restarts can skip straight to the winning design.

    Two layers:

    * in-memory dict (always on) — repeated ``search(...)`` calls in one
      process return the identical result object;
    * npz-on-disk (``cache_dir`` given) — persists the *winning graph* plus
      scalar metadata. Programs hold jitted closures and can't be pickled,
      so a disk hit re-runs the (deterministic, sub-second) Designer +
      kernel builder on the stored graph instead of re-searching.

    Key format (also the npz filename): ``<matrix-sha1-16>-<config-sha1-8>
    -b<batch_size>``, where the matrix fingerprint hashes (n_rows, n_cols,
    nnz, rows, cols, vals) and the config hash covers every SearchConfig
    field PLUS the strategy name + explicit strategy params
    (``SearchStrategy.key()``) — a ``GridStrategy`` result must never be
    served for an ``AnnealStrategy`` request on the same matrix/budget.
    """

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = Path(cache_dir) if cache_dir else None
        self._mem: dict[str, SearchResult] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def matrix_fingerprint(m: SparseMatrix) -> str:
        h = hashlib.sha1()
        h.update(np.asarray([m.n_rows, m.n_cols, m.nnz], np.int64).tobytes())
        h.update(np.ascontiguousarray(m.rows).tobytes())
        h.update(np.ascontiguousarray(m.cols).tobytes())
        h.update(np.ascontiguousarray(m.vals).tobytes())
        return h.hexdigest()[:16]

    @staticmethod
    def key(m: SparseMatrix, config: SearchConfig, strategy=None) -> str:
        blob = json.dumps(dataclasses.asdict(config), sort_keys=True,
                          default=str)
        # the strategy identity is part of the key: without it a
        # GridStrategy result would silently satisfy an AnnealStrategy
        # request for the same (matrix, budget) and vice versa
        blob += "|" + make_strategy(strategy).key()
        cfg_h = hashlib.sha1(blob.encode()).hexdigest()[:8]
        return (f"{ProgramCache.matrix_fingerprint(m)}-{cfg_h}"
                f"-b{max(config.batch_size, 1)}")

    def _path(self, key: str) -> Optional[Path]:
        return self.cache_dir / f"{key}.npz" if self.cache_dir else None

    def get(self, m: SparseMatrix, config: SearchConfig,
            strategy=None) -> Optional[SearchResult]:
        key = self.key(m, config, strategy)
        if key in self._mem:
            self.hits += 1
            return self._mem[key]
        path = self._path(key)
        if path is not None and path.exists():
            try:
                with np.load(path, allow_pickle=False) as z:
                    graph = _graph_from_jsonable(
                        json.loads(str(z["graph_json"])))
                    meta = run_graph(m, graph)
                    prog = build_program(meta, backend=str(z["backend"]))
                    res = SearchResult(
                        best_graph=graph, best_program=prog,
                        best_seconds=float(z["best_seconds"]),
                        gflops=float(z["gflops"]),
                        n_evaluations=int(z["n_evaluations"]),
                        n_structures=int(z["n_structures"]),
                        wall_seconds=float(z["wall_seconds"]),
                        records=[], cost_model_mad=None,
                        pruned_ops=tuple(str(p) for p in z["pruned_ops"]),
                        cached=True,
                        strategy_name=(str(z["strategy"])
                                       if "strategy" in z.files else "anneal"))
            except (OSError, KeyError, ValueError, GraphError) as e:
                warnings.warn(f"program cache entry {path} unusable "
                              f"({e!r}); re-searching", RuntimeWarning)
                self.misses += 1
                return None
            self._mem[key] = res
            self.hits += 1
            return res
        self.misses += 1
        return None

    def put(self, m: SparseMatrix, config: SearchConfig,
            result: SearchResult, strategy=None) -> None:
        key = self.key(m, config, strategy)
        self._mem[key] = result
        path = self._path(key)
        if path is None:
            return
        try:
            graph_json = json.dumps(_graph_to_jsonable(result.best_graph))
        except TypeError:
            return  # non-JSON-able operator params: memory-only entry
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path,
                 graph_json=np.str_(graph_json),
                 backend=np.str_(config.backend),
                 strategy=np.str_(result.strategy_name),
                 best_seconds=result.best_seconds,
                 gflops=result.gflops,
                 n_evaluations=result.n_evaluations,
                 n_structures=result.n_structures,
                 wall_seconds=result.wall_seconds,
                 pruned_ops=np.asarray(result.pruned_ops, dtype=np.str_))


def run_search(matrix: SparseMatrix, config: SearchConfig = None,
               cache: Optional[ProgramCache] = None, strategy=None,
               warm_start=None) -> SearchResult:
    """Run the §VI search: matrix in, winning design + program + stats out.

    This is the search primitive ``repro_torch.compile`` drives; it returns the
    full ``SearchResult`` (records, cost-model MAD, pruning report).

    * ``strategy`` — a ``repro_torch.design.SearchStrategy`` (instance, class or
      registered name: "anneal" | "grid" | "cost_model"); None = the
      default ``AnnealStrategy`` (behaviorally identical to the historical
      hard-wired walk).
    * ``warm_start`` — optional iterable of ``OperatorGraph``\\ s timed
      before the strategy's own walk (e.g. ``PlanStore.suggest``).
    * ``cache`` — a prior result for the same (matrix, config, strategy,
      batch_size) is returned without re-searching.
    """
    config = config or SearchConfig()
    strategy = make_strategy(strategy)
    if cache is not None:
        hit = cache.get(matrix, config, strategy)
        if hit is not None:
            return hit
    res = AlphaSparseSearch(matrix, config).run(strategy,
                                                warm_start=warm_start or ())
    if cache is not None:
        cache.put(matrix, config, res, strategy)
    return res
