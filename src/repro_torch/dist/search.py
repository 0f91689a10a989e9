"""Per-shard AlphaSparse search: each partition gets its own machine-
designed format (port of ``repro.dist.search``).

Auto-SpMV-style motivation (PAPERS.md, arXiv 2302.05662): tuning decisions
that are optimal globally are rarely optimal per partition. A power-law
matrix split by nnz yields shards of very different regularity — the
head-row shard is irregular (SEG-family designs win), the tail shards are
near-uniform (ELL-family designs win). Running the §VI search independently
per shard lets the distributed format be heterogeneous.

Determinism: shard i searches with ``seed + i`` derived from one base
seed — per-shard walks are reproducible AND mutually divergent.

The search *policy* is pluggable per the ``repro_torch.design``
SearchStrategy protocol: ``ShardedSearchConfig.strategy`` (name or
instance) is handed to every per-shard ``run_search``.

Shards search on a thread pool. Each search times its candidates on its
shard's device; the search serialises the device work of concurrent
searches on one device (``core.search``), so shards that share a card
never time their candidates at the same time, while the host-side
Designer work stays parallel.

Fault domains: each shard's search is its own failure domain. A shard
search that raises (crash, OOM, hang past the deadline, a design-space
bug) is classified under the ``repro_torch.core.search`` failure taxonomy
and the shard is substituted with its trusted baseline program
(``baseline_shard_program``) — the compile degrades instead of failing.
Per-shard failure counts are aggregated on the result
(``ShardedSearchResult.failure_counts``, ``failed_shards()``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import traceback
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import torch

from repro_torch.core.deprecation import warn_once
from repro_torch.core.matrices import SparseMatrix
from repro_torch.core.search import (ProgramCache, SearchConfig, SearchResult,
                                     _classify_failure,
                                     cooperative_deadline_available,
                                     run_search)
from repro_torch.design.strategies import SearchStrategy

from .spmv import (RowShard, ShardedSpmvProgram, _axis_size,
                   baseline_shard_program, build_sharded_spmv,
                   partition_matrix)

__all__ = ["ShardedSearchConfig", "ShardReport", "ShardedSearchResult",
           "dist_search", "shard_fault_hook"]


def _default_budget() -> SearchConfig:
    # per-shard budget: shards are ~1/n_shards of the matrix, so the §VI
    # wall-clock budget shrinks accordingly
    return SearchConfig(max_seconds=10.0, max_structures=4, coarse_samples=3,
                        fine_eval_budget=3, timing_repeats=2)


@dataclasses.dataclass
class ShardedSearchConfig:
    axis_name: str = "data"
    mode: str = "row"                 # 'row' | 'col'
    balance: str = "nnz"              # row-boundary strategy
    search: SearchConfig = dataclasses.field(default_factory=_default_budget)
    # search policy for every per-shard search: a repro_torch.design
    # strategy name ("anneal" | "grid" | "cost_model"), instance, or None
    # (anneal)
    strategy: object = None
    seed: int = 0
    # shards below this nnz skip the search and take the heuristic design
    # (a search on a near-empty shard is all compile overhead, no signal)
    min_nnz_for_search: int = 256
    # per-shard searches share no state (each gets its own rng, design
    # space and derived seed), so they run on a thread pool. None = one
    # worker per searchable shard capped at the CPU count; 1 = sequential.
    max_workers: Optional[int] = None
    backend: str = "cuda"
    # kept for the reference's header; the port has no interpret mode
    interpret: bool = True


# process-global fault-injection seam: a hook(shard) invoked at the top of
# every per-shard design (including heuristic shards). Raising from it
# forces that shard's whole search to fail, exercising the baseline
# substitution path.
_SHARD_FAULT_HOOK: Optional[Callable[[RowShard], None]] = None


@contextlib.contextmanager
def shard_fault_hook(hook: Callable[[RowShard], None]):
    """Install a per-shard fault-injection hook for the duration of the
    context (a test and smoke-run seam)."""
    global _SHARD_FAULT_HOOK
    prev = _SHARD_FAULT_HOOK
    _SHARD_FAULT_HOOK = hook
    try:
        yield
    finally:
        _SHARD_FAULT_HOOK = prev


@dataclasses.dataclass
class ShardReport:
    shard: RowShard
    searched: bool
    graph_label: Optional[str]
    result: Optional[SearchResult]    # None when heuristic / empty
    # shard-level fault domain: True when the shard's search raised and
    # the baseline program was substituted (degraded-but-correct)
    failed: bool = False
    failure: Optional[str] = None     # taxonomy bucket of the failure
    error: Optional[str] = None       # one-line repr of the exception

    @property
    def family(self) -> Optional[str]:
        if self.graph_label is None:
            return None
        return "SEG" if "LANE_NNZ_BLOCK" in self.graph_label else "ELL"


@dataclasses.dataclass
class ShardedSearchResult:
    program: ShardedSpmvProgram
    reports: list[ShardReport]
    # aggregated over all shards: per-shard SearchResult.failure_counts
    # summed, plus one "fallback" per shard substituted with the baseline
    failure_counts: dict = dataclasses.field(default_factory=dict)

    def families(self) -> list[Optional[str]]:
        return [r.family for r in self.reports]

    def is_heterogeneous(self) -> bool:
        fams = {f for f in self.families() if f is not None}
        return len(fams) > 1

    def failed_shards(self) -> list[int]:
        return [r.shard.index for r in self.reports if r.failed]


def dist_search(m: SparseMatrix, mesh,
                config: Optional[ShardedSearchConfig] = None,
                cache: Optional[ProgramCache] = None
                ) -> ShardedSearchResult:
    """Partition ``m`` over the mesh and run one AlphaSparse search per
    shard, each on its shard's device; returns the sharded program plus
    per-shard reports. ``cache`` memoises the per-shard searches (keyed
    on each shard sub-matrix + its derived config)."""
    cfg = config or ShardedSearchConfig()
    n_shards = _axis_size(mesh, cfg.axis_name)
    shards = partition_matrix(m, n_shards, mode=cfg.mode, balance=cfg.balance)
    devices = list(getattr(mesh, "devices", ()))[:n_shards]
    devices += [None] * (n_shards - len(devices))
    n_searchable = sum(1 for s in shards
                       if not s.is_empty
                       and s.matrix.nnz >= cfg.min_nnz_for_search)
    workers = cfg.max_workers
    if workers is None:
        workers = max(1, min(n_searchable, os.cpu_count() or 1))
    if isinstance(cfg.strategy, SearchStrategy):
        # a shared strategy *instance* is stateful across reset(); pooled
        # shards would race on it — fall back to the sequential path
        # (pass a name/class to parallelize)
        workers = 1
    if workers > 1 and n_searchable > 1:
        if cfg.search.candidate_timeout_s is not None:
            # pooled searches rely on the cooperative deadline; if it is
            # ever unavailable, say so once instead of silently running
            # unprotected
            if not cooperative_deadline_available():
                warn_once(
                    "dist-pooled-deadline",
                    "candidate_timeout_s is set but the cooperative "
                    "deadline path is unavailable; pooled per-shard "
                    "searches have no hang protection")
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="shard-search") as ex:
            # ex.map preserves shard order: results are positionally
            # identical to the sequential path
            outs = list(ex.map(lambda sd: _design_shard(sd[0], cfg, cache,
                                                        sd[1]),
                               zip(shards, devices)))
    else:
        outs = [_design_shard(s, cfg, cache, d)
                for s, d in zip(shards, devices)]
    programs = [p for p, _ in outs]
    reports = [r for _, r in outs]
    counts: Counter = Counter()
    for r in reports:
        if r.result is not None and r.result.failure_counts:
            counts.update(r.result.failure_counts)
        if r.failed:
            counts["fallback"] += 1
    program = build_sharded_spmv(shards, programs, mesh, cfg.axis_name,
                                 backend=cfg.backend)
    return ShardedSearchResult(program=program, reports=reports,
                               failure_counts=dict(counts))


def _on_device(device):
    """Make ``device`` the current CUDA device of this thread (a search
    times its candidates there); a no-op for the CPU."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _design_shard(s: RowShard, cfg: ShardedSearchConfig,
                  cache: Optional[ProgramCache], device=None):
    """Design one shard: searched, heuristic, or empty. Shares nothing
    mutable with other shards (thread-pool safe): the per-shard search
    derives its own rng from ``seed + shard_id`` and builds its own
    DesignSpace.

    Each shard is its own fault domain: any exception from the search (or
    the injected ``shard_fault_hook``) is classified under the failure
    taxonomy and the shard falls back to its baseline program — one bad
    shard degrades the compile, it doesn't fail it."""
    if s.is_empty:
        return None, ShardReport(s, False, None, None)
    with _on_device(device):
        try:
            hook = _SHARD_FAULT_HOOK
            if hook is not None:
                hook(s)
            if s.matrix.nnz >= cfg.min_nnz_for_search:
                # per-shard seed: shard walks must diverge (seed +
                # shard_id), not replay one walk n_shards times
                scfg = dataclasses.replace(
                    cfg.search,
                    seed=cfg.seed + cfg.search.seed + s.index,
                    backend=cfg.backend)
                res = run_search(s.matrix, scfg, cache=cache,
                                 strategy=cfg.strategy)
                return res.best_program, ShardReport(
                    s, True, res.best_graph.label(), res)
            g, prog = baseline_shard_program(s.matrix, backend=cfg.backend)
            return prog, ShardReport(s, False, g.label(), None)
        except Exception as exc:  # shard fault domain: degrade, don't fail
            bucket = _classify_failure(exc)
            warnings.warn(
                f"shard {s.index} search failed ({bucket}: {exc!r}); "
                "substituting the baseline program", RuntimeWarning,
                stacklevel=2)
            g, prog = baseline_shard_program(s.matrix, backend=cfg.backend)
            tb = traceback.format_exception_only(type(exc), exc)[-1].strip()
            return prog, ShardReport(s, False, g.label(), None,
                                     failed=True, failure=bucket, error=tb)
