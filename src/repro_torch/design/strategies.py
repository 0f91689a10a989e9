"""SearchStrategy protocol + the three shipped strategies (paper §VI).

The search *policy* is a first-class axis independent of the design
space (Auto-SpMV, arXiv 2302.05662; Stylianou & Weiland, 2303.05098):
the same ``DesignSpace`` can be walked by simulated annealing, a plain
coarse->fine grid, or a cost-model-guided ranker. A strategy is a small
state machine the search loop (``repro_torch.core.search.run_search``) runs:

    strategy.reset(space, rng, config, deadline)
    while batch := strategy.propose(space, history):
        for proposal in batch:
            result = <time proposal.graph against the oracle>
            history.append(result); strategy.observe(result)

``propose`` returns :class:`Proposal`\\ s (graph + structure label +
whether the candidate is part of the mandatory seed pass); ``observe``
feeds back one :class:`CandidateResult` per evaluated proposal. A
strategy signals completion by returning an empty batch. Out-of-tree
policies subclass :class:`SearchStrategy` and register with
``@register_strategy("my_policy")``; ``repro_torch.compile(...,
strategy="my_policy")`` then resolves them by name.

``AnnealStrategy`` is the pre-registry simulated-annealing walk extracted
verbatim: at a fixed seed it proposes the identical candidate sequence
(tier-1 parity test against a golden trace).
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import time
from typing import Optional

import numpy as np

__all__ = ["Proposal", "CandidateResult", "SearchStrategy", "AnnealStrategy",
           "GridStrategy", "CostModelGuidedStrategy", "LearnedStrategy",
           "STRATEGY_REGISTRY", "register_strategy", "make_strategy",
           "strategy_names"]


@dataclasses.dataclass(frozen=True)
class Proposal:
    """One candidate the strategy wants timed."""

    graph: object                 # OperatorGraph
    label: str = ""               # structure label (history bookkeeping)
    mandatory: bool = False       # seed-pass candidate: evaluated under the
                                  # extended (2x) seed deadline


@dataclasses.dataclass
class CandidateResult:
    """Outcome of evaluating one proposal (the history entry)."""

    graph: object                 # OperatorGraph
    seconds: float                # math.inf for failed/wrong candidates
    label: str = ""
    features: Optional[np.ndarray] = None   # cost-model features (None when
                                            # the candidate failed or was a
                                            # memo hit)

    @property
    def ok(self) -> bool:
        return math.isfinite(self.seconds)


class SearchStrategy:
    """Protocol: ``propose(space, history) -> [Proposal]``, ``observe``."""

    name = "strategy"

    # optional attributes the search loop reads after the run
    n_structures: int = 0
    cost_model_mad: Optional[float] = None

    def params(self) -> dict:
        """Explicit (non-inherited) parameters — part of the cache key."""
        return {}

    def key(self) -> str:
        """Cache-key identity: strategy name + explicit params. Two
        strategies with different keys never share a ``ProgramCache`` /
        ``PlanStore`` entry."""
        return f"{self.name}:{json.dumps(self.params(), sort_keys=True, default=str)}"

    def __repr__(self) -> str:
        # stable (address-free): configs holding a strategy hash cleanly
        return f"<{type(self).__name__} {self.key()}>"

    def reset(self, space, rng, config, deadline: Optional[float] = None):
        raise NotImplementedError

    def propose(self, space, history) -> list:
        raise NotImplementedError

    def observe(self, result: CandidateResult) -> None:
        pass


# ------------------------------- registry ----------------------------------

STRATEGY_REGISTRY: dict[str, type[SearchStrategy]] = {}


def register_strategy(name: str, *, replace: bool = False):
    """Class decorator: register a :class:`SearchStrategy` by name."""
    def deco(cls):
        if name in STRATEGY_REGISTRY and not replace:
            raise ValueError(f"strategy {name!r} already registered")
        cls.name = name
        STRATEGY_REGISTRY[name] = cls
        return cls
    return deco


def strategy_names() -> tuple[str, ...]:
    return tuple(sorted(STRATEGY_REGISTRY))


# Strategies living outside repro_torch.design, resolved by name on demand so
# this module never imports them at load time (repro_torch.corpus imports
# repro_torch.design, not the other way around). "portfolio" lives in
# repro_torch.corpus, which the port does not have yet: asking for it raises.
_LAZY_STRATEGY_MODULES = {"portfolio": None}


def _corpus_not_ported(name: str):
    return NotImplementedError(
        f"strategy {name!r} needs repro_torch.corpus, which is not ported "
        "yet (ROADMAP queue 1, item 4)")


def make_strategy(spec=None) -> SearchStrategy:
    """Normalize a strategy spec: None -> default AnnealStrategy; a name ->
    fresh registry instance; an instance/class passes through."""
    if spec is None:
        return AnnealStrategy()
    if isinstance(spec, SearchStrategy):
        return spec
    if isinstance(spec, type) and issubclass(spec, SearchStrategy):
        return spec()
    if isinstance(spec, str):
        if spec not in STRATEGY_REGISTRY and spec in _LAZY_STRATEGY_MODULES:
            if _LAZY_STRATEGY_MODULES[spec] is None:
                raise _corpus_not_ported(spec)
            importlib.import_module(_LAZY_STRATEGY_MODULES[spec])
        try:
            return STRATEGY_REGISTRY[spec]()
        except KeyError:
            known = ", ".join(strategy_names()) or "(none)"
            raise ValueError(f"unknown search strategy {spec!r}; registered: "
                             f"{known}") from None
    raise TypeError(f"strategy must be None, a name, or a SearchStrategy, "
                    f"got {type(spec).__name__}")


def _fit_model(records):
    """Fit the GBT cost model on successful history entries."""
    from repro_torch.core.cost_model import fit_cost_model
    return fit_cost_model([r.features for r in records],
                          [r.seconds for r in records])


def _train_records(history):
    return [h for h in history
            if h.features is not None and math.isfinite(h.seconds)
            and h.label != "warm"]


# ----------------------------- AnnealStrategy -------------------------------

@register_strategy("anneal")
class AnnealStrategy(SearchStrategy):
    """The §VI three-level search: seeded simulated annealing over
    structures (levels 1+2) + cost-model fine-grid interpolation (level 3).

    Extracted verbatim from the pre-registry ``AlphaSparseSearch.run``:
    with default (None) parameters every knob inherits from
    ``SearchConfig``, the rng call sequence is unchanged, and the proposed
    candidate sequence at a fixed seed is identical to the pre-refactor
    walk (golden-trace parity test).
    """

    def __init__(self, temperature: Optional[float] = None,
                 decay: Optional[float] = None,
                 max_structures: Optional[int] = None,
                 coarse_samples: Optional[int] = None,
                 fine_top_structures: Optional[int] = None,
                 fine_eval_budget: Optional[int] = None,
                 use_cost_model: Optional[bool] = None):
        self._overrides = {k: v for k, v in dict(
            temperature=temperature, decay=decay,
            max_structures=max_structures, coarse_samples=coarse_samples,
            fine_top_structures=fine_top_structures,
            fine_eval_budget=fine_eval_budget,
            use_cost_model=use_cost_model).items() if v is not None}

    def params(self) -> dict:
        return dict(self._overrides)

    def _knob(self, name, cfg_name, cfg):
        return self._overrides.get(name, getattr(cfg, cfg_name))

    def reset(self, space, rng, config, deadline=None):
        self.rng = rng
        self.cfg = config
        self._deadline = deadline
        self.temperature = self._knob("temperature", "sa_temperature", config)
        self.decay = self._knob("decay", "sa_decay", config)
        self.max_structures = self._knob("max_structures", "max_structures",
                                         config)
        self.coarse_samples = self._knob("coarse_samples", "coarse_samples",
                                         config)
        self.fine_top = self._knob("fine_top_structures",
                                   "fine_top_structures", config)
        self.fine_budget = self._knob("fine_eval_budget", "fine_eval_budget",
                                      config)
        self.use_cost_model = self._knob("use_cost_model", "use_cost_model",
                                         config)
        seeds = space.seed_structures()
        # rng order parity: shuffle the FULL space first (pre-refactor
        # ``run`` shuffled before the seed pass), then drop the seeds
        sp = space.structures()
        rng.shuffle(sp)
        self._space = [s for s in sp if s not in seeds]
        self._queue = list(seeds) + self._space[: self.max_structures]
        self._n_seeds = len(seeds)
        self._qi = 0
        self._temp = self.temperature
        self._current = math.inf       # SA current-structure cost
        self._best = math.inf          # best seconds observed anywhere
        self._batch_cost = math.inf    # best seconds in the pending batch
        self._seen: set = set()
        self._phase = "walk"
        self.n_structures = 0
        self.cost_model_mad = None

    def observe(self, result: CandidateResult) -> None:
        self._seen.add(result.graph)
        self._best = min(self._best, result.seconds)
        self._batch_cost = min(self._batch_cost, result.seconds)

    def propose(self, space, history) -> list:
        if self._phase == "fine":
            return self._propose_fine(space, history)
        if self._phase == "done":
            return []

        if self._qi == self._n_seeds:
            # seed pass complete: SA starts from the best cost so far
            self._current = self._best
        elif self._qi > self._n_seeds:
            # acceptance decision for the annealed structure just timed
            cost = self._batch_cost
            if math.isfinite(cost):
                if cost < self._current or self.rng.random() < math.exp(
                        -(cost - self._current)
                        / max(self._temp * max(self._current, 1e-9), 1e-12)):
                    self._current = cost
                elif self._temp < 0.05 and cost > 2.0 * self._best:
                    # annealed out: stop exploring poor structures
                    self._phase = "fine"
                    return self._propose_fine(space, history)
            self._temp *= self.decay

        if self._qi >= len(self._queue):
            self._phase = "fine"
            return self._propose_fine(space, history)

        structure = self._queue[self._qi]
        self._qi += 1
        self.n_structures += 1
        graphs = space.bind(structure, "coarse")
        if len(graphs) > self.coarse_samples:
            idx = self.rng.choice(len(graphs), self.coarse_samples,
                                  replace=False)
            graphs = [graphs[i] for i in idx]
        self._batch_cost = math.inf
        mandatory = self._qi <= self._n_seeds
        return [Proposal(g, structure.label(), mandatory=mandatory)
                for g in graphs]

    # -- level 3: cost-model interpolation on the fine grid --
    def _propose_fine(self, space, history) -> list:
        self._phase = "done"
        recs = _train_records(history)
        if not self.use_cost_model or len(recs) < 8:
            return []
        if self._deadline is not None and time.perf_counter() > self._deadline:
            return []
        model, self.cost_model_mad = _fit_model(recs)
        by_structure: dict[str, float] = {}
        for r in recs:
            by_structure[r.label] = min(
                by_structure.get(r.label, math.inf), r.seconds)
        top = sorted(by_structure, key=by_structure.get)[: self.fine_top]
        cands = []
        for structure in self._space:
            if structure.label() not in top:
                continue
            for g in space.bind(structure, "fine"):
                if g in self._seen:
                    continue
                feats = space.features(g)
                if feats is None:
                    continue
                cands.append((float(model.predict(feats[None])[0]), g))
        cands.sort(key=lambda t: t[0])
        return [Proposal(g, "fine") for _, g in cands[: self.fine_budget]]


# ------------------------------ GridStrategy --------------------------------

@register_strategy("grid")
class GridStrategy(SearchStrategy):
    """Deterministic coarse->fine grid walk (no rng, no cost model).

    Phase 1 times the *full* coarse grid of every structure (seeds first,
    then the space in enumeration order, capped at ``max_structures``);
    phase 2 refines the ``fine_top_structures`` best structures on their
    fine grids, capped at ``fine_eval_budget`` evaluations. The wall-clock
    budget is enforced by the search loop, so a small ``SearchConfig.
    max_seconds`` simply truncates the grid.
    """

    def __init__(self, max_structures: Optional[int] = None,
                 fine_top_structures: Optional[int] = None,
                 fine_eval_budget: Optional[int] = None):
        self._overrides = {k: v for k, v in dict(
            max_structures=max_structures,
            fine_top_structures=fine_top_structures,
            fine_eval_budget=fine_eval_budget).items() if v is not None}

    def params(self) -> dict:
        return dict(self._overrides)

    def reset(self, space, rng, config, deadline=None):
        o = self._overrides
        self.max_structures = o.get("max_structures", config.max_structures)
        self.fine_top = o.get("fine_top_structures",
                              config.fine_top_structures)
        self.fine_budget = o.get("fine_eval_budget", config.fine_eval_budget)
        seeds = space.seed_structures()
        rest = [s for s in space.structures() if s not in seeds]
        self._queue = seeds + rest[: self.max_structures]
        self._n_seeds = len(seeds)
        self._qi = 0
        self._by: dict[str, float] = {}
        self._seen: set = set()
        self._phase = "coarse"
        self.n_structures = 0
        self.cost_model_mad = None

    def observe(self, result: CandidateResult) -> None:
        self._seen.add(result.graph)
        # pseudo-labels ("warm" from a store suggestion, "fine") are not
        # structures: letting them in would eat fine_top_structures slots
        # that can never match a structure.label()
        if result.label and result.label not in ("fine", "warm"):
            self._by[result.label] = min(
                self._by.get(result.label, math.inf), result.seconds)

    def propose(self, space, history) -> list:
        if self._phase == "coarse":
            if self._qi < len(self._queue):
                structure = self._queue[self._qi]
                self._qi += 1
                self.n_structures += 1
                mandatory = self._qi <= self._n_seeds
                return [Proposal(g, structure.label(), mandatory=mandatory)
                        for g in space.bind(structure, "coarse")]
            self._phase = "fine"
        if self._phase == "fine":
            self._phase = "done"
            finite = {k: v for k, v in self._by.items() if math.isfinite(v)}
            top = sorted(finite, key=finite.get)[: self.fine_top]
            out = []
            for structure in self._queue:
                if structure.label() not in top:
                    continue
                for g in space.bind(structure, "fine"):
                    if g not in self._seen:
                        out.append(Proposal(g, "fine"))
                    if len(out) >= self.fine_budget:
                        return out
            return out
        return []


# ------------------------- CostModelGuidedStrategy --------------------------

@register_strategy("cost_model")
class CostModelGuidedStrategy(SearchStrategy):
    """Rank-before-timing: bootstrap on the seed structures, then fit the
    GBT cost model (``repro_torch.core.cost_model``) on everything timed so far
    and only run the candidates it predicts fastest.

    Each round re-fits on the grown history, pools untimed candidates
    (coarse + fine bindings, round-robin across structures, capped at
    ``pool``), ranks them by predicted log-time, and proposes the top
    ``batch``. Bootstrap falls back to the anneal-style sampled coarse
    pass until ``min_train`` measurements exist.
    """

    def __init__(self, rounds: int = 3, batch: Optional[int] = None,
                 pool: int = 64, min_train: int = 8):
        self.rounds = rounds
        self.batch = batch
        self.pool = pool
        self.min_train = min_train

    def params(self) -> dict:
        return {"rounds": self.rounds, "batch": self.batch,
                "pool": self.pool, "min_train": self.min_train}

    def reset(self, space, rng, config, deadline=None):
        self.rng = rng
        self.cfg = config
        self._deadline = deadline
        self._batch_n = self.batch or max(config.fine_eval_budget, 4)
        seeds = space.seed_structures()
        sp = space.structures()
        rng.shuffle(sp)
        self._space = [s for s in sp if s not in seeds]
        self._queue = list(seeds) + self._space[: config.max_structures]
        self._n_seeds = len(seeds)
        self._qi = 0
        self._round = 0
        self._seen: set = set()
        self.n_structures = 0
        self.cost_model_mad = None

    def observe(self, result: CandidateResult) -> None:
        self._seen.add(result.graph)

    def propose(self, space, history) -> list:
        # bootstrap: sampled coarse pass until the model has enough data
        need_boot = (len(_train_records(history)) < self.min_train
                     or self._qi < self._n_seeds)
        if need_boot and self._qi < len(self._queue):
            structure = self._queue[self._qi]
            self._qi += 1
            self.n_structures += 1
            graphs = space.bind(structure, "coarse")
            if len(graphs) > self.cfg.coarse_samples:
                idx = self.rng.choice(len(graphs), self.cfg.coarse_samples,
                                      replace=False)
                graphs = [graphs[i] for i in idx]
            mandatory = self._qi <= self._n_seeds
            return [Proposal(g, structure.label(), mandatory=mandatory)
                    for g in graphs]

        recs = _train_records(history)
        if self._round >= self.rounds or len(recs) < max(self.min_train, 2):
            return []
        if self._deadline is not None and time.perf_counter() > self._deadline:
            return []
        self._round += 1
        model, self.cost_model_mad = _fit_model(recs)
        # pool untimed candidates round-robin across structures
        pool = []
        per_structure = [iter(space.bind(s, "coarse") + space.bind(s, "fine"))
                         for s in self._queue]
        pooled_graphs = set()
        while per_structure and len(pool) < self.pool:
            nxt = []
            for it in per_structure:
                g = next(it, None)
                if g is None:
                    continue
                nxt.append(it)
                if g in self._seen or g in pooled_graphs:
                    continue
                pooled_graphs.add(g)
                pool.append(g)
                if len(pool) >= self.pool:
                    break
            per_structure = nxt
        cands = []
        for g in pool:
            feats = space.features(g)
            if feats is None:
                continue
            cands.append((float(model.predict(feats[None])[0]), g))
        cands.sort(key=lambda t: t[0])
        return [Proposal(g, "model") for _, g in cands[: self._batch_n]]


# ----------------------------- LearnedStrategy ------------------------------

@register_strategy("learned")
class LearnedStrategy(SearchStrategy):
    """Corpus-model-first search. It needs a trained corpus model from
    ``repro_torch.corpus``, which the port does not have yet, so creating
    one raises ``NotImplementedError``."""

    def __init__(self, *args, **kwargs):
        raise _corpus_not_ported("learned")
