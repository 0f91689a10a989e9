"""Portfolio search: reuse -> learned predictions -> anneal refinement.

Port of ``repro.corpus.portfolio``. The fleet fast path. Under one
``compile(deadline_s=...)`` budget the portfolio races three
ever-more-expensive sources of designs, cheapest first, and the incumbent
best-so-far is whatever the search loop has timed fastest — a later
stage only runs while budget remains and only helps if it beats the
incumbent:

1. **reuse** — ``PlanStore.suggest`` nearest stored plan (one candidate,
   milliseconds to propose);
2. **learned** — the trained corpus model's top-k predictions
   (:class:`repro_torch.design.strategies.LearnedStrategy` predict phase);
3. **refine** — a fresh ``AnnealStrategy`` walk with the remaining
   budget.

Confidence gating: when the reuse match distance is within
``skip_refine_distance`` (an essentially-identical matrix was already
compiled) and the reused candidate evaluated successfully, stage 3 is
skipped entirely — compile cost collapses to timing a handful of
candidates. Registered as ``"portfolio"``; reach it via
``repro_torch.compile(matrix, strategy="portfolio", store=store)`` or
``python -m repro_torch.cli --strategy portfolio --store DIR``.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.design.strategies import (AnnealStrategy, CandidateResult,
                                           LearnedStrategy, Proposal,
                                           SearchStrategy, register_strategy)

__all__ = ["PortfolioStrategy"]


@register_strategy("portfolio")
class PortfolioStrategy(SearchStrategy):
    """See module docstring. ``refine=False`` forces the fast path even on
    low-confidence reuse (pure predict-and-pick)."""

    def __init__(self, store=None, model=None, top_k: int = 3,
                 reuse_max_distance: float = 1.0,
                 skip_refine_distance: float = 0.35,
                 refine: bool = True):
        self.store = store
        self.model = model
        self.top_k = top_k
        self.reuse_max_distance = reuse_max_distance
        self.skip_refine_distance = skip_refine_distance
        self.refine = refine

    def params(self) -> dict:
        return {"top_k": self.top_k,
                "reuse_max_distance": self.reuse_max_distance,
                "skip_refine_distance": self.skip_refine_distance,
                "refine": self.refine,
                "model": (None if self.model is None
                          else self.model.fingerprint())}

    def bind_store(self, store) -> None:
        """Attach the PlanStore (reuse source) and load its trained corpus
        model, if one was saved next to it."""
        self.store = store
        if self.model is None:
            probe = LearnedStrategy()
            probe.bind_store(store)
            self.model = probe.model

    @property
    def n_structures(self) -> int:
        n = self._learned.n_structures if self._learned else 0
        return n + (self._inner.n_structures if self._inner else 0)

    @property
    def cost_model_mad(self):
        return self._inner.cost_model_mad if self._inner else None

    def reset(self, space, rng, config, deadline=None):
        self.rng = rng
        self.cfg = config
        self._deadline = deadline
        self._phase = "reuse"
        self._learned: Optional[LearnedStrategy] = None
        self._inner: Optional[AnnealStrategy] = None
        self._buffer: list[CandidateResult] = []
        self._reuse_distance = math.inf
        self._reuse_ok = False

    def observe(self, result: CandidateResult) -> None:
        if result.label == "reuse" and result.ok:
            self._reuse_ok = True
        if self._inner is not None:
            self._inner.observe(result)
        else:
            self._buffer.append(result)
        if self._learned is not None and self._inner is None:
            self._learned.observe(result)

    def propose(self, space, history) -> list:
        if self._phase == "reuse":
            self._phase = "learned"
            props = self._propose_reuse(space)
            if props:
                return props
        if self._phase == "learned":
            self._phase = "refine"
            if self.model is not None:
                self._learned = LearnedStrategy(model=self.model,
                                                top_k=self.top_k,
                                                refine=False)
                self._learned.reset(space, self.rng, self.cfg,
                                    self._deadline)
                props = self._learned.propose(space, history)
                if props:
                    return props
        if self._phase == "refine":
            self._phase = "done"
            if not self.refine:
                return []
            if self._reuse_ok and (self._reuse_distance
                                   <= self.skip_refine_distance):
                # high-confidence reuse: an essentially identical matrix
                # was already searched — skip the walk, keep the budget
                return []
            self._inner = AnnealStrategy()
            self._inner.reset(space, self.rng, self.cfg, self._deadline)
            for r in self._buffer:
                self._inner.observe(r)
        if self._inner is not None:
            # an empty batch from the walk ends the search loop
            return self._inner.propose(space, history)
        return []

    def _propose_reuse(self, space) -> list:
        if self.store is None:
            return []
        graph, dist = self.store.suggest(
            space.m, max_distance=self.reuse_max_distance,
            with_distance=True)
        if graph is None:
            return []
        self._reuse_distance = dist
        return [Proposal(graph, "reuse")]