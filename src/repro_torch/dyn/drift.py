"""DriftPolicy: when does a patched plan stop deserving its format? (A
copy of ``repro.dyn.drift``: numpy only.)

In-place updates keep the *format* the search designed for the birth
pattern. The design was chosen from row statistics (the §VI-B pruning
features ``PlanStore.suggest`` keys on: nnz/row mean, std, row-length
CV), so when the live pattern's statistics walk far enough from the
birth statistics the format is probably no longer the one the search
would pick — that is the escalation point to a background re-search,
*not* a correctness boundary (patched plans stay exact regardless).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.matrices import SparseMatrix

__all__ = ["pattern_stats", "DriftPolicy", "DriftReport"]


def pattern_stats(matrix: SparseMatrix) -> dict:
    """The sidecar feature set as a dict: row count, nnz, nnz/row
    mean/std, and row-length coefficient of variation."""
    lengths = np.bincount(np.asarray(matrix.rows, np.int64),
                          minlength=matrix.n_rows).astype(np.float64)
    mean = float(lengths.mean()) if lengths.size else 0.0
    std = float(lengths.std()) if lengths.size else 0.0
    return {"n_rows": int(matrix.n_rows), "nnz": int(matrix.nnz),
            "mean": mean, "std": std,
            "cv": std / mean if mean > 0 else 0.0}


def _ratio(live: float, birth: float) -> float:
    """Symmetric fold-change (>= 1); 0 vs 0 is 1, 0 vs nonzero is inf."""
    lo, hi = sorted((abs(live), abs(birth)))
    if hi == 0.0:
        return 1.0
    if lo == 0.0:
        return float("inf")
    return hi / lo


@dataclasses.dataclass(frozen=True)
class DriftReport:
    drifted: bool
    reasons: tuple
    birth: dict
    live: dict

    def __bool__(self) -> bool:
        return self.drifted


@dataclasses.dataclass(frozen=True)
class DriftPolicy:
    """Tolerances on the live-vs-birth statistics fold changes.

    Ratios are symmetric (densifying and sparsifying both count); ``cv``
    is compared by absolute delta because it is already scale-free.
    Defaults are deliberately loose — an in-place update is always exact,
    so a premature re-search only wastes search budget, while a missed
    one only costs throughput.
    """

    max_nnz_ratio: float = 1.3
    max_mean_ratio: float = 1.3
    max_std_ratio: float = 1.6
    max_cv_delta: float = 0.35

    def assess(self, birth: dict, live: dict) -> DriftReport:
        reasons = []
        checks = (("nnz", _ratio(live["nnz"], birth["nnz"]),
                   self.max_nnz_ratio),
                  ("mean", _ratio(live["mean"], birth["mean"]),
                   self.max_mean_ratio),
                  ("std", _ratio(live["std"], birth["std"]),
                   self.max_std_ratio))
        for name, got, limit in checks:
            if got > limit:
                reasons.append(f"{name} x{got:.2f} > x{limit:g}")
        cv_delta = abs(live["cv"] - birth["cv"])
        if cv_delta > self.max_cv_delta:
            reasons.append(f"cv moved {cv_delta:.2f} > {self.max_cv_delta:g}")
        return DriftReport(drifted=bool(reasons), reasons=tuple(reasons),
                           birth=dict(birth), live=dict(live))
