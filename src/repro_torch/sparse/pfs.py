"""Perfect Format Selector (paper §VII-B); port of ``repro.sparse.pfs``.

"As a performance-first auto-tuner, PFS does not rely on probabilistic
models ... it can certainly select the best formats by directly running
SpMV of all candidate formats." We reproduce it verbatim: build every
baseline, time each, return the winner. This is the strongest possible
representative of the traditional format-selection auto-tuning philosophy
— any speedup AlphaSparse shows over PFS is attributable to *creating*
formats rather than *selecting* them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.kernel_builder import resolve_device
from repro_torch.core.matrices import SparseMatrix
from .baselines import BASELINES, BaselineFormat

__all__ = ["PerfectFormatSelector", "PFSResult"]


@dataclasses.dataclass
class PFSResult:
    best_name: str
    best_seconds: float
    best_format: BaselineFormat
    all_seconds: dict[str, float]

    @property
    def gflops_table(self):
        return {k: None for k in self.all_seconds}


class PerfectFormatSelector:
    """Build, check and time every candidate baseline on ``device``
    (default: the current GPU) and keep the fastest."""

    def __init__(self, candidates: Optional[list[str]] = None,
                 timing_repeats: int = 3, device=None):
        self.candidates = candidates or list(BASELINES)
        self.repeats = timing_repeats
        self.device = (resolve_device("cuda") if device is None
                       else torch.device(device))

    def select(self, m: SparseMatrix, x: Optional[np.ndarray] = None,
               check_oracle: bool = True) -> PFSResult:
        """Time each candidate on ``x`` (default: a seeded normal vector).

        ``x`` moves to the device once, before the loop. Each timed call
        is one call on the host clock; on a CUDA device the card is
        synchronised before and after it, so the time is the call's
        device work plus its host dispatch, not only the enqueue."""
        if x is None:
            x = np.random.default_rng(0).standard_normal(m.n_cols).astype(
                np.float32)
        oracle = m.spmv_dense_oracle(np.asarray(x)) if check_oracle else None
        xd = torch.as_tensor(x, device=self.device)
        cuda = self.device.type == "cuda"
        times: dict[str, float] = {}
        fmts: dict[str, BaselineFormat] = {}
        for name in self.candidates:
            f = BASELINES[name](m, device=self.device)
            y = f(xd).cpu().numpy()
            if oracle is not None:
                scale = np.abs(oracle).max() + 1e-30
                if not np.all(np.abs(y - oracle) <= 1e-3 * scale + 1e-5):
                    raise AssertionError(
                        f"baseline {name} produced wrong results")
            best = float("inf")
            for _ in range(self.repeats):
                if cuda:
                    torch.cuda.synchronize(self.device)
                t0 = time.perf_counter()
                f(xd)
                if cuda:
                    torch.cuda.synchronize(self.device)
                best = min(best, time.perf_counter() - t0)
            times[name] = best
            fmts[name] = f
        winner = min(times, key=times.get)
        return PFSResult(winner, times[winner], fmts[winner], times)
