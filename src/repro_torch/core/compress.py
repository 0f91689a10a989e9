"""Model-Driven Format Compression (paper §V-D, derived from [57]).

Replaces format index arrays (memory loads) with fitted closed-form models
(compute): linear ``v[i] = a*i + b``, step ``v[i] = a*(i//k) + b`` and
periodic-linear ``v[i] = a*(i % p) + c*(i//p) + b``. Unlike ordinary
regression, *any* un-modelled error would make the SpMV wrong, so fits are
exact-integer fits with an explicit exception table (the paper tolerates a
small number of errors via ``if`` statements; our exception table is the
same mechanism, data- instead of code-shaped).

Two consumers:
  * the kernel builder — an affine ``rowmap`` proves output rows are
    contiguous, enabling the GRID_ACC combine (write the output block
    directly instead of scatter) and eliding the rowmap array;
  * the roofline/cost model — compressed arrays are removed from the
    format's byte footprint.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["ArrayModel", "fit_array", "affine_rowmap"]


@dataclasses.dataclass(frozen=True)
class ArrayModel:
    kind: str                   # 'linear' | 'step' | 'periodic'
    params: tuple               # see evaluate()
    n: int
    exc_idx: np.ndarray         # indices the model cannot fit
    exc_val: np.ndarray

    @property
    def n_exceptions(self) -> int:
        return int(self.exc_idx.size)

    def evaluate(self) -> np.ndarray:
        i = np.arange(self.n, dtype=np.int64)
        if self.kind == "linear":
            a, b = self.params
            v = a * i + b
        elif self.kind == "step":
            a, b, k = self.params
            v = a * (i // k) + b
        else:  # periodic
            a, b, c, p = self.params
            v = a * (i % p) + c * (i // p) + b
        if self.exc_idx.size:
            v = v.copy()
            v[self.exc_idx] = self.exc_val
        return v

    def saved_bytes(self, itemsize: int = 4) -> int:
        return self.n * itemsize - self.n_exceptions * 2 * itemsize


def _with_exceptions(pred: np.ndarray, arr: np.ndarray, kind: str,
                     params: tuple, max_exc: int) -> Optional[ArrayModel]:
    bad = np.where(pred != arr)[0]
    if bad.size > max_exc:
        return None
    return ArrayModel(kind, params, arr.size, bad.astype(np.int64),
                      arr[bad].astype(np.int64))


def fit_array(arr: np.ndarray, max_exc_frac: float = 0.02) -> Optional[ArrayModel]:
    """Try linear, then step, then periodic-linear integer fits."""
    arr = np.asarray(arr).ravel().astype(np.int64)
    n = arr.size
    if n < 2:
        return None
    max_exc = max(2, int(n * max_exc_frac))
    i = np.arange(n, dtype=np.int64)

    # linear: slope from median of successive differences (robust to exceptions)
    d = np.diff(arr)
    a = int(np.median(d))
    b = int(np.median(arr - a * i))
    m = _with_exceptions(a * i + b, arr, "linear", (a, b), max_exc)
    if m is not None:
        return m

    # step: constant runs of equal length k
    change = np.where(d != 0)[0]
    if change.size:
        k = int(np.median(np.diff(np.concatenate([[-1], change]))))
        if k >= 1:
            steps = arr[::k]
            sa = int(np.median(np.diff(steps))) if steps.size > 1 else 0
            sb = int(arr[0])
            m = _with_exceptions(sa * (i // k) + sb, arr, "step", (sa, sb, k),
                                 max_exc)
            if m is not None:
                return m

    # periodic linear: detect period from autocorrelation of differences
    for p in _candidate_periods(d):
        a1 = int(np.median(arr[1:p] - arr[: p - 1])) if p > 1 else 0
        c1 = int(np.median(arr[p::p] - arr[:-p:p])) if n > p else 0
        b1 = int(arr[0])
        pred = a1 * (i % p) + c1 * (i // p) + b1
        m = _with_exceptions(pred, arr, "periodic", (a1, b1, c1, p), max_exc)
        if m is not None:
            return m
    return None


def _candidate_periods(d: np.ndarray, max_try: int = 4) -> list[int]:
    """Candidate periods: positions where the difference pattern repeats."""
    if d.size < 4:
        return []
    # a period p makes d[p:] == d[:-p] mostly true
    cands = []
    for p in (2, 4, 8, 16, 32, 64, 128):
        if p >= d.size:
            break
        agree = np.mean(d[p:] == d[:-p])
        if agree > 0.9:
            cands.append(p)
        if len(cands) >= max_try:
            break
    return cands


def affine_rowmap(rowmap: np.ndarray) -> Optional[tuple[int, int]]:
    """If the flat non-pad rowmap is exactly ``a*i + b`` return (a, b).

    This is the Model-Driven-Compression special case the kernel builder
    uses to enable GRID_ACC (direct output-block writes) and drop the
    rowmap array from the format.
    """
    flat = np.asarray(rowmap).ravel().astype(np.int64)
    valid = flat >= 0
    # pad rows are only allowed as a trailing run (otherwise output blocks
    # would have holes and the direct write would be wrong)
    nv = int(valid.sum())
    if nv < 2 or valid[:nv].sum() != nv:
        return None
    v = flat[:nv]
    a = int(v[1] - v[0])
    b = int(v[0])
    i = np.arange(nv, dtype=np.int64)
    if np.array_equal(a * i + b, v):
        return (a, b)
    return None
