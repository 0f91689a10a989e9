"""PatternDelta: the difference between two sparsity patterns (a copy of
``repro.dyn.delta``: numpy only).

AlphaSparse designs a format from one frozen pattern; dynamic workloads
(magnitude pruning, MoE routing churn, graph updates) mutate it
continuously. A :class:`PatternDelta` is the unit of mutation the rest of
``repro_torch.dyn`` consumes: the added, removed and revalued nonzeros between
two ``SparseMatrix`` states, cheap to compute from either two matrices
(:meth:`PatternDelta.from_matrices` — one merge over the sorted COO
streams) or a prune mask (:meth:`PatternDelta.from_masks` — what a
training loop already holds).

Entries are canonicalized the way ``SparseMatrix.canonical`` treats
storage: an add with value 0 is a no-op, a revalue to 0 is a removal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.matrices import SparseMatrix

__all__ = ["PatternDelta", "same_pattern"]


def _keys(rows: np.ndarray, cols: np.ndarray, n_cols: int) -> np.ndarray:
    """Row-major flat key per entry; matrices are canonical (sorted by
    (row, col)) so the key stream is strictly increasing."""
    return rows.astype(np.int64) * np.int64(n_cols) + cols.astype(np.int64)


def _member(keys: np.ndarray, within: np.ndarray) -> np.ndarray:
    """Boolean membership of ``keys`` in the sorted key stream ``within``."""
    if within.size == 0:
        return np.zeros(keys.shape, bool)
    pos = np.searchsorted(within, keys)
    pos = np.minimum(pos, within.size - 1)
    return within[pos] == keys


@dataclasses.dataclass(frozen=True)
class PatternDelta:
    """Added / removed / revalued nonzeros between two pattern states.

    All coordinate arrays are int32, values float32; ``(row, col)`` pairs
    are unique within and across the three groups. Shapes refer to the
    matrix the delta applies *to* (``n_rows`` x ``n_cols``).
    """

    n_rows: int
    n_cols: int
    add_rows: np.ndarray        # entries present only after the mutation
    add_cols: np.ndarray
    add_vals: np.ndarray
    drop_rows: np.ndarray       # entries present only before
    drop_cols: np.ndarray
    reval_rows: np.ndarray      # entries in both, value changed
    reval_cols: np.ndarray
    reval_vals: np.ndarray      # the new values

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_matrices(cls, old: SparseMatrix, new: SparseMatrix
                      ) -> "PatternDelta":
        """Delta taking ``old`` to ``new`` (same shape required)."""
        if (old.n_rows, old.n_cols) != (new.n_rows, new.n_cols):
            raise ValueError(
                f"shape mismatch: old is {old.n_rows}x{old.n_cols}, "
                f"new is {new.n_rows}x{new.n_cols}")
        old, new = old.canonical(), new.canonical()
        ko = _keys(old.rows, old.cols, old.n_cols)
        kn = _keys(new.rows, new.cols, new.n_cols)
        old_in_new = _member(ko, kn)
        new_in_old = _member(kn, ko)
        drop = ~old_in_new
        add = ~new_in_old
        # common entries, aligned: both streams sorted by key
        co = old_in_new.nonzero()[0]
        cn = new_in_old.nonzero()[0]
        changed = old.vals[co] != new.vals[cn]
        ri = cn[changed]
        return cls(
            n_rows=old.n_rows, n_cols=old.n_cols,
            add_rows=new.rows[add].copy(), add_cols=new.cols[add].copy(),
            add_vals=new.vals[add].copy(),
            drop_rows=old.rows[drop].copy(), drop_cols=old.cols[drop].copy(),
            reval_rows=new.rows[ri].copy(), reval_cols=new.cols[ri].copy(),
            reval_vals=new.vals[ri].copy())

    @classmethod
    def from_masks(cls, weights: np.ndarray, old_mask: np.ndarray,
                   new_mask: np.ndarray,
                   old_weights: np.ndarray = None) -> "PatternDelta":
        """Delta from dense boolean prune masks over a weight matrix.

        ``weights`` are the *new* values; pass ``old_weights`` when kept
        entries changed value between the two states (otherwise kept
        entries are assumed unchanged and produce no revalues)."""
        weights = np.asarray(weights, np.float32)
        old_mask = np.asarray(old_mask, bool) & (
            np.asarray(old_weights, np.float32) != 0
            if old_weights is not None else np.ones_like(old_mask, bool))
        new_mask = np.asarray(new_mask, bool) & (weights != 0)
        ar, ac = np.nonzero(new_mask & ~old_mask)
        dr, dc = np.nonzero(old_mask & ~new_mask)
        if old_weights is not None:
            both = old_mask & new_mask
            both &= np.asarray(old_weights, np.float32) != weights
            rr, rc = np.nonzero(both)
        else:
            rr = rc = np.zeros(0, np.int64)
        return cls(
            n_rows=int(weights.shape[0]), n_cols=int(weights.shape[1]),
            add_rows=ar.astype(np.int32), add_cols=ac.astype(np.int32),
            add_vals=weights[ar, ac].astype(np.float32),
            drop_rows=dr.astype(np.int32), drop_cols=dc.astype(np.int32),
            reval_rows=rr.astype(np.int32), reval_cols=rc.astype(np.int32),
            reval_vals=weights[rr, rc].astype(np.float32)
            if old_weights is not None else np.zeros(0, np.float32))

    # -- views -------------------------------------------------------------
    @property
    def n_added(self) -> int:
        return int(self.add_rows.size)

    @property
    def n_removed(self) -> int:
        return int(self.drop_rows.size)

    @property
    def n_revalued(self) -> int:
        return int(self.reval_rows.size)

    @property
    def is_empty(self) -> bool:
        return not (self.n_added or self.n_removed or self.n_revalued)

    def affected_rows(self) -> np.ndarray:
        """Sorted unique rows any group touches."""
        return np.unique(np.concatenate([
            np.asarray(self.add_rows, np.int64),
            np.asarray(self.drop_rows, np.int64),
            np.asarray(self.reval_rows, np.int64)]))

    def __repr__(self) -> str:  # compact: arrays are noise in logs
        return (f"PatternDelta({self.n_rows}x{self.n_cols} "
                f"+{self.n_added} -{self.n_removed} ~{self.n_revalued})")

    # -- application -------------------------------------------------------
    def apply_to(self, matrix: SparseMatrix) -> SparseMatrix:
        """The mutated matrix: ``matrix`` with this delta applied."""
        if (matrix.n_rows, matrix.n_cols) != (self.n_rows, self.n_cols):
            raise ValueError(
                f"delta is for a {self.n_rows}x{self.n_cols} matrix, got "
                f"{matrix.n_rows}x{matrix.n_cols}")
        keys = _keys(matrix.rows, matrix.cols, matrix.n_cols)
        vals = matrix.vals.copy()
        if self.n_revalued:
            rk = _keys(np.asarray(self.reval_rows),
                       np.asarray(self.reval_cols), self.n_cols)
            pos = np.searchsorted(keys, rk)
            ok = (pos < keys.size)
            ok &= keys[np.minimum(pos, keys.size - 1)] == rk
            vals[pos[ok]] = np.asarray(self.reval_vals, np.float32)[ok]
            # a revalue of an entry the matrix doesn't hold is an add
            extra = ~ok
        else:
            extra = np.zeros(0, bool)
        keep = np.ones(keys.size, bool)
        if self.n_removed:
            dk = _keys(np.asarray(self.drop_rows),
                       np.asarray(self.drop_cols), self.n_cols)
            keep &= ~_member(keys, np.sort(dk))
        rows = [matrix.rows[keep]]
        cols = [matrix.cols[keep]]
        vs = [vals[keep]]
        if self.n_added:
            rows.append(np.asarray(self.add_rows, np.int32))
            cols.append(np.asarray(self.add_cols, np.int32))
            vs.append(np.asarray(self.add_vals, np.float32))
        if extra.any():
            rows.append(np.asarray(self.reval_rows, np.int32)[extra])
            cols.append(np.asarray(self.reval_cols, np.int32)[extra])
            vs.append(np.asarray(self.reval_vals, np.float32)[extra])
        return SparseMatrix(self.n_rows, self.n_cols,
                            np.concatenate(rows).astype(np.int32),
                            np.concatenate(cols).astype(np.int32),
                            np.concatenate(vs).astype(np.float32)).canonical()


def same_pattern(a: SparseMatrix, b: SparseMatrix) -> bool:
    """True when the two canonical matrices are identical (pattern and
    values) — the cheap guard the manager uses to skip catch-up patching."""
    return (a.n_rows == b.n_rows and a.n_cols == b.n_cols
            and a.rows.size == b.rows.size
            and bool(np.array_equal(a.rows, b.rows))
            and bool(np.array_equal(a.cols, b.cols))
            and bool(np.array_equal(a.vals, b.vals)))
