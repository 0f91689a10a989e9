"""Fixed-width sparsity feature vectors for the learned search strategy.

Copy of ``repro.corpus.features`` (numpy only). The corpus model (in the
reference, ``repro.corpus.model``) predicts good designs for an *unseen*
matrix from nothing but its sparsity statistics — the
ML-format-selection premise (Stylianou & Weiland, arXiv 2303.05098): the
features that drive the §VI-B pruning rules (size, row-length shape,
irregularity) plus locality structure (bandwidth, block score) separate
the format families well enough that a model trained on a few hundred
matrices ranks designs for a new one without timing anything.

Everything here is numpy-only and O(nnz log nnz) (one sorted-key pass for
the neighbour counts), so feature extraction is microseconds-to-
milliseconds — cheap enough to sit on the millisecond-class compile path.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.matrices import SparseMatrix

__all__ = ["CORPUS_FEATURE_NAMES", "matrix_features"]


# Order is the model's input contract: CorpusModel.save records this list
# and refuses to mix models trained on a different feature layout.
CORPUS_FEATURE_NAMES = [
    # size / density
    "log_rows", "log_cols", "log_nnz", "log_density",
    # row-length shape (the §VI-B pruning axes)
    "row_mean", "row_std", "row_cv", "log_row_var",
    # column-length shape (transpose irregularity)
    "col_cv",
    # locality structure
    "bandwidth_p95",      # p95 distance from the (scaled) diagonal / n_cols
    "block_score",        # fraction of nnz with a right/down neighbour
    # skew indicators
    "long_row_frac",      # rows longer than 4x the mean
    "empty_row_frac",
]


def matrix_features(m: SparseMatrix) -> np.ndarray:
    """The fixed feature vector (``CORPUS_FEATURE_NAMES`` order, float64).

    Relies on the ``SparseMatrix`` canonical (row, col) sort for the
    O(nnz log nnz) neighbour lookups."""
    nnz = max(m.nnz, 1)
    n_rows = max(m.n_rows, 1)
    n_cols = max(m.n_cols, 1)
    lengths = m.row_lengths().astype(np.float64)
    mean = float(lengths.mean()) if lengths.size else 0.0
    std = float(lengths.std()) if lengths.size else 0.0
    cv = std / mean if mean > 0 else 0.0
    row_var = float(np.var(lengths)) if lengths.size else 0.0
    col_lengths = np.bincount(np.asarray(m.cols, np.int64),
                              minlength=m.n_cols).astype(np.float64)
    cmean = float(col_lengths.mean()) if col_lengths.size else 0.0
    col_cv = float(col_lengths.std()) / cmean if cmean > 0 else 0.0

    if m.nnz:
        rows = np.asarray(m.rows, np.int64)
        cols = np.asarray(m.cols, np.int64)
        # distance from the aspect-scaled diagonal, as a fraction of width
        diag = np.abs(cols - rows * (n_cols / n_rows))
        bandwidth = float(np.percentile(diag, 95)) / n_cols
        # block structure: how often an nnz has its (r, c+1) / (r+1, c)
        # neighbour populated (dense sub-blocks -> both near 1)
        keys = rows * n_cols + cols              # ascending (canonical sort)
        right = keys + 1
        idx = np.searchsorted(keys, right)
        idx_c = np.minimum(idx, keys.size - 1)
        has_right = ((keys[idx_c] == right) & (idx < keys.size)
                     & (cols + 1 < n_cols))
        down = keys + n_cols
        idx = np.searchsorted(keys, down)
        idx_c = np.minimum(idx, keys.size - 1)
        has_down = ((keys[idx_c] == down) & (idx < keys.size)
                    & (rows + 1 < n_rows))
        block_score = 0.5 * (float(has_right.mean())
                             + float(has_down.mean()))
    else:
        bandwidth = 0.0
        block_score = 0.0

    long_frac = (float((lengths > 4.0 * max(mean, 1e-12)).mean())
                 if lengths.size else 0.0)
    empty_frac = float((lengths == 0).mean()) if lengths.size else 0.0

    return np.array([
        np.log10(n_rows), np.log10(n_cols), np.log10(nnz),
        np.log10(nnz / (float(n_rows) * float(n_cols))),
        mean, std, cv, np.log10(1.0 + row_var),
        col_cv,
        bandwidth, block_score,
        long_frac, empty_frac,
    ], dtype=np.float64)
