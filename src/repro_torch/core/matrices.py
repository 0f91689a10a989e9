"""Sparse-matrix containers, synthetic SuiteSparse-like generators, MatrixMarket IO.

The paper evaluates 843 matrices from the SuiteSparse Matrix Collection.
This container has no network access, so we generate a deterministic
synthetic suite spanning the same axes the paper analyses (Figures 9/11/13):
matrix size (nnz) and row-length variance (regularity -> irregularity).
Real ``.mtx`` files are also supported via :func:`read_matrix_market`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "SparseMatrix",
    "random_uniform_matrix",
    "banded_matrix",
    "powerlaw_matrix",
    "blocked_matrix",
    "hyb_friendly_matrix",
    "make_suite",
    "read_matrix_market",
    "write_matrix_market",
]


@dataclasses.dataclass(frozen=True)
class SparseMatrix:
    """COO triplets, canonically sorted by (row, col). Ground truth for all formats."""

    n_rows: int
    n_cols: int
    rows: np.ndarray  # int32[nnz]
    cols: np.ndarray  # int32[nnz]
    vals: np.ndarray  # float32[nnz]

    def __post_init__(self):
        assert self.rows.shape == self.cols.shape == self.vals.shape
        assert self.rows.ndim == 1

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def row_lengths(self) -> np.ndarray:
        return np.bincount(self.rows, minlength=self.n_rows).astype(np.int64)

    def row_variance(self) -> float:
        """The paper's irregularity measure: variance of row lengths."""
        return float(np.var(self.row_lengths()))

    def avg_row_length(self) -> float:
        return self.nnz / max(self.n_rows, 1)

    def is_irregular(self) -> bool:
        """Paper section I: row-length variance > 100 => irregular."""
        return self.row_variance() > 100.0

    def to_dense(self) -> np.ndarray:
        dense = np.zeros((self.n_rows, self.n_cols), dtype=np.float64)
        np.add.at(dense, (self.rows, self.cols), self.vals.astype(np.float64))
        return dense

    def canonical(self) -> "SparseMatrix":
        """Sort by (row, col), merge duplicates, drop explicit zeros."""
        order = np.lexsort((self.cols, self.rows))
        r, c, v = self.rows[order], self.cols[order], self.vals[order]
        # merge duplicate coordinates
        if r.size:
            key = r.astype(np.int64) * self.n_cols + c.astype(np.int64)
            uniq, inv = np.unique(key, return_inverse=True)
            merged = np.zeros(uniq.shape[0], dtype=np.float64)
            np.add.at(merged, inv, v.astype(np.float64))
            r = (uniq // self.n_cols).astype(np.int32)
            c = (uniq % self.n_cols).astype(np.int32)
            v = merged.astype(np.float32)
        keep = v != 0.0
        return SparseMatrix(self.n_rows, self.n_cols,
                            r[keep].astype(np.int32), c[keep].astype(np.int32),
                            v[keep].astype(np.float32))

    def spmv_dense_oracle(self, x: np.ndarray) -> np.ndarray:
        """Reference y = A @ x in float64, the ground-truth oracle for every test."""
        y = np.zeros(self.n_rows, dtype=np.float64)
        np.add.at(y, self.rows, self.vals.astype(np.float64) * x[self.cols].astype(np.float64))
        return y

    def spmm_dense_oracle(self, x: np.ndarray) -> np.ndarray:
        """Reference Y = A @ X in float64 for a multi-RHS tile X (n_cols, B)."""
        y = np.zeros((self.n_rows, x.shape[1]), dtype=np.float64)
        np.add.at(y, self.rows,
                  self.vals.astype(np.float64)[:, None]
                  * x[self.cols].astype(np.float64))
        return y


def _finalize(n_rows: int, n_cols: int, rows, cols, vals) -> SparseMatrix:
    m = SparseMatrix(n_rows, n_cols,
                     np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                     np.asarray(vals, np.float32))
    return m.canonical()


def random_uniform_matrix(n_rows: int, n_cols: int, density: float, seed: int) -> SparseMatrix:
    """Uniformly random pattern: regular (low row variance)."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(n_rows * n_cols * density))
    rows = rng.integers(0, n_rows, nnz)
    cols = rng.integers(0, n_cols, nnz)
    vals = rng.standard_normal(nnz)
    return _finalize(n_rows, n_cols, rows, cols, vals)


def banded_matrix(n: int, bandwidth: int, seed: int) -> SparseMatrix:
    """Banded/stencil pattern (e.g. PDE discretisations): very regular."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-bandwidth, bandwidth + 1)
    rows = np.repeat(np.arange(n), offs.size)
    cols = rows.reshape(n, offs.size) + offs[None, :]
    cols = cols.ravel()
    mask = (cols >= 0) & (cols < n)
    rows, cols = rows[mask], cols[mask]
    vals = rng.standard_normal(rows.size)
    return _finalize(n, n, rows, cols, vals)


def powerlaw_matrix(n_rows: int, n_cols: int, avg_nnz_per_row: float,
                    alpha: float, seed: int) -> SparseMatrix:
    """Scale-free / power-law row lengths: the paper's 'irregular' regime.

    ``alpha`` controls skew (higher => heavier tail => higher row variance).
    """
    rng = np.random.default_rng(seed)
    raw = rng.pareto(max(alpha, 0.05), n_rows) + 1.0
    lengths = np.maximum(1, (raw / raw.mean() * avg_nnz_per_row)).astype(np.int64)
    lengths = np.minimum(lengths, n_cols)
    rows = np.repeat(np.arange(n_rows), lengths)
    cols = rng.integers(0, n_cols, int(lengths.sum()))
    vals = rng.standard_normal(rows.size)
    return _finalize(n_rows, n_cols, rows, cols, vals)


def blocked_matrix(n: int, block: int, blocks_per_row: int, seed: int) -> SparseMatrix:
    """Small dense blocks scattered in a sparse matrix (FEM-like)."""
    rng = np.random.default_rng(seed)
    nb = n // block
    rows_l, cols_l = [], []
    for bi in range(nb):
        bjs = rng.choice(nb, size=min(blocks_per_row, nb), replace=False)
        for bj in bjs:
            r, c = np.meshgrid(np.arange(block), np.arange(block), indexing="ij")
            rows_l.append((bi * block + r).ravel())
            cols_l.append((bj * block + c).ravel())
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = rng.standard_normal(rows.size)
    return _finalize(n, n, rows, cols, vals)


def hyb_friendly_matrix(n: int, base_len: int, n_long: int, long_len: int,
                        seed: int) -> SparseMatrix:
    """The GL7d19-like pattern from the paper's Limitations section: almost all
    rows balanced, a few rows several times longer."""
    rng = np.random.default_rng(seed)
    lengths = np.full(n, base_len, np.int64)
    lengths[rng.choice(n, n_long, replace=False)] = long_len
    lengths = np.minimum(lengths, n)
    rows = np.repeat(np.arange(n), lengths)
    cols = rng.integers(0, n, int(lengths.sum()))
    vals = rng.standard_normal(rows.size)
    return _finalize(n, n, rows, cols, vals)


def make_suite(scale: str = "small", seed: int = 0) -> dict[str, SparseMatrix]:
    """A deterministic matrix suite spanning the paper's regularity x size axes.

    scale='small' keeps nnz ~1e3-3e4 (CI-friendly); 'medium' ~1e5.
    """
    s = {"small": 1, "medium": 4}[scale]
    b = 256 * s
    suite = {
        # regular family
        "uniform_reg": random_uniform_matrix(4 * b, 4 * b, 8.0 / (4 * b), seed + 1),
        "banded": banded_matrix(4 * b, 4, seed + 2),
        "blocked": blocked_matrix(4 * b, 8, 3, seed + 3),
        # moderately irregular
        "powerlaw_mild": powerlaw_matrix(4 * b, 4 * b, 8.0, 3.0, seed + 4),
        "powerlaw_mid": powerlaw_matrix(4 * b, 4 * b, 8.0, 1.5, seed + 5),
        # highly irregular (scale-free)
        "powerlaw_hard": powerlaw_matrix(4 * b, 4 * b, 10.0, 0.8, seed + 6),
        "hyb_like": hyb_friendly_matrix(4 * b, 6, max(4 * b // 128, 4), 40 * 6, seed + 7),
        # small + wide
        "wide": random_uniform_matrix(b, 16 * b, 10.0 / (16 * b), seed + 8),
        "tall": powerlaw_matrix(8 * b, b, 4.0, 1.2, seed + 9),
    }
    return suite


def write_matrix_market(m: SparseMatrix, f) -> None:
    own = isinstance(f, str)
    fh = open(f, "w") if own else f
    try:
        fh.write("%%MatrixMarket matrix coordinate real general\n")
        fh.write(f"{m.n_rows} {m.n_cols} {m.nnz}\n")
        for r, c, v in zip(m.rows, m.cols, m.vals):
            fh.write(f"{int(r) + 1} {int(c) + 1} {float(v):.9g}\n")
    finally:
        if own:
            fh.close()


def read_matrix_market(f) -> SparseMatrix:
    """Minimal MatrixMarket coordinate reader (real/integer/pattern, general/symmetric)."""
    own = isinstance(f, str)
    fh = open(f) if own else f
    try:
        header = fh.readline().strip().lower().split()
        if not header or header[0] != "%%matrixmarket":
            raise ValueError("not a MatrixMarket file")
        field = header[3] if len(header) > 3 else "real"
        sym = header[4] if len(header) > 4 else "general"
        line = fh.readline()
        while line.startswith("%"):
            line = fh.readline()
        n_rows, n_cols, nnz = (int(t) for t in line.split())
        rows = np.empty(nnz, np.int64)
        cols = np.empty(nnz, np.int64)
        vals = np.ones(nnz, np.float64)
        for i in range(nnz):
            parts = fh.readline().split()
            rows[i] = int(parts[0]) - 1
            cols[i] = int(parts[1]) - 1
            if field != "pattern" and len(parts) > 2:
                vals[i] = float(parts[2])
        if sym == "symmetric":
            off = rows != cols
            rows = np.concatenate([rows, cols[off]])
            cols = np.concatenate([cols, rows[: nnz][off]])
            vals = np.concatenate([vals, vals[off]])
        return _finalize(n_rows, n_cols, rows, cols, vals)
    finally:
        if own:
            fh.close()
