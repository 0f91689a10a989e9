"""SparseLinear: an AlphaSparse-generated SpMV plan as a serving-time layer
(port of ``repro.serve.sparse_linear``).

A magnitude-pruned linear layer's decode-time matvec ``y = W_sparse @ x``
is exactly SpMV. The recommended path prunes a dense weight and compiles
it through the one compile API::

    plan = repro_torch.compile(prune_magnitude(w, 0.1), target, budget=...)
    layer = SparseLinear.from_plan(plan)

``sparsify_linear`` and ``sparsify_linear_sharded`` remain as deprecated
one-call shims over that path (the second over a sharded compile).

For batched decode, the layer hands the whole activation batch to the
plan's multi-RHS (SpMM) path: the (B, n_cols) batch is transposed to the
plan's (n_cols, B) convention, the format is read once for all B columns
(kernels K7-K11), and the result transposes back to (B, n_rows). Plans
advertise this with ``supports_batch = True``; other program types are
called once per row.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core.deprecation import warn_once
from repro_torch.core.graph import OperatorGraph
from repro_torch.core.matrices import SparseMatrix
from repro_torch.core.search import ProgramCache, SearchConfig
from repro_torch.design.registry import OpSpec

__all__ = ["SparseLinear", "sparsify_linear", "sparsify_linear_sharded",
           "prune_magnitude"]


def prune_magnitude(w: np.ndarray, density: float) -> SparseMatrix:
    """Keep exactly k = max(1, floor(size * density)) largest-|w| entries.

    Ties at the magnitude threshold break deterministically toward the
    lower row-major flat index, so the result is exactly-k nnz and
    reproducible (bit-identical to the reference's)."""
    flat = np.abs(w).ravel()
    k = max(1, int(flat.size * density))
    order = np.lexsort((np.arange(flat.size), -flat))
    keep = np.sort(order[:k])
    rows, cols = np.unravel_index(keep, w.shape)
    return SparseMatrix(w.shape[0], w.shape[1], rows.astype(np.int32),
                        cols.astype(np.int32),
                        w[rows, cols].astype(np.float32)).canonical()


@dataclasses.dataclass
class SparseLinear:
    """y = A @ x with A in an AlphaSparse machine-designed format."""

    matrix: Optional[SparseMatrix]
    graph: Optional[OperatorGraph]
    program: object            # SpmvPlan | ShardedSpmvPlan | SpmvProgram
    search_gflops: Optional[float] = None

    @classmethod
    def from_plan(cls, plan, matrix: Optional[SparseMatrix] = None
                  ) -> "SparseLinear":
        """Wrap a compiled ``repro_torch.SpmvPlan`` as a serving layer."""
        return cls(matrix, getattr(plan, "graph", None), plan,
                   getattr(plan, "search_gflops", None))

    def update(self, delta) -> "SparseLinear":
        """Dynamic-sparsity step: patch the plan in place
        (``SpmvPlan.update``) and apply the delta to the attached matrix,
        returning a new layer; this layer and its plan are left as they
        were. Raises ``repro_torch.dyn.CapacityError`` when the delta
        does not fit the plan's format."""
        new_program = self.program.update(delta)
        new_matrix = (delta.apply_to(self.matrix)
                      if self.matrix is not None else None)
        return dataclasses.replace(self, matrix=new_matrix,
                                   program=new_program)

    def __call__(self, x) -> torch.Tensor:
        """x: (n_cols,) or (B, n_cols) -> (n_rows,) or (B, n_rows), on the
        program's device. A numpy x is copied there by the plan."""
        if x.ndim == 1:
            return self.program(x)
        if getattr(self.program, "supports_batch", False):
            # multi-RHS: the plan's convention is (n_cols, B) columns
            return self.program(x.T).T
        return torch.stack([self.program(xi) for xi in x])

    @property
    def density(self) -> Optional[float]:
        """nnz / (n_rows * n_cols). Prefers the wrapped matrix; a layer
        built with ``from_plan(plan)`` derives it from the plan's stored
        geometry. None, with a warning, when neither carries it."""
        if self.matrix is not None:
            return self.matrix.nnz / (self.matrix.n_rows * self.matrix.n_cols)
        nnz = getattr(self.program, "nnz", None)
        n_rows = getattr(self.program, "n_rows", None)
        n_cols = getattr(self.program, "n_cols", None)
        if nnz is not None and n_rows and n_cols:
            return nnz / (n_rows * n_cols)
        warnings.warn(
            "SparseLinear.density is unknown: no matrix is attached and "
            f"the program ({type(self.program).__name__}) does not carry "
            "nnz/n_rows/n_cols; pass the matrix to from_plan(plan, matrix)",
            RuntimeWarning, stacklevel=2)
        return None


_DEFAULT_GRAPH = OperatorGraph.chain(
    OpSpec.make("COMPRESS"),
    OpSpec.make("TILE_ROW_BLOCK", rows=8),
    OpSpec.make("SORT_TILE", window=8),
    OpSpec.make("LANE_ROW_BLOCK"),
    OpSpec.make("LANE_TOTAL_RED", combine="scatter"))


def sparsify_linear(w: np.ndarray, density: float = 0.1,
                    search_config: Optional[SearchConfig] = None,
                    do_search: bool = True,
                    cache: Optional[ProgramCache] = None) -> SparseLinear:
    """Deprecated shim: prune + ``repro_torch.compile`` + ``SparseLinear``.

    ``do_search=False`` skips the search and uses a default graph.
    ``cache`` lets serving restarts reuse a prior search for the same
    pruned weight; set ``search_config.batch_size`` to the serving decode
    batch so that the design is tuned for the multi-RHS path. The plan
    runs on ``search_config.backend`` (``"cuda"`` by default)."""
    warn_once("sparsify_linear",
              "sparsify_linear is deprecated; use repro_torch.compile("
              "prune_magnitude(w, density), target) and "
              "SparseLinear.from_plan(plan)")
    from repro_torch.api import Target, compile as _compile
    m = prune_magnitude(np.asarray(w), density)
    cfg = search_config or SearchConfig(max_seconds=30, max_structures=8)
    target = Target(backend=cfg.backend, batch_size=max(cfg.batch_size, 1))
    if do_search:
        plan = _compile(m, target, budget=cfg, cache=cache)
        return SparseLinear(m, plan.graph, plan, plan.search_gflops)
    plan = _compile(m, target, graph=_DEFAULT_GRAPH)
    return SparseLinear(m, _DEFAULT_GRAPH, plan)


def sparsify_linear_sharded(w: np.ndarray, mesh, density: float = 0.1,
                            do_search: bool = False,
                            dist_config=None) -> SparseLinear:
    """Deprecated shim: prune + sharded ``repro_torch.compile``.

    The pruned weight is partitioned over the mesh's ``data`` axis and
    each shard gets its own design (heuristic by default; ``do_search=True``
    runs one AlphaSparse search per shard). The returned layer's program is
    a ``ShardedSpmvPlan``, whose per-family stacked formats hold one slice
    a shard."""
    warn_once("sparsify_linear_sharded",
              "sparsify_linear_sharded is deprecated; use repro_torch."
              "compile(prune_magnitude(w, density), Target(mesh=mesh)) and "
              "SparseLinear.from_plan(plan)")
    from repro_torch.api import Target, compile as _compile
    from repro_torch.dist.search import ShardedSearchConfig

    m = prune_magnitude(np.asarray(w), density)
    cfg = dist_config or ShardedSearchConfig()
    target = Target(backend=cfg.backend, interpret=cfg.interpret, mesh=mesh,
                    axis_name=cfg.axis_name, partition=cfg.mode,
                    balance=cfg.balance)
    plan = _compile(m, target, budget=cfg if do_search else None)
    return SparseLinear(m, None, plan)
