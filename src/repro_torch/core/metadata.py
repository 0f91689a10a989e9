"""Matrix Metadata Set (paper §V-A), adapted to pure-functional JAX style.

The paper's Matrix Metadata Set is a mutable key-value database recording the
cumulative effect of every operator on the matrix. We realize it as an
immutable dataclass tree: every operator is a pure function
``MetadataSet -> MetadataSet`` (design decision D1 in DESIGN.md), which gives
replay, structural hashing for search memoization, and property testing.

State model
-----------
* ``MetadataSet`` — global matrix info + a list of ``Block`` branches
  (ROW_DIV / BIN create more than one block; the paper calls these branches
  of the Operator Graph).
* ``Block`` — one branch: a sub-matrix in local COO plus, after the mapping
  stage, a concrete memory ``layout`` and, after the implementing stage, a
  ``reduce`` plan.
* Layouts (``EllTileLayout`` / ``SegTileLayout``) are the TPU adaptation of
  the paper's BMTB/BMW/BMT block structures: tiles -> Pallas grid steps,
  8-row panels -> sublanes, 128 slots -> lanes (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .matrices import SparseMatrix

__all__ = [
    "Block",
    "MetadataSet",
    "EllBucket",
    "EllTileLayout",
    "SegTileLayout",
    "ReducePlan",
    "from_matrix",
]


@dataclasses.dataclass(frozen=True)
class EllBucket:
    """A batch of equal-width row-per-lane tiles (SELL 'slice' analogue).

    vals/cols: (T, R, W); rowmap: (T, R) original row id (-1 = padded row).
    Padded entries carry val=0, col=0 (safe gather).
    """

    width: int
    vals: np.ndarray
    cols: np.ndarray
    rowmap: np.ndarray

    @property
    def n_tiles(self) -> int:
        return self.vals.shape[0]

    @property
    def tile_rows(self) -> int:
        return self.vals.shape[1]

    def padded_nnz(self) -> int:
        return int(np.prod(self.vals.shape))

    def stored_bytes(self) -> int:
        return self.vals.nbytes + self.cols.nbytes + self.rowmap.nbytes


@dataclasses.dataclass(frozen=True)
class EllTileLayout:
    """Row-per-lane padded tile layout (ELL / SELL / row-grouped CSR family)."""

    tile_rows: int
    buckets: tuple[EllBucket, ...]
    rowmap_affine: Optional[tuple[int, int]] = None  # (a, b): rowmap[t,r] = a*(t*R+r)+b

    def padded_nnz(self) -> int:
        return sum(b.padded_nnz() for b in self.buckets)

    def stored_bytes(self) -> int:
        return sum(b.stored_bytes() for b in self.buckets)


@dataclasses.dataclass(frozen=True)
class SegTileLayout:
    """NNZ-balanced flat-stream layout (merge-based / CSR5 family).

    vals/cols/local_row: (T, S, L) — T grid tiles of S sublanes x L lanes.
    ``local_row`` is the row slot within the tile, in [0, seg_rows);
    ``rowmap``: (T, seg_rows) original row id per slot (-1 = unused);
    ``seg_end``: (T, seg_rows) exclusive end position (within-tile flat
    index) of each segment — the CSR5-style segment descriptor consumed by
    the SEG_SCAN_RED kernel (cumsum + gather + diff).
    """

    vals: np.ndarray
    cols: np.ndarray
    local_row: np.ndarray
    rowmap: np.ndarray
    seg_end: np.ndarray
    seg_rows: int

    @property
    def n_tiles(self) -> int:
        return self.vals.shape[0]

    def padded_nnz(self) -> int:
        return int(np.prod(self.vals.shape))

    def stored_bytes(self) -> int:
        return (self.vals.nbytes + self.cols.nbytes + self.local_row.nbytes
                + self.rowmap.nbytes + self.seg_end.nbytes)


Layout = "EllTileLayout | SegTileLayout"


@dataclasses.dataclass(frozen=True)
class ReducePlan:
    """Implementing-stage decision: in-tile reduction + cross-tile combine."""

    kind: str      # 'lane_total' | 'seg_scan' | 'onehot_mxu'
    combine: str   # 'scatter' | 'grid_acc'
    params: tuple = ()


@dataclasses.dataclass(frozen=True)
class Block:
    """One branch of the Operator Graph: a sub-matrix plus design decisions.

    ``rows`` are LOCAL row indices into ``row_ids`` (the original row id
    array, in current — possibly sorted — order). nnz sorted by (row, col).
    """

    row_ids: np.ndarray           # int32[block_rows] original row ids
    rows: np.ndarray              # int32[nnz] local row index
    cols: np.ndarray              # int32[nnz]
    vals: np.ndarray              # float32[nnz]
    col_base: int = 0             # COL_DIV stripe offset into x
    col_span: Optional[int] = None
    tile_rows: Optional[int] = None     # set by TILE_ROW_BLOCK
    pad_to: int = 1                     # set by LANE_PAD
    sort_tile: bool = False             # set by SORT_TILE
    layout: Optional[object] = None     # set by LANE_*_BLOCK
    reduce: Optional[ReducePlan] = None

    @property
    def n_block_rows(self) -> int:
        return int(self.row_ids.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def row_lengths(self) -> np.ndarray:
        return np.bincount(self.rows, minlength=self.n_block_rows).astype(np.int64)

    def replace(self, **kw) -> "Block":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MetadataSet:
    """The full Matrix Metadata Set: global info + branch blocks + history.

    ``tiles_per_step`` / ``storage_dtype`` are the SET_RESOURCES runtime
    knobs (megatile width of the fused kernels; bf16-vs-fp32 format
    storage) — design decisions the search binds like any other parameter;
    the kernel generator reads them in ``plan_format``.
    """

    n_rows: int
    n_cols: int
    blocks: tuple[Block, ...]
    history: tuple[str, ...] = ()
    compressed: bool = False
    tiles_per_step: int = 1
    storage_dtype: str = "float32"

    @property
    def nnz(self) -> int:
        return sum(b.nnz for b in self.blocks)

    def with_blocks(self, blocks, op_name: str) -> "MetadataSet":
        return dataclasses.replace(self, blocks=tuple(blocks),
                                   history=self.history + (op_name,))

    def padded_nnz(self) -> int:
        total = 0
        for b in self.blocks:
            total += b.layout.padded_nnz() if b.layout is not None else b.nnz
        return total

    def stored_bytes(self) -> int:
        total = 0
        for b in self.blocks:
            if b.layout is not None:
                total += b.layout.stored_bytes()
            else:
                total += b.vals.nbytes + b.cols.nbytes + b.rows.nbytes
        return total


def from_matrix(m: SparseMatrix) -> MetadataSet:
    """Entry point: wrap an input matrix as an un-compressed MetadataSet."""
    block = Block(
        row_ids=np.arange(m.n_rows, dtype=np.int32),
        rows=m.rows.astype(np.int32),
        cols=m.cols.astype(np.int32),
        vals=m.vals.astype(np.float32),
    )
    return MetadataSet(m.n_rows, m.n_cols, (block,), history=("INPUT",))
