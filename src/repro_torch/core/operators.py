"""Operators (paper Table II) adapted to the TPU hierarchy.

Every operator is a pure function ``MetadataSet -> MetadataSet`` with a
declared stage, parameter space (coarse grid for level-2 search, fine grid
for level-3 ML interpolation) and applicability rules (the paper's operator
dependencies, §IV-B).

GPU -> TPU operator mapping (DESIGN.md §2):

================  =====================  =======================================
paper (GPU)       here (TPU)             semantics
================  =====================  =======================================
COMPRESS          COMPRESS               drop zeros, canonicalise COO
SORT              SORT                   global row sort by desc length
SORT_SUB          SORT_SUB               per-branch row sort
BIN               BIN                    split rows into length bins (branches)
ROW_DIV           ROW_DIV                row stripes (branches)
COL_DIV           COL_DIV                column stripes (partial-sum branches)
BMTB_ROW_BLOCK    TILE_ROW_BLOCK         rows per Pallas grid tile
BMT_ROW_BLOCK     LANE_ROW_BLOCK         row-per-lane padded layout (ELL family)
BMT_NNZ_BLOCK     LANE_NNZ_BLOCK         nnz-balanced flat layout (merge/CSR5)
BMT(B)_PAD        LANE_PAD               pad tile widths to a multiple
SORT_BMTB         SORT_TILE              windowed sort (SELL-sigma analogue)
SET_RESOURCES     SET_RESOURCES          lanes/sublanes/backend knobs
THREAD_TOTAL_RED  LANE_TOTAL_RED         one row per lane, dense reduce
WARP_SEG_RED      SEG_SCAN_RED           in-tile segmented scan over nnz stream
WARP_BITMAP_RED   ONEHOT_MXU_RED         one-hot matmul reduce on the MXU
GMEM_ATOM_RED     GRID_ACC_RED combine   revisit output block across grid steps
SHMEM_OFFSET_RED  SCATTER_RED combine    segment-sum of tile partials
================  =====================  =======================================
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.design.registry import (OPERATOR_REGISTRY, Operator, OpSpec,
                                   STAGE_CONVERTING, STAGE_IMPLEMENTING,
                                   STAGE_MAPPING, get_operator,
                                   register_operator)
from .metadata import (Block, EllBucket, EllTileLayout, MetadataSet,
                       ReducePlan, SegTileLayout)

__all__ = ["OpSpec", "OPERATORS", "apply_op", "Operator",
           "STAGE_CONVERTING", "STAGE_MAPPING", "STAGE_IMPLEMENTING"]


# ``OpSpec`` and the ``Operator`` base class live in
# ``repro_torch.design.registry`` (the open extension surface) and are
# re-exported here for the historical import path.

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if m > 1 else max(x, 1)


def _resort_block_nnz(row_ids, rows, cols, vals, **kw) -> Block:
    order = np.lexsort((cols, rows))
    return Block(row_ids=row_ids.astype(np.int32), rows=rows[order].astype(np.int32),
                 cols=cols[order].astype(np.int32), vals=vals[order].astype(np.float32),
                 **kw)


def _permute_block_rows(block: Block, perm: np.ndarray) -> Block:
    """Reorder block rows by ``perm`` (new local r holds old local perm[r])."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return _resort_block_nnz(block.row_ids[perm], inv[block.rows].astype(np.int32),
                             block.cols, block.vals,
                             col_base=block.col_base, col_span=block.col_span,
                             tile_rows=block.tile_rows, pad_to=block.pad_to,
                             sort_tile=block.sort_tile)


def _split_block_rows(block: Block, boundaries: Sequence[int]) -> list[Block]:
    """Split a block into contiguous local-row ranges [b_i, b_{i+1})."""
    out = []
    row_ptr = np.concatenate([[0], np.cumsum(block.row_lengths())]).astype(np.int64)
    for lo, hi in zip(boundaries[:-1], boundaries[1:]):
        if hi <= lo:
            continue
        nlo, nhi = row_ptr[lo], row_ptr[hi]
        out.append(Block(row_ids=block.row_ids[lo:hi],
                         rows=(block.rows[nlo:nhi] - lo).astype(np.int32),
                         cols=block.cols[nlo:nhi], vals=block.vals[nlo:nhi],
                         col_base=block.col_base, col_span=block.col_span))
    return out


# ------------------------------ converting --------------------------------

@register_operator("COMPRESS")
class Compress(Operator):
    """Paper COMPRESS: ignore all zeros; canonicalise the COO stream."""

    name, stage = "COMPRESS", STAGE_CONVERTING

    @staticmethod
    def applicable(meta):
        return not meta.compressed

    @staticmethod
    def apply(meta, spec):
        blocks = []
        for b in meta.blocks:
            keep = b.vals != 0.0
            blocks.append(_resort_block_nnz(b.row_ids, b.rows[keep], b.cols[keep],
                                            b.vals[keep]))
        return dataclasses.replace(meta.with_blocks(blocks, spec.label()),
                                   compressed=True)


@register_operator("SORT")
class Sort(Operator):
    """Paper SORT: global decreasing row-length sort (JAD/SELL-sigma style)."""

    name, stage = "SORT", STAGE_CONVERTING

    @staticmethod
    def applicable(meta):
        return meta.compressed and len(meta.blocks) == 1

    @staticmethod
    def apply(meta, spec):
        b = meta.blocks[0]
        perm = np.argsort(-b.row_lengths(), kind="stable").astype(np.int32)
        return meta.with_blocks([_permute_block_rows(b, perm)], spec.label())


@register_operator("SORT_SUB")
class SortSub(Operator):
    """Paper SORT_SUB: sort rows by length within each branch.

    With a single branch (e.g. a degenerate BIN that produced one bin)
    this degenerates to SORT — still applicable."""

    name, stage = "SORT_SUB", STAGE_CONVERTING

    @staticmethod
    def applicable(meta):
        return meta.compressed

    @staticmethod
    def apply(meta, spec):
        blocks = []
        for b in meta.blocks:
            perm = np.argsort(-b.row_lengths(), kind="stable").astype(np.int32)
            blocks.append(_permute_block_rows(b, perm))
        return meta.with_blocks(blocks, spec.label())


@register_operator("BIN")
class Bin(Operator):
    """Paper BIN (ACSR-style): group rows into branches by length bins."""

    name, stage = "BIN", STAGE_CONVERTING
    divides = True

    @staticmethod
    def coarse_grid(meta=None):
        return [{"n_bins": 2}, {"n_bins": 4}]

    @staticmethod
    def fine_grid(meta=None):
        return [{"n_bins": k} for k in (2, 3, 4, 6, 8)]

    @staticmethod
    def applicable(meta):
        return meta.compressed and len(meta.blocks) == 1

    @staticmethod
    def apply(meta, spec):
        n_bins = int(spec.param("n_bins", 2))
        b = meta.blocks[0]
        lengths = b.row_lengths()
        # geometric (power-of-two) bin boundaries, ACSR-style
        logs = np.ceil(np.log2(np.maximum(lengths, 1))).astype(np.int64)
        edges = np.unique(np.quantile(logs, np.linspace(0, 1, n_bins + 1)[1:-1]))
        bin_of = np.searchsorted(edges, logs, side="left")
        blocks = []
        for k in np.unique(bin_of):
            sel = np.where(bin_of == k)[0].astype(np.int32)
            perm = sel  # keep original relative order within bin
            mask = np.isin(b.rows, sel)
            remap = np.full(b.n_block_rows, -1, np.int32)
            remap[sel] = np.arange(sel.size, dtype=np.int32)
            blocks.append(_resort_block_nnz(b.row_ids[perm],
                                            remap[b.rows[mask]],
                                            b.cols[mask], b.vals[mask]))
        return meta.with_blocks(blocks, spec.label())


@register_operator("ROW_DIV")
class RowDiv(Operator):
    """Paper ROW_DIV: stripe rows into branches.

    strategy='even_rows' | 'even_nnz' | 'len_mutation' — the last is the
    paper's DIV_IN_ROW_LEN_MUTATION parameter-discretisation strategy.
    """

    name, stage = "ROW_DIV", STAGE_CONVERTING
    divides = True

    @staticmethod
    def coarse_grid(meta=None):
        return [{"strategy": "even_nnz", "parts": 2},
                {"strategy": "len_mutation", "factor": 8}]

    @staticmethod
    def fine_grid(meta=None):
        out = [{"strategy": s, "parts": p}
               for s in ("even_rows", "even_nnz") for p in (2, 3, 4)]
        out += [{"strategy": "len_mutation", "factor": f} for f in (4, 8, 16)]
        return out

    @staticmethod
    def applicable(meta):
        return meta.compressed and len(meta.blocks) == 1

    @staticmethod
    def apply(meta, spec):
        b = meta.blocks[0]
        strategy = spec.param("strategy", "even_rows")
        n = b.n_block_rows
        if strategy == "even_rows":
            parts = int(spec.param("parts", 2))
            bounds = np.linspace(0, n, parts + 1).astype(np.int64)
        elif strategy == "even_nnz":
            parts = int(spec.param("parts", 2))
            row_ptr = np.concatenate([[0], np.cumsum(b.row_lengths())])
            targets = np.linspace(0, b.nnz, parts + 1)[1:-1]
            bounds = np.concatenate([[0], np.searchsorted(row_ptr, targets), [n]])
        else:  # len_mutation: split where row length jumps by >= factor
            factor = float(spec.param("factor", 8))
            lengths = np.maximum(b.row_lengths(), 1)
            ratio = np.maximum(lengths[1:], lengths[:-1]) / np.minimum(
                lengths[1:], lengths[:-1])
            cuts = np.where(ratio >= factor)[0] + 1
            # discretise: keep at most 7 cut points (largest mutations first)
            if cuts.size > 7:
                mags = ratio[cuts - 1]
                cuts = np.sort(cuts[np.argsort(-mags)[:7]])
            bounds = np.concatenate([[0], cuts, [n]])
        bounds = np.unique(bounds)
        return meta.with_blocks(_split_block_rows(b, bounds), spec.label())


@register_operator("HYB_SPLIT")
class HybSplit(Operator):
    """BEYOND-PAPER operator: HYB-style per-row decomposition.

    The paper's §VII-H names this its main limitation ("the matrix
    decomposition strategy of HYB ... has not been included", losing to
    HYB on GL7d19-like matrices). We add it to the operator set: split
    every row at position ``width`` — the first ``width`` non-zeros per
    row form a regular branch (ELL-friendly), the overflow forms an
    irregular branch (nnz-split-friendly). Branch outputs overlap in rows
    and sum via the scatter combine, so any per-branch design composes.

    width is quantile-parameterised (the paper's parameter-discretisation
    trick): width = ceil(quantile q of non-empty row lengths).
    """

    name, stage = "HYB_SPLIT", STAGE_CONVERTING
    divides = True

    @staticmethod
    def coarse_grid(meta=None):
        return [{"q": 0.5}, {"q": 0.9}]

    @staticmethod
    def fine_grid(meta=None):
        return [{"q": q} for q in (0.25, 0.5, 0.75, 0.9, 0.95)]

    @staticmethod
    def applicable(meta):
        return meta.compressed and len(meta.blocks) == 1

    @staticmethod
    def apply(meta, spec):
        q = float(spec.param("q", 0.75))
        b = meta.blocks[0]
        lengths = b.row_lengths()
        nonzero = lengths[lengths > 0]
        if nonzero.size == 0:
            return meta.with_blocks([b], spec.label())
        width = max(1, int(np.ceil(np.quantile(nonzero, q))))
        row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
        pos = np.arange(b.nnz, dtype=np.int64) - row_ptr[b.rows]
        reg = pos < width
        blocks = [_resort_block_nnz(b.row_ids, b.rows[reg], b.cols[reg],
                                    b.vals[reg])]
        if (~reg).any():
            blocks.append(_resort_block_nnz(b.row_ids, b.rows[~reg],
                                            b.cols[~reg], b.vals[~reg]))
        return meta.with_blocks(blocks, spec.label())


@register_operator("COL_DIV")
class ColDiv(Operator):
    """Paper COL_DIV: stripe columns; branches produce partial sums of y."""

    name, stage = "COL_DIV", STAGE_CONVERTING
    divides = True

    @staticmethod
    def coarse_grid(meta=None):
        return [{"parts": 2}]

    @staticmethod
    def fine_grid(meta=None):
        return [{"parts": p} for p in (2, 3, 4)]

    @staticmethod
    def applicable(meta):
        return meta.compressed and len(meta.blocks) == 1

    @staticmethod
    def apply(meta, spec):
        parts = int(spec.param("parts", 2))
        b = meta.blocks[0]
        bounds = np.linspace(0, meta.n_cols, parts + 1).astype(np.int64)
        blocks = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            mask = (b.cols >= lo) & (b.cols < hi)
            if not mask.any():
                continue
            blocks.append(_resort_block_nnz(
                b.row_ids, b.rows[mask], b.cols[mask], b.vals[mask],
                col_base=int(lo), col_span=int(hi - lo)))
        return meta.with_blocks(blocks, spec.label())


# ------------------------------- mapping ----------------------------------

@register_operator("TILE_ROW_BLOCK")
class TileRowBlock(Operator):
    """BMTB_ROW_BLOCK analogue: rows per Pallas grid tile."""

    name, stage = "TILE_ROW_BLOCK", STAGE_MAPPING
    before_layout = True

    @staticmethod
    def coarse_grid(meta=None):
        return [{"rows": r} for r in (8, 32, 128)]

    @staticmethod
    def fine_grid(meta=None):
        return [{"rows": r} for r in (8, 16, 24, 32, 48, 64, 96, 128, 192, 256)]

    @staticmethod
    def applicable(meta):
        return meta.compressed and all(b.layout is None for b in meta.blocks)

    @staticmethod
    def apply(meta, spec):
        rows = int(spec.param("rows", 8))
        return meta.with_blocks([b.replace(tile_rows=rows) for b in meta.blocks],
                                spec.label())


@register_operator("SORT_TILE")
class SortTile(Operator):
    """SORT_BMTB analogue: sort rows inside windows of `window` tiles
    (SELL-C-sigma's sigma). Requires TILE_ROW_BLOCK."""

    name, stage = "SORT_TILE", STAGE_MAPPING
    before_layout = True
    requires = ("TILE_ROW_BLOCK",)

    @staticmethod
    def coarse_grid(meta=None):
        return [{"window": 4}, {"window": 16}]

    @staticmethod
    def fine_grid(meta=None):
        return [{"window": w} for w in (2, 4, 8, 16, 32, 64)]

    @staticmethod
    def applicable(meta):
        return (meta.compressed
                and all(b.tile_rows is not None and b.layout is None
                        for b in meta.blocks))

    @staticmethod
    def apply(meta, spec):
        window = int(spec.param("window", 4))
        blocks = []
        for b in meta.blocks:
            span = max(b.tile_rows * window, 1)
            lengths = b.row_lengths()
            perm = np.arange(b.n_block_rows, dtype=np.int32)
            for lo in range(0, b.n_block_rows, span):
                hi = min(lo + span, b.n_block_rows)
                seg = np.argsort(-lengths[lo:hi], kind="stable")
                perm[lo:hi] = lo + seg
            blocks.append(_permute_block_rows(b, perm).replace(sort_tile=True))
        return meta.with_blocks(blocks, spec.label())


@register_operator("LANE_PAD")
class LanePad(Operator):
    """BMT(B)_PAD analogue: round tile widths up to a multiple (bucketing)."""

    name, stage = "LANE_PAD", STAGE_MAPPING
    before_layout = True

    @staticmethod
    def coarse_grid(meta=None):
        return [{"pad_to": 1}, {"pad_to": 8}]

    @staticmethod
    def fine_grid(meta=None):
        return [{"pad_to": p} for p in (1, 2, 4, 8, 16, 32)]

    @staticmethod
    def applicable(meta):
        return meta.compressed and all(b.layout is None for b in meta.blocks)

    @staticmethod
    def apply(meta, spec):
        pad_to = int(spec.param("pad_to", 8))
        return meta.with_blocks([b.replace(pad_to=pad_to) for b in meta.blocks],
                                spec.label())


def _build_ell_layout(b: Block) -> EllTileLayout:
    n = b.n_block_rows
    R = b.tile_rows or _ceil_to(max(n, 1), 8)
    n_tiles = max(1, math.ceil(n / R))
    lengths = b.row_lengths()
    lengths_pad = np.zeros(n_tiles * R, np.int64)
    lengths_pad[:n] = lengths
    w_per_tile = lengths_pad.reshape(n_tiles, R).max(axis=1)
    w_per_tile = np.maximum(_ceil_to(1, b.pad_to),
                            ((w_per_tile + b.pad_to - 1) // b.pad_to) * b.pad_to)
    w_per_tile = np.maximum(w_per_tile, 1)

    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    pos_in_row = np.arange(b.nnz, dtype=np.int64) - row_ptr[b.rows]
    tile_of_row = np.arange(n, dtype=np.int64) // R
    row_in_tile = np.arange(n, dtype=np.int64) % R

    # one pass routes every tile, row and nonzero to its width bucket: a
    # stable sort by bucket, then one contiguous slice per bucket (the
    # scatter positions are unique, so the arrays are those of a per-width
    # rescan)
    widths, bucket_of_tile = np.unique(w_per_tile, return_inverse=True)
    tile_order = np.argsort(bucket_of_tile, kind="stable")
    tile_start = np.searchsorted(bucket_of_tile[tile_order],
                                 np.arange(widths.size + 1))
    t_rank = np.empty(n_tiles, np.int64)
    t_rank[tile_order] = (np.arange(n_tiles)
                          - tile_start[bucket_of_tile[tile_order]])
    row_bucket = bucket_of_tile[tile_of_row]
    row_order = np.argsort(row_bucket, kind="stable")
    row_start = np.searchsorted(row_bucket[row_order],
                                np.arange(widths.size + 1))
    nz_bucket = row_bucket[b.rows]
    nz_order = np.argsort(nz_bucket, kind="stable")
    nz_start = np.searchsorted(nz_bucket[nz_order],
                               np.arange(widths.size + 1))

    buckets = []
    for k, w in enumerate(widths):
        Tb = int(tile_start[k + 1] - tile_start[k])
        vals = np.zeros((Tb, R, int(w)), np.float32)
        cols = np.zeros((Tb, R, int(w)), np.int32)
        rowmap = np.full((Tb, R), -1, np.int32)
        sel = nz_order[nz_start[k]:nz_start[k + 1]]
        r = b.rows[sel]
        at = (t_rank[tile_of_row[r]], row_in_tile[r], pos_in_row[sel])
        vals[at] = b.vals[sel]
        cols[at] = b.cols[sel]
        rows_here = row_order[row_start[k]:row_start[k + 1]]
        rowmap[t_rank[tile_of_row[rows_here]], row_in_tile[rows_here]] = \
            b.row_ids[rows_here]
        buckets.append(EllBucket(int(w), vals, cols, rowmap))
    return EllTileLayout(tile_rows=R, buckets=tuple(buckets))


@register_operator("LANE_ROW_BLOCK")
class LaneRowBlock(Operator):
    """BMT_ROW_BLOCK analogue: one row per lane, padded tiles (ELL family)."""

    name, stage = "LANE_ROW_BLOCK", STAGE_MAPPING
    builds_layout = "ell"

    @staticmethod
    def applicable(meta):
        return meta.compressed and all(b.layout is None for b in meta.blocks)

    @staticmethod
    def apply(meta, spec):
        blocks = [b.replace(layout=_build_ell_layout(b)) for b in meta.blocks]
        return meta.with_blocks(blocks, spec.label())


def _build_seg_layout(b: Block, chunk: int, lanes: int) -> SegTileLayout:
    nnz = max(b.nnz, 1)
    lanes = max(1, min(lanes, chunk))
    chunk = _ceil_to(chunk, lanes)
    sub = chunk // lanes
    pad_nnz = _ceil_to(nnz, chunk)
    T = pad_nnz // chunk

    rows = np.zeros(pad_nnz, np.int64)
    cols = np.zeros(pad_nnz, np.int32)
    vals = np.zeros(pad_nnz, np.float32)
    if b.nnz:
        rows[: b.nnz] = b.rows
        cols[: b.nnz] = b.cols
        vals[: b.nnz] = b.vals
        rows[b.nnz:] = b.rows[-1]  # padded entries: val 0, last real row

    tile_id = np.arange(pad_nnz, dtype=np.int64) // chunk
    new_row = np.ones(pad_nnz, bool)
    new_row[1:] = rows[1:] != rows[:-1]
    new_row[::chunk] = True  # tile boundaries restart the segment numbering
    c = np.cumsum(new_row)
    local = (c - c[tile_id * chunk]).astype(np.int64)  # 0-based within tile
    seg_rows = _ceil_to(int(local.max()) + 1, 8)

    rowmap = np.full((T, seg_rows), -1, np.int32)
    starts = np.where(new_row)[0]
    rowmap[tile_id[starts], local[starts]] = b.row_ids[rows[starts]]

    # CSR5-style segment descriptor: exclusive end of each in-tile segment.
    # Segment m of tile t ends where segment m+1 starts (or at `chunk`).
    seg_end = np.full((T, seg_rows), chunk, np.int32)
    pos_in_tile = (starts - tile_id[starts] * chunk).astype(np.int32)
    nxt = np.empty(starts.size, np.int32)
    nxt[:-1] = np.where(tile_id[starts[1:]] == tile_id[starts[:-1]],
                        pos_in_tile[1:], chunk)
    nxt[-1:] = chunk
    seg_end[tile_id[starts], local[starts]] = nxt

    shape = (T, sub, lanes)
    return SegTileLayout(vals=vals.reshape(shape), cols=cols.reshape(shape),
                         local_row=local.astype(np.int32).reshape(shape),
                         rowmap=rowmap, seg_end=seg_end, seg_rows=seg_rows)


@register_operator("LANE_NNZ_BLOCK")
class LaneNnzBlock(Operator):
    """BMT_NNZ_BLOCK analogue: nnz-balanced flat stream (merge/CSR5 family)."""

    name, stage = "LANE_NNZ_BLOCK", STAGE_MAPPING
    builds_layout = "seg"

    @staticmethod
    def coarse_grid(meta=None):
        return [{"chunk": 512}, {"chunk": 2048}]

    @staticmethod
    def fine_grid(meta=None):
        return [{"chunk": c} for c in (128, 256, 512, 1024, 2048, 4096, 8192)]

    @staticmethod
    def applicable(meta):
        return meta.compressed and all(b.layout is None for b in meta.blocks)

    @staticmethod
    def apply(meta, spec):
        chunk = int(spec.param("chunk", 1024))
        lanes = int(spec.param("lanes", 128))
        blocks = [b.replace(layout=_build_seg_layout(b, chunk, lanes))
                  for b in meta.blocks]
        return meta.with_blocks(blocks, spec.label())


@register_operator("SET_RESOURCES")
class SetResources(Operator):
    """Runtime knobs: lanes, fused-kernel megatile width, storage dtype.

    ``tiles_per_step`` (format tiles per fused-kernel grid step) and
    ``dtype`` ("float32" | "bfloat16" vals storage, fp32 accumulate) are
    recorded on the MetadataSet and consumed by ``plan_format`` — the
    DesignSpace weaves SET_RESOURCES specs into candidate graphs when the
    SearchConfig enables non-default choices, so the search picks them
    per matrix like any other design decision.
    """

    name, stage = "SET_RESOURCES", STAGE_MAPPING

    @staticmethod
    def coarse_grid(meta=None):
        return [{"lanes": 128}]

    @staticmethod
    def fine_grid(meta=None):
        return [{"lanes": l} for l in (64, 128, 256)]

    @staticmethod
    def apply(meta, spec):
        out = meta.with_blocks(list(meta.blocks), spec.label())
        kw = {}
        k = spec.param("tiles_per_step")
        if k is not None:
            kw["tiles_per_step"] = max(int(k), 1)
        d = spec.param("dtype")
        if d is not None:
            kw["storage_dtype"] = str(d)
        return dataclasses.replace(out, **kw) if kw else out


# ----------------------------- implementing -------------------------------

def _set_reduce(meta: MetadataSet, spec: OpSpec, kind: str,
                need_layout: type) -> MetadataSet:
    combine = spec.param("combine", "scatter")
    blocks = []
    for b in meta.blocks:
        if not isinstance(b.layout, need_layout):
            raise ValueError(f"{spec.name} needs {need_layout.__name__}, "
                             f"block has {type(b.layout).__name__}")
        blocks.append(b.replace(reduce=ReducePlan(kind=kind, combine=combine)))
    return meta.with_blocks(blocks, spec.label())


@register_operator("LANE_TOTAL_RED")
class LaneTotalRed(Operator):
    """THREAD_TOTAL_RED analogue: each lane owns a full row; dense reduce."""

    name, stage = "LANE_TOTAL_RED", STAGE_IMPLEMENTING
    is_reducer = True
    accepts_layouts = ("ell",)

    @staticmethod
    def coarse_grid(meta=None):
        return [{"combine": "scatter"}, {"combine": "grid_acc"}]

    fine_grid = coarse_grid

    @staticmethod
    def applicable(meta):
        return all(isinstance(b.layout, EllTileLayout) for b in meta.blocks)

    @staticmethod
    def apply(meta, spec):
        return _set_reduce(meta, spec, "lane_total", EllTileLayout)


@register_operator("SEG_SCAN_RED")
class SegScanRed(Operator):
    """WARP_SEG_RED analogue: segmented scan over the in-tile nnz stream."""

    name, stage = "SEG_SCAN_RED", STAGE_IMPLEMENTING
    is_reducer = True
    accepts_layouts = ("seg",)

    @staticmethod
    def coarse_grid(meta=None):
        return [{"combine": "scatter"}]

    fine_grid = coarse_grid

    @staticmethod
    def applicable(meta):
        return all(isinstance(b.layout, SegTileLayout) for b in meta.blocks)

    @staticmethod
    def apply(meta, spec):
        return _set_reduce(meta, spec, "seg_scan", SegTileLayout)


@register_operator("ONEHOT_MXU_RED")
class OneHotMxuRed(Operator):
    """TPU-native reduction: products x one-hot(local_row) matmul on the MXU.

    Replaces the GPU bitmap/shuffle reductions (no TPU analogue exists for
    those — DESIGN.md D5); turns the irregular reduce into dense MXU work.
    """

    name, stage = "ONEHOT_MXU_RED", STAGE_IMPLEMENTING
    is_reducer = True
    accepts_layouts = ("seg",)

    @staticmethod
    def coarse_grid(meta=None):
        return [{"combine": "scatter"}]

    fine_grid = coarse_grid

    @staticmethod
    def applicable(meta):
        return all(isinstance(b.layout, SegTileLayout) for b in meta.blocks)

    @staticmethod
    def apply(meta, spec):
        return _set_reduce(meta, spec, "onehot_mxu", SegTileLayout)


@register_operator("GMEM_ATOM_RED")
class GmemAtomRed(Operator):
    """Paper GMEM_ATOM_RED: add every product directly into y.

    On GPU this is a global-memory atomicAdd per non-zero (row-grouped
    CSR's reduction). TPU has no atomics, so the data path is a single
    global scatter-add of the flat product stream — XLA lowers it to a
    deterministic sort-based combiner; the Pallas backend falls back to
    the in-tile scan + scatter (DESIGN.md §2, atomics row). Despite the
    name it is often the FASTEST reduction for nnz-balanced layouts on
    backends with good native scatter (e.g. XLA:CPU), which is exactly
    why the paper keeps it in the operator set."""

    name, stage = "GMEM_ATOM_RED", STAGE_IMPLEMENTING
    is_reducer = True
    accepts_layouts = ("seg",)

    @staticmethod
    def coarse_grid(meta=None):
        return [{"combine": "scatter"}]

    fine_grid = coarse_grid

    @staticmethod
    def applicable(meta):
        return all(isinstance(b.layout, SegTileLayout) for b in meta.blocks)

    @staticmethod
    def apply(meta, spec):
        return _set_reduce(meta, spec, "gmem_atom", SegTileLayout)


# ``OPERATORS`` *is* the process-wide registry (same dict object), so
# out-of-tree operators registered via ``repro_torch.design.register_operator``
# are visible through this historical surface too.
OPERATORS: dict[str, type[Operator]] = OPERATOR_REGISTRY


def apply_op(meta: MetadataSet, spec: OpSpec) -> MetadataSet:
    return get_operator(spec.name).apply(meta, spec)
