"""Sharded SpMV: partition a SparseMatrix over the ``data`` axis of a
:class:`~repro_torch.dist.mesh.DataMesh` and run one machine-designed
program per shard (port of ``repro.dist.spmv``).

AlphaSparse designs a format *per matrix*; here the mesh is one more level
of the hardware hierarchy, so the unit of design becomes the *shard*: each
partition may get a different machine-designed format (an irregular shard
a SEG design, a regular one ELL; see ``dist.search``).

Execution model, as in the reference: per-shard formats are **stacked per
kernel family**. Every shard's format is canonicalized into a few family
groups (``ell``: every width bucket re-tiled to (8, 8) chunks; one ``seg``
group per (reduce kind, S, L)), padded to the family's largest tile count
and stacked with a leading shard axis. Shard i's operands are slice i of
every stack, on ``mesh.devices[i]``; tiles of families a shard lacks are
padding (val 0, rowmap -1) that add nothing. The body is
``core.kernel_builder.build_kernel`` on a synthetic spec: on the ``cuda``
backend it launches the ported kernels (K1/K7 for the ELL family,
K3/K4/K10 for seg) and adds the tile partials into y through
``kernels.combine.rowmap_combine`` in an order fixed when the operands
are placed, so a call's bits never change from call to call.

Where the reference runs the shards in one ``shard_map`` over devices, the
port runs the body once per shard, each on its shard's device. Where all
shards share one device, as on a one-card machine (and the tests' CPU
mesh), it runs the body once over the folded operands
(:func:`fold_operands`): every stack viewed as one longer tile axis, shard
i's rowmap moved to rows [i n_out, (i + 1) n_out) of one output, so a
call launches one family kernel and one combine a step, and each shard's
sums are the ones its own run would give, bit for bit.

Two partition modes:

* ``row`` — shard i owns a contiguous row band (boundaries balanced by
  rows or by nnz). x is given to every shard; each emits its padded band
  of y, and the bands are sliced to size and concatenated on
  ``mesh.devices[0]``.
* ``col`` — the distributed analogue of the paper's COL_DIV operator:
  shard i owns a uniform column slice of a zero-padded x and computes a
  full-length *partial* y; :func:`psum` adds the partials in shard order
  (the reference's ``lax.psum``).

The host-side packing keeps the reference's numpy semantics on CPU
tensors (bf16 needs torch): ``partition_matrix``, ``pack_operand_format``
and the stacks are bit-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.graph import OperatorGraph, run_graph
from repro_torch.core.kernel_builder import (SPEC_VERSION, SpmvProgram,
                                             build_kernel, build_program,
                                             materialize_cols)
from repro_torch.core.matrices import SparseMatrix
from repro_torch.design.registry import OpSpec

__all__ = ["RowShard", "partition_matrix", "ShardedSpmvProgram",
           "build_sharded_spmv", "shard_map_spmv", "default_shard_graph",
           "pack_operand_format", "ShardOperands", "MeshOperands",
           "place_operands", "fold_operands", "psum"]


def _axis_size(mesh, axis_name: str) -> int:
    sizes = dict(mesh.shape)
    if axis_name not in sizes:
        raise ValueError(f"mesh has no {axis_name!r} axis (axes: "
                         f"{tuple(sizes)}); build one with "
                         "repro_torch.dist.make_data_mesh")
    return int(sizes[axis_name])


@dataclasses.dataclass(frozen=True)
class RowShard:
    """One partition: a local-index-space sub-matrix plus its global slice.

    ``row`` mode: rows [start, stop) of the global matrix, all columns.
    ``col`` mode: cols [start, stop) of the global matrix, all rows.
    """

    index: int
    start: int
    stop: int
    matrix: SparseMatrix
    mode: str = "row"

    @property
    def size(self) -> int:
        return self.stop - self.start

    @property
    def is_empty(self) -> bool:
        return self.matrix.nnz == 0


def _row_boundaries(m: SparseMatrix, n_shards: int, balance: str) -> np.ndarray:
    if balance == "rows":
        return np.linspace(0, m.n_rows, n_shards + 1).astype(np.int64)
    # nnz-balanced: split the cumulative row-nnz curve into equal arcs, so a
    # power-law matrix doesn't starve most devices while one holds the tail.
    cum = np.concatenate([[0], np.cumsum(m.row_lengths())])
    targets = np.linspace(0, m.nnz, n_shards + 1)
    bounds = np.searchsorted(cum, targets, side="left")
    bounds[0], bounds[-1] = 0, m.n_rows
    return np.maximum.accumulate(bounds).astype(np.int64)


def partition_matrix(m: SparseMatrix, n_shards: int, mode: str = "row",
                     balance: str = "nnz") -> list[RowShard]:
    """Split ``m`` into ``n_shards`` contiguous shards in local index space.

    Shards may be empty (0 nnz, possibly 0 rows) when ``n_shards`` exceeds
    the number of populated bands; callers get a ``None`` program for those.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    shards = []
    if mode == "row":
        bounds = _row_boundaries(m, n_shards, balance)
        for i in range(n_shards):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            keep = (m.rows >= lo) & (m.rows < hi)
            sub = SparseMatrix(hi - lo, m.n_cols,
                               (m.rows[keep] - lo).astype(np.int32),
                               m.cols[keep].astype(np.int32),
                               m.vals[keep].astype(np.float32))
            shards.append(RowShard(i, lo, hi, sub, mode="row"))
    elif mode == "col":
        # uniform slice width: the sharded x layout must be an even split.
        # Trailing shards can be degenerate (n_shards*width > n_cols):
        # clamp both bounds to n_cols so shard bounds still tile [0, n_cols)
        width = -(-m.n_cols // n_shards)
        for i in range(n_shards):
            lo = min(i * width, m.n_cols)
            hi = min((i + 1) * width, m.n_cols)
            keep = (m.cols >= lo) & (m.cols < hi)
            sub = SparseMatrix(m.n_rows, hi - lo,
                               m.rows[keep].astype(np.int32),
                               (m.cols[keep] - lo).astype(np.int32),
                               m.vals[keep].astype(np.float32))
            shards.append(RowShard(i, lo, hi, sub, mode="col"))
    else:
        raise ValueError(f"unknown partition mode {mode!r}")
    return shards


ELL_GRAPH = OperatorGraph.chain(
    OpSpec.make("COMPRESS"), OpSpec.make("TILE_ROW_BLOCK", rows=16),
    OpSpec.make("LANE_ROW_BLOCK"), OpSpec.make("LANE_TOTAL_RED"))
SEG_GRAPH = OperatorGraph.chain(
    OpSpec.make("COMPRESS"), OpSpec.make("LANE_NNZ_BLOCK", chunk=128, lanes=8),
    OpSpec.make("SEG_SCAN_RED"))


def default_shard_graph(m: SparseMatrix) -> OperatorGraph:
    """Search-free per-shard design: the paper's regularity split (§VI-B) —
    regular shards take a tiled-ELL design, irregular ones a SEG design."""
    return SEG_GRAPH if m.is_irregular() else ELL_GRAPH


def baseline_shard_program(m: SparseMatrix, backend: str = "cuda"):
    """Build one shard's trusted baseline program: the search-free
    heuristic design, no machine-designed risk, no fault hook.

    The single definition of "the baseline" for the dist plane — used
    both for shards too small to search (``min_nnz_for_search``) and as
    the degraded-but-correct substitute when a shard's search fails
    (``dist_search``'s per-shard fault domain). Returns
    ``(graph, program)``."""
    g = default_shard_graph(m)
    return g, build_program(run_graph(m, g), backend=backend)


# ------------------- operand packing (per-family stacking) ------------------

def _pad_to(a: torch.Tensor, shape: tuple, fill) -> torch.Tensor:
    """Pad ``a`` up to ``shape`` (same rank) with a constant fill value."""
    if tuple(a.shape) == tuple(shape):
        return a
    out = torch.full(shape, fill, dtype=a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


_FILL = {"vals": 0.0, "cols": 0, "rowmap": -1, "local": 0, "end": 0,
         "rows": 0}

# canonical ELL chunk geometry for operand stacking: every bucket is
# re-tiled to (R0, W0) so heterogeneous bucket widths across shards never
# force a pad-to-global-max blowup (wide rows split into several chunks of
# the same output row — exact under the scatter-*add* combine)
_ELL_R0, _ELL_W0 = 8, 8


def _canon_ell(vals: torch.Tensor, cols: torch.Tensor,
               rowmap: torch.Tensor) -> dict:
    """Re-tile one ELL bucket (T, R, W) to canonical (T', R0, W0) chunks."""
    T, R, W = vals.shape
    Rp = -(-R // _ELL_R0) * _ELL_R0
    Wp = -(-W // _ELL_W0) * _ELL_W0
    vals = _pad_to(vals, (T, Rp, Wp), 0.0)
    cols = _pad_to(cols, (T, Rp, Wp), 0)
    rowmap = _pad_to(rowmap, (T, Rp), -1)
    kw, kr = Wp // _ELL_W0, Rp // _ELL_R0
    # split the width axis: chunk (t, j) holds columns [j*W0, (j+1)*W0) of
    # tile t's rows; every chunk scatters into the same output rows
    vals = vals.reshape(T, Rp, kw, _ELL_W0).permute(0, 2, 1, 3)
    cols = cols.reshape(T, Rp, kw, _ELL_W0).permute(0, 2, 1, 3)
    rowmap = torch.repeat_interleave(rowmap, kw, dim=0)
    # split the row axis: a pure reshape (rows stay whole per chunk); the
    # narrowed dtypes (bf16 vals / int16 cols) pass through unchanged
    vals = vals.reshape(T * kw * kr, _ELL_R0, _ELL_W0)
    cols = cols.reshape(T * kw * kr, _ELL_R0, _ELL_W0)
    rowmap = rowmap.reshape(T * kw * kr, _ELL_R0)
    return {"vals": vals.contiguous(), "cols": cols.contiguous(),
            "rowmap": rowmap.contiguous()}


def _shard_family_parts(program: Optional[SpmvProgram]) -> dict:
    """Canonicalize one shard program's (spec, fmt) into family parts.

    Returns {family_key: [part, ...]} where a part is {name: CPU tensor}.
    Family keys: ("ell",) for every width bucket (re-tiled to canonical
    (R0, W0) chunks), and ("seg", reduce, S, L) for nnz-split blocks (the
    flat (S, L) stream cannot be padded without shifting segment
    descriptors, so it is part of the family identity; tile count and
    seg_rows are paddable).
    """
    out: dict = {}
    if program is None:
        return out
    fmt = {k: v.detach().cpu() for k, v in program.fmt.items()}
    for step in program.spec["steps"]:
        key = step["key"]
        vals = fmt[f"{key}_vals"]          # narrowed dtype preserved
        cols = torch.from_numpy(materialize_cols(step["cols"], fmt))
        if cols.dtype != torch.int16:      # model-elided cols come back
            cols = cols.to(torch.int32)    # wider; int16 storage stays
        if step["kind"] == "ell":
            comb = step["combine"]
            if comb["mode"] == "rowmap":
                rowmap = fmt[f"{key}_rowmap"].to(torch.int32)
            else:
                # affine combine (a == 1): reconstruct the equivalent
                # explicit rowmap — scatter-adding to b0 + arange(nv) is
                # exactly what the direct/affine write did.
                T, R = vals.shape[0], vals.shape[1]
                flat = torch.full((T * R,), -1, dtype=torch.int32)
                flat[: comb["nv"]] = comb["b0"] + torch.arange(
                    comb["nv"], dtype=torch.int32)
                rowmap = flat.reshape(T, R)
            out.setdefault(("ell",), []).append(
                _canon_ell(vals, cols, rowmap))
        else:
            S, L = int(vals.shape[1]), int(vals.shape[2])
            fam = ("seg", step["reduce"], S, L)
            part = {"vals": vals, "cols": cols,
                    "rowmap": fmt[f"{key}_rowmap"].to(torch.int32)}
            for name in ("local", "end", "rows"):
                if f"{key}_{name}" in fmt:
                    part[name] = fmt[f"{key}_{name}"].to(torch.int32)
            out.setdefault(fam, []).append(part)
    return out


def _family_dtype(name: str, parts: list[dict]) -> torch.dtype:
    """One dtype per stacked family array: keep the narrowed storage when
    every shard agrees, otherwise widen to the fp32/int32 baseline."""
    dts = {p[name].dtype for p in parts}
    if len(dts) == 1:
        return next(iter(dts))
    return torch.float32 if name == "vals" else torch.int32


def _concat_shard_family(parts: list[dict], names: list[str],
                         rw: Optional[tuple], seg_rows: int,
                         dtypes: dict) -> dict:
    """Pad each part to the family geometry and concatenate along tiles."""
    pieces = {n: [] for n in names}
    for part in parts:
        T = part["vals"].shape[0]
        for n in names:
            a = part[n].to(dtypes[n])
            if rw is not None:                      # ell: (T, R, W) family
                shape = ((T,) + rw if n != "rowmap" else (T, rw[0]))
            elif n in ("rowmap", "end"):            # seg descriptor rows
                shape = (T, seg_rows)
            else:                                   # seg flat (S, L) stream
                shape = tuple(a.shape)
            pieces[n].append(_pad_to(a, shape, _FILL[n]))
    return {n: torch.cat(pieces[n], dim=0) for n in names}


def pack_operand_format(programs: Sequence[Optional[SpmvProgram]]
                        ) -> tuple[list, dict]:
    """Stack per-shard formats into per-family operands.

    Returns ``(steps, stacks)``: a synthetic kernel spec step list (one
    step per family, rowmap-scatter combine, ``n_rows = n_out``) and the
    stacked CPU tensors {name: (n_shards, ...)}. Shards missing a family
    get all-padding tiles (val=0, rowmap=-1) that contribute nothing.
    """
    per_shard = [_shard_family_parts(p) for p in programs]
    families = sorted({k for sh in per_shard for k in sh})
    steps, stacks = [], {}
    for gi, fam in enumerate(families):
        gkey = f"g{gi}"
        all_parts = [part for sh in per_shard for part in sh.get(fam, [])]
        if fam[0] == "ell":
            names = ["vals", "cols", "rowmap"]
            rw = (max(p["vals"].shape[1] for p in all_parts),
                  max(p["vals"].shape[2] for p in all_parts))
            seg_rows = 0
            step = {"kind": "ell", "key": gkey,
                    "cols": {"mode": "array", "key": f"{gkey}_cols"},
                    "combine": {"mode": "rowmap", "key": f"{gkey}_rowmap"},
                    "report": {"kernel": "ell", "family": "ell",
                               "tile_rows": rw[0], "width": rw[1]}}
        else:
            _, reduce_kind, S, L = fam
            names = sorted({n for p in all_parts for n in p})
            rw = None
            seg_rows = max(p["rowmap"].shape[1] for p in all_parts)
            # stacking appends padding tiles: the gmem row stream is no
            # longer globally sorted, so never claim the sorted fast path
            step = {"kind": "seg", "key": gkey, "reduce": reduce_kind,
                    "seg_rows": int(seg_rows), "rows_sorted": False,
                    "cols": {"mode": "array", "key": f"{gkey}_cols"},
                    "report": {"kernel": reduce_kind, "family": "seg",
                               "chunk": (S, L), "seg_rows": int(seg_rows)}}
        dtypes = {n: _family_dtype(n, all_parts) for n in names}
        shard_arrays = [
            _concat_shard_family(sh.get(fam, []), names, rw, seg_rows,
                                 dtypes)
            if sh.get(fam) else None
            for sh in per_shard]
        t_max = max(a["vals"].shape[0] for a in shard_arrays if a is not None)
        for n in names:
            tails = {tuple(a[n].shape[1:])
                     for a in shard_arrays if a is not None}
            tail = max(tails)   # singleton by construction of the family
            full = []
            for a in shard_arrays:
                if a is None:
                    full.append(torch.full((t_max,) + tail, _FILL[n],
                                           dtype=dtypes[n]))
                else:
                    full.append(_pad_to(a[n], (t_max,) + tail, _FILL[n]))
            stacks[f"{gkey}_{n}"] = torch.stack(full)
        steps.append(step)
    return steps, stacks


# ------------------------- placement and execution --------------------------

def _rowmap_key(step: dict) -> str:
    return (step["combine"]["key"] if step["kind"] == "ell"
            else f"{step['key']}_rowmap")


def check_placement(mesh, backend: str) -> None:
    """A ``cuda`` plan runs on CUDA devices only and a ``torch`` plan on
    the CPU only; neither falls back to the other."""
    if not hasattr(mesh, "devices") or not hasattr(mesh, "shape"):
        raise TypeError(f"mesh must be a repro_torch.dist.DataMesh "
                        f"(make_data_mesh), got {type(mesh).__name__}")
    want = "cuda" if backend == "cuda" else "cpu"
    bad = sorted({str(d) for d in mesh.devices
                  if torch.device(d).type != want})
    if bad:
        raise ValueError(f"backend {backend!r} runs on {want} devices; the "
                         f"mesh holds {', '.join(bad)}")


def place_stacks(stacks: dict, mesh) -> dict:
    """The stacks where the mesh keeps them: on the one device all shards
    share, else on the host (each shard then gets a copy of its slice)."""
    dev = mesh.shared_device
    if dev is None:
        return {k: v.cpu() for k, v in stacks.items()}
    return {k: v.to(dev) for k, v in stacks.items()}


@dataclasses.dataclass
class ShardOperands:
    """One shard's operands: ``fmt``, slice i of every stack on the
    shard's device, and ``order``, each family rowmap's fixed combine
    order (``kernels.combine.combine_order``) by its fmt key. The folded
    set (:func:`fold_operands`) has the same two fields over all shards."""

    fmt: dict
    order: dict

    @property
    def order_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for pair in self.order.values() for t in pair)


@dataclasses.dataclass(eq=False)
class MeshOperands(Sequence):
    """A sharded program's operands on its mesh: ``shards[i]`` for shard
    i (indexing and iterating give these), and, where every shard sits on
    one device, ``folded``: the operands of one run of the body over all
    shards' tiles (:func:`fold_operands`), else None."""

    shards: list
    folded: Optional[ShardOperands] = None
    # bytes the folded set holds beside the stacks: its shifted rowmaps,
    # stored rows and (col mode) columns
    folded_bytes: int = 0

    def __getitem__(self, i):
        return self.shards[i]

    def __len__(self) -> int:
        return len(self.shards)

    @property
    def order_bytes(self) -> int:
        return sum(op.order_bytes for op in self.shards) + (
            0 if self.folded is None else self.folded.order_bytes)


def _shifted(stack: torch.Tensor, step_of: int, only_valid: bool,
             dtype: torch.dtype) -> torch.Tensor:
    """A (n, T', ...) index stack as (n T', ...) with shard i's entries
    moved by ``i * step_of`` (only those >= 0 where ``only_valid``)."""
    n = stack.shape[0]
    shift = (torch.arange(n, device=stack.device, dtype=torch.int64)
             * step_of).reshape((n,) + (1,) * (stack.ndim - 1))
    wide = stack.long()
    out = wide + shift
    if only_valid:
        out = torch.where(wide >= 0, out, wide)
    return out.to(dtype).reshape((-1,) + tuple(stack.shape[2:]))


def fold_operands(stacks: dict, steps: list, n_out: int, mode: str,
                  width: int) -> ShardOperands:
    """The operands of one run of the body over all n shards at once, on
    the stacks' device: every stack (n, T', ...) viewed as (n T', ...),
    tiles of shard i first; shard i's rowmap entries >= 0 and stored rows
    (``{key}_rows``, the torch backend's gmem_atom stream) moved by
    ``i * n_out``, so its partials land in rows [i n_out, (i + 1) n_out)
    of an (n n_out[, B]) output, in the same order as its own run; in col
    mode shard i's columns moved by ``i * width`` into the padded x, int16
    kept while ``n * width`` fits it. The shifted arrays are copies; the
    rest are views of the stacks."""
    from repro_torch.kernels.combine import combine_order
    if mode == "col" and width <= 0:
        raise ValueError(f"col mode needs a slice width, got {width}")
    if not stacks:
        return ShardOperands({}, {})
    n = next(iter(stacks.values())).shape[0]
    if n * max(n_out, 1) > 2 ** 31 - 1:
        raise ValueError(f"{n} shards of {n_out} output rows do not fit "
                         "int32 row indices")
    rowmaps = {_rowmap_key(st) for st in steps}
    rows = {f"{st['key']}_rows" for st in steps}
    cols = {st["cols"]["key"] for st in steps} if mode == "col" else set()
    fmt = {}
    for k, v in stacks.items():
        if k in rowmaps or k in rows:
            fmt[k] = _shifted(v, n_out, k in rowmaps, torch.int32)
        elif k in cols:
            narrow = v.dtype == torch.int16 and n * width <= 32767
            fmt[k] = _shifted(v, width, False,
                              torch.int16 if narrow else torch.int32)
        else:
            fmt[k] = v.reshape((-1,) + tuple(v.shape[2:]))
    order = {k: combine_order(fmt[k], n * n_out) for k in rowmaps}
    return ShardOperands(fmt, order)


def place_operands(stacks: dict, steps: list, mesh, n_out: int,
                   mode: str, n_cols: int) -> MeshOperands:
    """Each shard's operands on ``mesh.devices[i]`` (slices are views where
    the stack lies there). Where the shards sit on several devices, each
    gets its combine orders, fixed here once; where they share one, the
    shards' views come without orders and the folded set, which runs
    them all in one pass (:func:`fold_operands`; ``n_cols`` sets col
    mode's slice width), holds the orders."""
    from repro_torch.kernels.combine import combine_order
    shared = mesh.shared_device is not None
    shards = []
    for i, dev in enumerate(mesh.devices):
        fmt = {k: v[i].to(dev) for k, v in stacks.items()}
        order = {} if shared else {key: combine_order(fmt[key], n_out)
                                   for key in map(_rowmap_key, steps)}
        shards.append(ShardOperands(fmt, order))
    if not shared:
        return MeshOperands(shards)
    n = len(mesh.devices)
    placed = {k: v.to(mesh.shared_device) for k, v in stacks.items()}
    folded = fold_operands(placed, steps, n_out, mode, -(-n_cols // n))
    copies = sum(t.numel() * t.element_size()
                 for k, t in folded.fmt.items()
                 if t.untyped_storage().data_ptr()
                 != placed[k].untyped_storage().data_ptr())
    return MeshOperands(shards, folded, copies)


def psum(partials: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The col-mode combine: the shards' partial y added in shard order
    on ``device`` (the reference's ``lax.psum`` over the mesh axis). Every
    shard of a mesh runs in this process; where shards become processes
    on several cards, an all-reduce (``torch.distributed``) takes this
    function's place."""
    y = partials[0].to(device)
    for p in partials[1:]:
        y += p.to(device)
    return y


def stacked_call(fn: Callable, operands: list, x, mode: str, n_cols: int,
                 sizes: Sequence[int], device, dtype=torch.float32
                 ) -> torch.Tensor:
    """Shared call path for stacked-operand programs and plans.

    col mode: pad x to the uniform slice width before slicing it per
    shard; row mode: slice each shard's padded band back to its true size
    and concatenate the bands on ``device``.
    """
    x = torch.as_tensor(x).to(device, dtype).contiguous()
    if x.ndim not in (1, 2) or x.shape[0] != n_cols:
        raise ValueError(f"x must be ({n_cols},) or ({n_cols}, B), got "
                         f"shape {tuple(x.shape)}")
    n_shards = max(len(sizes), 1)
    if mode == "col":
        width = -(-n_cols // n_shards)
        pad = width * n_shards - n_cols
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return fn(operands, x)
    outs = fn(operands, x)       # per shard: its (R[, B]) padded band
    pieces = [out[:size].to(device) for out, size in zip(outs, sizes)]
    return torch.cat(pieces)


# ------------------------------ the program --------------------------------

@dataclasses.dataclass
class ShardedSpmvProgram:
    """A compiled sharded SpMV/SpMM: y = A @ x across the mesh ``data`` axis.

    Multi-RHS: a 2-D x is an (n_cols, B) tile (same convention as
    ``SpmvProgram``) and runs the SpMM kernels — row mode concatenates
    (size, B) bands, col mode adds (n_rows, B) partials like the 1-RHS
    combine.

    ``stacks`` (per-family stacked format tensors, leading dim = shard)
    and ``steps`` (the synthetic kernel spec each shard runs) fully
    determine the executable — the same plan protocol as ``SpmvProgram``,
    which is what ``repro_torch.api`` serializes. ``operands`` is their
    placement on the mesh.
    """

    supports_batch = True

    n_rows: int
    n_cols: int
    mode: str
    shards: list[RowShard]
    programs: list[Optional[SpmvProgram]]
    mesh: object
    axis_name: str
    steps: list = dataclasses.field(default_factory=list)
    stacks: dict = dataclasses.field(default_factory=dict)
    band_rows: int = 0               # row mode: padded per-shard band size
    backend: str = "cuda"
    operands: list = dataclasses.field(default_factory=list, repr=False)
    _fn: Callable = dataclasses.field(repr=False, default=None)

    @property
    def nnz(self) -> int:
        return sum(s.matrix.nnz for s in self.shards)

    @property
    def stored_bytes(self) -> int:
        return sum(p.stored_bytes for p in self.programs if p is not None)

    @property
    def replicated_format_bytes(self) -> int:
        """Per-device format bytes if every device held every shard's
        format (the reference's old closure design)."""
        return self.stored_bytes

    @property
    def per_device_format_bytes(self) -> int:
        """Per-device format bytes under operand passing: the device's
        1/n_shards slice of every family stack."""
        n = max(len(self.shards), 1)
        return sum(v.numel() * v.element_size() // n
                   for v in self.stacks.values())

    def descriptor(self) -> list[dict]:
        out = []
        for s, p in zip(self.shards, self.programs):
            out.append({"shard": s.index, "start": s.start, "stop": s.stop,
                        "nnz": s.matrix.nnz,
                        "design": None if p is None
                        else p.descriptor["blocks"]})
        return out

    def __call__(self, x) -> torch.Tensor:
        """x: (n_cols,) -> (n_rows,), or (n_cols, B) -> (n_rows, B), on
        ``mesh.devices[0]``."""
        return stacked_call(self._fn, self.operands, x, self.mode,
                            self.n_cols, [s.size for s in self.shards],
                            self.mesh.devices[0])


def make_stacked_fn(steps: list, mode: str, n_out: int, mesh,
                    axis_name: str, backend: str = "cuda") -> Callable:
    """``fn(operands, x)`` over :class:`MeshOperands`. Where the shards
    share one device, the body (``build_kernel`` on the synthetic family
    spec) runs once over the folded operands: one family kernel and one
    combine a step for all shards, into an (n n_out[, B]) output viewed as
    (n, n_out[, B]). Else it runs once per shard, on the shard's device,
    shard i taking its slice of the padded x in col mode. Row mode
    returns the per-shard bands; col mode :func:`psum` of the partials.
    Each shard's partials get the same adds in the same order either
    way, so the two give the same bits."""
    _axis_size(mesh, axis_name)
    devices = mesh.devices
    n = len(devices)
    if mesh.shared_device is not None:
        run = build_kernel({"version": SPEC_VERSION, "n_rows": n * n_out,
                            "steps": steps}, backend=backend)

        def fn(operands, x):
            folded = operands.folded
            y = run(folded.fmt, x, folded.order)
            parts = y.view((n, n_out) + tuple(x.shape[1:]))
            return psum(parts, devices[0]) if mode == "col" else parts

        return fn
    run = build_kernel({"version": SPEC_VERSION, "n_rows": n_out,
                        "steps": steps}, backend=backend)

    def fn(operands, x):
        if mode == "col":
            width = x.shape[0] // n
            return psum([run(op.fmt, x[i * width:(i + 1) * width].to(dev),
                             op.order)
                         for i, (op, dev) in enumerate(zip(operands,
                                                           devices))],
                        devices[0])
        return [run(op.fmt, x.to(dev), op.order)
                for op, dev in zip(operands, devices)]

    return fn


def build_sharded_spmv(shards: Sequence[RowShard],
                       programs: Sequence[Optional[SpmvProgram]],
                       mesh, axis_name: str = "data",
                       backend: str = "cuda") -> ShardedSpmvProgram:
    """Stack per-shard programs into one stacked-operand program placed on
    ``mesh`` (``backend`` selects the kernels each shard runs)."""
    shards = list(shards)
    programs = list(programs)
    n_shards = _axis_size(mesh, axis_name)
    if len(shards) != n_shards:
        raise ValueError(f"{len(shards)} shards for a {n_shards}-way "
                         f"'{axis_name}' mesh axis")
    check_placement(mesh, backend)
    mode = shards[0].mode if shards else "row"
    if mode == "row":
        n_rows = shards[-1].stop if shards else 0
        n_cols = shards[0].matrix.n_cols if shards else 0
        R = max((s.size for s in shards), default=0)
        n_out = R
    else:
        n_rows = shards[0].matrix.n_rows if shards else 0
        n_cols = shards[-1].stop if shards else 0
        R = 0
        n_out = n_rows
    steps, host_stacks = pack_operand_format(programs)
    stacks = place_stacks(host_stacks, mesh)
    fn = make_stacked_fn(steps, mode, n_out, mesh, axis_name,
                         backend=backend)
    return ShardedSpmvProgram(n_rows=n_rows, n_cols=n_cols, mode=mode,
                              shards=shards, programs=programs, mesh=mesh,
                              axis_name=axis_name, steps=steps,
                              stacks=stacks, band_rows=R, backend=backend,
                              operands=place_operands(stacks, steps, mesh,
                                                      n_out, mode, n_cols),
                              _fn=fn)


def shard_map_spmv(m: SparseMatrix, mesh, axis_name: str = "data",
                   mode: str = "row", balance: str = "nnz",
                   graph_for: Callable[[SparseMatrix], OperatorGraph]
                   = default_shard_graph,
                   backend: str = "cuda",
                   storage_dtype: str = "float32") -> ShardedSpmvProgram:
    """Search-free sharded SpMV: partition + per-shard heuristic design.

    ``dist.search.dist_search`` is the searched variant (one AlphaSparse
    search per shard); this one is the cheap path for serving and tests.
    ``storage_dtype="bfloat16"`` narrows every per-shard format (bf16
    vals, int16 cols where n_cols fits) — the family stacks keep the
    narrowed dtypes, so per-device bytes shrink accordingly.
    """
    n_shards = _axis_size(mesh, axis_name)
    check_placement(mesh, backend)
    shards = partition_matrix(m, n_shards, mode=mode, balance=balance)
    sd = None if storage_dtype == "float32" else storage_dtype
    programs = []
    for s in shards:
        if s.is_empty:
            programs.append(None)
        else:
            meta = run_graph(s.matrix, graph_for(s.matrix))
            programs.append(build_program(meta, backend=backend,
                                          storage_dtype=sd))
    return build_sharded_spmv(shards, programs, mesh, axis_name,
                              backend=backend)
