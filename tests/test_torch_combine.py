"""The fixed combine order of dense plans (repro_torch.kernels.combine,
core.kernel_builder.combine_orders), on the CPU.

On the card every rowmap combine of a dense plan goes through the ordered
``rowmap_combine`` and the fused seg kernels K6 / K11 put each (tile,
segment) partial where ``fused_rows`` says: its row, when no other tile
adds into it, or a slot of a side buffer that the ordered combine adds
into y in tile order. The kernels run only on the card; here the same
placement is emulated with the plain versions and held bit for bit
against the plain fused versions (``seg_spmv_fused_ref``,
``seg_spmm_fused_ref``), which add every partial with ``index_add_`` in
(tile, segment) order. The derived state is built with the plan, kept
out of the saved file, rebuilt on load and reused across a dyn update
that leaves the descriptors alone. Exact comparisons throughout.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.graph import OperatorGraph, run_graph
from repro_torch.core.kernel_builder import combine_orders, plan_format
from repro_torch.core.matrices import (SparseMatrix, banded_matrix,
                                       hyb_friendly_matrix, powerlaw_matrix)
from repro_torch.design.registry import OpSpec
from repro_torch.dyn import PatternDelta
from repro_torch.kernels.combine import (CELL_COLS, SLOT_BASE, FusedRows,
                                         fused_rows)
from repro_torch.kernels.ref import (rowmap_combine_ref, seg_spmm_fused_ref,
                                     seg_spmm_ref, seg_spmv_fused_ref,
                                     seg_spmv_ref)

MODES = {"SEG_SCAN_RED": "seg_scan", "ONEHOT_MXU_RED": "onehot_mxu",
         "GMEM_ATOM_RED": "seg_scan"}


def _graph(red, chunk):
    return OperatorGraph.chain(OpSpec.make("COMPRESS"),
                               OpSpec.make("LANE_NNZ_BLOCK", chunk=chunk),
                               OpSpec.make(red))


def _fused_step(m, red, chunk):
    fmt, spec = plan_format(run_graph(m, _graph(red, chunk)),
                            fuse_combine=True)
    step = spec["steps"][0]
    assert step["fused"]
    key = step["key"]
    return (fmt[f"{key}_vals"], fmt.get(f"{key}_cols"),
            fmt.get(f"{key}_local"), fmt.get(f"{key}_end"),
            fmt[f"{key}_r0"], step["seg_rows"])


def _emulate(rows: FusedRows, part, n_rows):
    """What the fused kernel and its side combine compute, from the
    plain per-tile partials ((T * M,) or (T * M, B))."""
    y = torch.zeros((n_rows,) + tuple(part.shape[1:]))
    d = rows.dst.long()
    # the kernels skip each tile's segments from n_used on: none adds
    T = rows.n_used.numel()
    m = torch.arange(d.numel() // T).expand(T, -1)
    assert bool((d.reshape(T, -1)[m >= rows.n_used[:, None].long()] == -1)
                .all())
    direct = d >= 0
    assert torch.unique(d[direct]).numel() == int(direct.sum())  # one writer
    y[d[direct]] += part[direct]
    side = torch.empty((rows.n_side,) + tuple(part.shape[1:]))
    pairs, slot = rows.shared_pairs()
    side[slot] = part[pairs]
    assert torch.equal(torch.sort(slot).values,
                       torch.arange(rows.n_side))           # each slot once
    assert torch.equal(rows.rows, torch.unique(rows.rows))  # distinct, sorted
    return rowmap_combine_ref(y, side, rows.perm, rows.offsets, rows.rows)


CASES = [("SEG_SCAN_RED", 64), ("ONEHOT_MXU_RED", 64),
         ("GMEM_ATOM_RED", 64), ("SEG_SCAN_RED", 512),
         ("ONEHOT_MXU_RED", 256)]


@pytest.mark.parametrize("red,chunk", CASES)
@pytest.mark.parametrize("cut", [0, 37])
def test_fused_rows_place_partials_as_the_plain_version(red, chunk, cut):
    """Power-law rows spanning many tiles; ``cut`` rows masked at the
    end (n_rows below the plan's)."""
    m = powerlaw_matrix(3000, 2500, 8.0, 1.5, seed=0)
    v, c, local, end, r0, M = _fused_step(m, red, chunk)
    mode = MODES[red]
    n_rows = m.n_rows - cut
    rows = fused_rows(r0, end if mode == "seg_scan" else local, M, n_rows,
                      mode, v.shape[1] * v.shape[2])
    assert rows.dst.dtype == torch.int32 and rows.dst.numel() == r0.numel() * M
    assert rows.n_side > 0          # some rows straddle tiles
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(m.n_cols).astype(np.float32))
    part = seg_spmv_ref(v, c, local, end, x, M, mode).reshape(-1)
    want = seg_spmv_fused_ref(v, c, local, end, r0, x, M, n_rows=n_rows,
                              mode=mode)
    assert torch.equal(_emulate(rows, part, n_rows), want)
    x8 = torch.from_numpy(rng.standard_normal((m.n_cols, 8)).astype(
        np.float32))
    part8 = seg_spmm_ref(v, c, local, end, x8, M, mode).reshape(-1, 8)
    want8 = seg_spmm_fused_ref(v, c, local, end, r0, x8, M, n_rows=n_rows,
                               mode=mode)
    assert torch.equal(_emulate(rows, part8, n_rows), want8)


def test_fused_rows_of_disjoint_tiles_have_no_side():
    m = banded_matrix(512, 3, seed=0)
    v, c, local, end, r0, M = _fused_step(m, "SEG_SCAN_RED", 64)
    rows = fused_rows(r0, end, M, m.n_rows, "seg_scan",
                      v.shape[1] * v.shape[2])
    used = rows.dst[rows.dst >= 0]
    assert torch.unique(used).numel() == used.numel()
    # the banded rows of 7 slots straddle 64-slot tiles: a few shared
    assert rows.n_side < r0.numel() * 2


def test_combine_orders_cover_every_combine():
    m = powerlaw_matrix(400, 350, 6.0, 1.2, seed=2)
    for red in MODES:
        meta = run_graph(m, _graph(red, 64))
        for fuse in (True, False):
            fmt, spec = plan_format(meta, fuse_combine=fuse)
            key = spec["steps"][0]["key"]
            on_cuda = combine_orders(spec, fmt, "cuda")
            on_cpu = combine_orders(spec, fmt, "torch")
            if fuse:
                assert isinstance(on_cuda[f"{key}_r0"], FusedRows)
            else:
                assert sorted(on_cuda) == [f"{key}_rowmap"]
            if red == "GMEM_ATOM_RED":
                assert on_cpu == {}           # one index_add_ on the host
            else:
                assert sorted(on_cpu) == [f"{key}_rowmap"]


@pytest.fixture(scope="module")
def seg_plan():
    m = powerlaw_matrix(600, 500, 8.0, 1.3, seed=4)
    plan = repro_torch.compile(m, repro_torch.Target(backend="torch"),
                               graph=_graph("SEG_SCAN_RED", 64))
    return m, plan


def test_plan_builds_its_order_and_saves_none(seg_plan, tmp_path):
    m, plan = seg_plan
    orders = plan.combine_state
    assert sorted(orders) == ["b0s_rowmap"]
    path = tmp_path / "p.plan.npz"
    plan.save(path)
    with np.load(path) as z:
        assert not any("perm" in k or "offsets" in k or "dst" in k
                       for k in z.files)
    loaded = repro_torch.load_plan(path)
    assert loaded.combine_state["b0s_rowmap"] is not orders["b0s_rowmap"]
    x = np.random.default_rng(0).standard_normal(m.n_cols).astype(
        np.float32)
    assert torch.equal(plan(x), loaded(x))


def test_update_reuses_the_order_of_unchanged_descriptors(seg_plan):
    m, plan = seg_plan
    vals = np.array(m.vals, np.float32)
    vals[::7] *= 2.0
    m1 = dataclasses.replace(m, vals=vals)
    upd = plan.update(PatternDelta.from_matrices(m, m1))
    assert upd.fmt["b0s_rowmap"] is plan.fmt["b0s_rowmap"]
    # the update derives its order afresh: the same as its source's, and
    # as a plan built afresh from the same arrays
    fresh = dataclasses.replace(upd, combine_state=None)
    for a, b, c in zip(fresh.combine_state["b0s_rowmap"],
                       upd.combine_state["b0s_rowmap"],
                       plan.combine_state["b0s_rowmap"]):
        assert torch.equal(a, b) and torch.equal(b, c)
    x = np.random.default_rng(1).standard_normal(m.n_cols).astype(
        np.float32)
    assert torch.equal(fresh(x), upd(x))
    y = upd(x).numpy().astype(np.float64)
    want = m1.spmv_dense_oracle(x)
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()


# ------------------ the fused kernels' in-launch combine -------------------
#
# K6 / K11 add a shared row inside their launch, in (tile, segment) order
# (csrc/flush.cuh): a row of two pairs through a 64-bit exchange cell a
# column (atomicCAS of (rank, partial) into the empty cell; the pair that
# finds the other's there adds y + first + second and empties the cell),
# a row of more pairs, or any row at more than CELL_COLS columns, through
# side slots and the row's arrival counter (atomicInc, wrapping at the
# row's count; the pair that brings it back to 0 adds the slots in perm
# order). The tests below hold the FusedRows codes and fields that the
# protocol reads, and a plain emulation of it, with tiles finishing in
# random orders and the columns written in K11's windows, bit for bit
# against the ordered combine's placement above.

def _parent_placement(rows: FusedRows, part, y0):
    """The unfused partials placed in the fixed order: y0 plus each
    one-writer pair's partial at its row, then the listed rows' side
    slots through the ordered combine in perm order."""
    y = y0.clone()
    d = rows.dst.long()
    direct = d >= 0
    y[d[direct]] = y[d[direct]] + part[direct]
    side = torch.empty((rows.n_side,) + tuple(part.shape[1:]))
    pairs, slot = rows.shared_pairs()
    side[slot] = part[pairs]
    return rowmap_combine_ref(y, side, rows.perm, rows.offsets, rows.rows)


# K11's shared memory for its windows, in floats: the card's (227 KB less
# a margin), and what leaves room for one tile and two columns a window,
# or for half a tile's keys and one column
WINDOWS = {"whole": lambda M: 57856, "columns": lambda M: 2 * (M + 64) + 5,
           "keys": lambda M: 64 + M // 2}


def _k11_windows(T, C, M, B, cap):
    """K11's windows of (tile, segment) keys, block by block, and its
    column chunk (csrc/seg_spmm.cu, seg_spmm), with ``cap`` floats of
    shared memory: a block takes the ceil(2048 / C) tiles of one pass, in
    windows of whole tiles and all B columns; else of one tile and fewer
    columns; else of part of a tile's keys and one column."""
    bnd = 4 * 16                    # the boundary ring's floats a column
    K = min(-(-2048 // C), T)
    if M * B + bnd * B <= cap:
        nt = min(-(-2048 // C), 64, K, (cap - bnd * B) // (M * B))
        nk, cb = nt * M, B
    elif M + bnd <= cap:
        nk, cb = M, cap // (M + bnd)
        cb -= cb % 4 if cb >= 4 else 0
    else:
        nk, cb = cap - bnd, 1
    windows = []
    for t0 in range(0, T, K):
        keys = np.arange(t0 * M, min(t0 + K, T) * M)
        windows += [keys[k:k + nk] for k in range(0, keys.size, nk)]
    return windows, cb


def _decode(rows: FusedRows, d, B):
    """A shared pair's code: ("x", u, r) for an exchange at B columns, or
    ("slot", k)."""
    if SLOT_BASE < d <= -2 and B <= CELL_COLS:
        c = -2 - d
        return "x", c // 2, c % 2
    if d <= SLOT_BASE:
        return "slot", SLOT_BASE - d
    c = -2 - d
    return "slot", int(rows.perm[rows.offsets[c // 2] + c % 2])


def _last_arriver(rows: FusedRows, part, y0, row_of, groups, cb, rng,
                  state):
    """A plain emulation of the in-launch combine: each group of pairs (a
    block's tiles or window) writes its columns in chunks of ``cb``
    (exchanging a two-pair row's columns as it writes them, in a random
    order of its pairs), then its counted pairs count in, in a random
    order; the groups' chunks interleave in a random order that keeps
    each group's own. ``row_of[p]`` is pair p's row (r0[t] + m).
    ``state`` holds the plan's cells and counters (numpy), which the
    launch must leave as it found them. Returns y."""
    part = part.numpy().reshape(part.shape[0], -1)
    B = part.shape[1]
    y = y0.numpy().reshape(y0.shape[0], -1).copy()
    dst, slot_row = rows.dst.numpy(), rows.slot_row.numpy()
    count, perm = rows.count.numpy(), rows.perm.numpy()
    offsets, listed = rows.offsets.numpy(), rows.rows.numpy()
    cells, arrive = state["cells"], state["arrive"]
    side = np.full((rows.n_side, B), np.nan, np.float32)  # unwritten slots
    order = rng.permutation(np.repeat(np.arange(len(groups)),
                                      -(-B // cb)))
    nxt = np.zeros(len(groups), np.int64)
    for g in order:
        c0 = nxt[g] * cb
        nxt[g] += 1
        cend = min(B, c0 + cb)
        pairs = groups[g]
        for p in rng.permutation(pairs):
            d = int(dst[p])
            if d >= 0:
                y[d, c0:cend] = y[d, c0:cend] + part[p, c0:cend]
                continue
            if d == -1:
                continue
            code = _decode(rows, d, B)
            if code[0] == "slot":
                side[code[1], c0:cend] = part[p, c0:cend]
                continue
            _, u, r = code
            for b in range(c0, cend):
                cell = (u, b)                   # atomicCAS(cell, 0, mine)
                if cell not in cells:
                    cells[cell] = (r, part[p, b])
                    continue
                ro, o = cells.pop(cell)         # the second empties it
                assert ro == 1 - r
                first, second = (part[p, b], o) if r == 0 else (o, part[p, b])
                acc = y[row_of[p], b]
                acc = acc + first
                acc = acc + second
                y[row_of[p], b] = acc
        if cend < B:
            continue
        for p in rng.permutation(pairs):
            if dst[p] >= -1 or _decode(rows, int(dst[p]), B)[0] == "x":
                continue
            u = slot_row[_decode(rows, int(dst[p]), B)[1]]
            old = arrive[u]                     # atomicInc(count[u] - 1)
            arrive[u] = 0 if old >= count[u] - 1 else old + 1
            if old != count[u] - 1:
                continue
            slots = side[perm[offsets[u]:offsets[u + 1]]]
            assert not np.isnan(slots).any()    # every slot is written
            acc = y[listed[u]].copy()
            for s in slots:
                acc = acc + s
            y[listed[u]] = acc
    return torch.from_numpy(y.reshape(y0.shape))


def _check_fields(rows: FusedRows, r0, M):
    """The protocol's codes and fields against perm / offsets / rows."""
    n_listed = rows.rows.numel()
    assert rows.slot_row.dtype == rows.count.dtype == torch.int32
    assert rows.arrive.dtype == torch.int32
    assert rows.cells.dtype == torch.int64
    assert rows.slot_row.shape == (rows.n_side,)
    assert rows.count.shape == rows.arrive.shape == (n_listed,)
    assert rows.cells.shape == (n_listed * CELL_COLS,)
    assert not rows.arrive.any() and not rows.cells.any()   # start at 0
    runs = rows.offsets[1:] - rows.offsets[:-1]
    assert torch.equal(rows.count.long(), runs)    # a row's run in perm
    assert bool((rows.count >= 2).all())           # shared: 2+ writers
    owner = torch.repeat_interleave(torch.arange(n_listed), runs)
    assert torch.equal(rows.slot_row.long()[rows.perm.long()], owner)
    for u in range(n_listed):                      # (tile, segment) order
        run = rows.perm[rows.offsets[u]:rows.offsets[u + 1]]
        assert bool((run[1:] > run[:-1]).all())
    pairs, slot = rows.shared_pairs()
    assert torch.equal(torch.sort(slot).values, torch.arange(rows.n_side))
    assert torch.equal(slot, torch.arange(rows.n_side))  # in pair order
    pair_row = r0.long()[pairs // M] + pairs % M   # rowmap[t, m] = r0 + m
    u = rows.slot_row.long()[slot]
    assert torch.equal(rows.rows.long()[u], pair_row)
    code = rows.dst.long()[pairs]
    two = rows.count.long()[u] == 2
    rank = slot - rows.offsets[u]
    assert torch.equal(code[two], -2 - (2 * u[two] + rank[two]))
    assert torch.equal(code[~two], SLOT_BASE - slot[~two])


@pytest.mark.parametrize("red,chunk", CASES)
@pytest.mark.parametrize("cut", [0, 37])
def test_fused_rows_give_each_slot_its_row_and_each_row_its_count(red,
                                                                  chunk,
                                                                  cut):
    m = powerlaw_matrix(3000, 2500, 8.0, 1.5, seed=0)
    v, c, local, end, r0, M = _fused_step(m, red, chunk)
    mode = MODES[red]
    rows = fused_rows(r0, end if mode == "seg_scan" else local, M,
                      m.n_rows - cut, mode, v.shape[1] * v.shape[2])
    assert rows.n_side > 0
    _check_fields(rows, r0, M)


def _emulate_calls(m, red, chunk, B, windows, tiles_per_group, seed,
                   n_rows=None):
    """Three emulated launches (random orders) of one plan's fused step
    against the ordered combine's placement, sharing one plan's cells and
    counters."""
    v, c, local, end, r0, M = _fused_step(m, red, chunk)
    mode = MODES[red]
    n_rows = m.n_rows if n_rows is None else n_rows
    rows = fused_rows(r0, end if mode == "seg_scan" else local, M, n_rows,
                      mode, v.shape[1] * v.shape[2])
    _check_fields(rows, r0, M)
    rng = np.random.default_rng(seed)
    T = r0.numel()
    if B == 1:
        x = torch.from_numpy(rng.standard_normal(m.n_cols).astype(
            np.float32))
        part = seg_spmv_ref(v, c, local, end, x, M, mode).reshape(-1)
        y0 = torch.from_numpy(rng.standard_normal(n_rows).astype(np.float32))
        keys = np.arange(T * M).reshape(T, M)
        groups = [keys[t:t + tiles_per_group].reshape(-1)
                  for t in range(0, T, tiles_per_group)]
        cb = 1
    else:
        x = torch.from_numpy(rng.standard_normal((m.n_cols, B)).astype(
            np.float32))
        part = seg_spmm_ref(v, c, local, end, x, M, mode).reshape(-1, B)
        y0 = torch.from_numpy(rng.standard_normal((n_rows, B)).astype(
            np.float32))
        groups, cb = _k11_windows(T, v.shape[1] * v.shape[2], M, B,
                                  WINDOWS[windows](M))
        assert (cb < B) == (windows != "whole")
    want = _parent_placement(rows, part, y0)
    row_of = (r0.long()[:, None] + torch.arange(M)).reshape(-1).numpy()
    state = {"cells": {}, "arrive": rows.arrive.numpy().astype(np.int64)}
    for _ in range(3):
        got = _last_arriver(rows, part, y0, row_of, groups, cb, rng, state)
        assert torch.equal(got, want)
        assert not state["cells"] and not state["arrive"].any()
    return rows


@pytest.mark.parametrize("red,chunk", CASES)
@pytest.mark.parametrize("cut", [0, 37])
@pytest.mark.parametrize("B,windows", [(1, None), (8, "whole"),
                                       (8, "columns"), (3, "keys"),
                                       (40, "whole"), (40, "columns")])
def test_last_arriver_adds_shared_rows_as_the_ordered_combine(red, chunk,
                                                              cut, B,
                                                              windows):
    """K6 (B = 1: a group per tile, and per three tiles, which share a
    block in seg_scan blocks) and K11 (B = 8 with the card's shared
    memory: whole tiles, all columns; less of it: one tile and two
    columns a window, or half a tile's keys and one column, so that a
    pair's columns are written over several windows; B = 40, past the
    exchange cells' columns: every shared row counted)."""
    m = powerlaw_matrix(3000, 2500, 8.0, 1.5, seed=0)
    for tiles_per_group in ((1, 3) if B == 1 else (1,)):
        rows = _emulate_calls(m, red, chunk, B, windows, tiles_per_group,
                              seed=chunk + cut + B,
                              n_rows=m.n_rows - cut)
        assert rows.n_side > 0


@pytest.mark.parametrize("red", ["SEG_SCAN_RED", "ONEHOT_MXU_RED"])
@pytest.mark.parametrize("B,windows", [(1, None), (8, "whole"),
                                       (3, "keys"), (40, "whole")])
def test_last_arriver_on_a_row_shared_by_more_than_32_tiles(red, B,
                                                            windows):
    """Two rows of about 3000 nonzeros, each over 40-odd 64-slot tiles."""
    m = hyb_friendly_matrix(5000, 4, 2, 5000, seed=3)
    rows = _emulate_calls(m, red, 64, B, windows, 3, seed=B)
    assert int(rows.count.max()) > 32


@pytest.mark.parametrize("red", ["SEG_SCAN_RED", "ONEHOT_MXU_RED"])
def test_last_arriver_with_no_shared_rows(red):
    """Rows of 8 nonzeros packed 8 to a 64-slot tile: no row straddles
    tiles, so the side buffer and the counters are empty."""
    n = 512
    rows_ = np.repeat(np.arange(n), 8).astype(np.int32)
    cols = ((rows_ * 37 + np.tile(np.arange(8), n) * 11) % n).astype(
        np.int32)
    cols = np.sort(cols.reshape(n, 8), axis=1).reshape(-1)
    vals = np.random.default_rng(0).standard_normal(n * 8).astype(
        np.float32)
    m = SparseMatrix(n, n, rows_, cols, vals)
    for B, windows in ((1, None), (8, "whole")):
        rows = _emulate_calls(m, red, 64, B, windows, 1, seed=B)
        assert rows.n_side == 0 and rows.rows.numel() == 0
        assert rows.arrive.numel() == 0 and rows.cells.numel() == 0


def test_combine_orders_build_fresh_counters_for_each_plan():
    """Every plan made from a fused step's arrays (compile, load, update)
    derives its FusedRows anew: the same fields, and cells and counters
    of its own at zero, so two plans never share them."""
    m = powerlaw_matrix(600, 500, 8.0, 1.3, seed=4)
    fmt, spec = plan_format(run_graph(m, _graph("SEG_SCAN_RED", 64)),
                            fuse_combine=True)
    key = spec["steps"][0]["key"]
    a = combine_orders(spec, fmt, "cuda")[f"{key}_r0"]
    b = combine_orders(spec, fmt, "cuda")[f"{key}_r0"]
    assert a.n_side == b.n_side > 0
    for name in FusedRows._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name == "n_side":
            continue
        assert torch.equal(x, y)
    assert a.arrive.data_ptr() != b.arrive.data_ptr()
    assert a.cells.data_ptr() != b.cells.data_ptr()
    assert not b.arrive.any() and not b.cells.any()
