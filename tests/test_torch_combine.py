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
from repro_torch.core.matrices import banded_matrix, powerlaw_matrix
from repro_torch.design.registry import OpSpec
from repro_torch.dyn import PatternDelta
from repro_torch.kernels.combine import FusedRows, fused_rows
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
    sel = d <= -2
    side[-2 - d[sel]] = part[sel]
    assert torch.equal(torch.sort(-2 - d[sel]).values,
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
