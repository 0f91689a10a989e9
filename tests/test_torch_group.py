"""Grouped ELL steps (``core.kernel_builder.ell_groups``) on the CPU: a
cuda program runs its ELL scatter steps (K7, or K1 on buckets wider than
32 slots with a 1-D x) as one grouped launch over all their width
buckets and one ordered combine over their rowmaps concatenated in step
order, where the per-step loop runs one launch and one combine a step.

Which steps group and where a group ends is checked on synthetic specs
(an interleaved fused step, a seg step, shared rows, mixed dtypes,
model-expression cols, K1's slab buckets) and on designed ELL plans of
1-26 buckets. The grouped call, on the cuda interpreter dispatching to
the plain versions on CPU tensors, is held with ``torch.equal`` to the
per-step loop (the same orders without ``ELL_GROUPS``) at B = 1, 3 and 8,
fp32 and bf16/int16; a serving-like ELL scatter plan to the reference's
``build_kernel`` on the same spec within the search tolerance
(``1e-3 * max|y| + 1e-5`` fp32, ``2e-2`` bf16); and a plan patched in
place (``PlanPatcher.apply``) to a fresh compile of the same matrix, bit
for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernel_builder import build_kernel as ref_build_kernel

import repro_torch
from repro_torch.core import matrices as tm
from repro_torch.core.graph import OperatorGraph, run_graph
from repro_torch.core.kernel_builder import (ELL_GROUPS, SPEC_VERSION,
                                             StepGroup, build_kernel,
                                             combine_orders, plan_format,
                                             spec_kernels)
from repro_torch.design.registry import OpSpec
from repro_torch.dyn import PatternDelta, PlanPatcher
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ell_spmv import GROUP_MAX, TileGroup
from repro_torch.train.dynamic import capacity_graph

SEARCH_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
ELL = OperatorGraph.chain(OpSpec.make("COMPRESS"),
                          OpSpec.make("TILE_ROW_BLOCK", rows=16),
                          OpSpec.make("LANE_ROW_BLOCK"),
                          OpSpec.make("LANE_TOTAL_RED"))


def _x(n_cols, b, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n_cols,) if b == 1 else (n_cols, b)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _bucketed(n_buckets, base=33, tile_rows=16, n_cols=700, seed=0):
    """A matrix whose row tiles of ``tile_rows`` take ``n_buckets``
    widths base, base + 1, ..., 1-3 tiles of each, the tiles shuffled: an
    ELL design of that tile height has one width bucket per width."""
    rng = np.random.default_rng(seed)
    widths = [base + b for b in range(n_buckets) for _ in range(1 + b % 3)]
    rng.shuffle(widths)
    rows, cols = [], []
    for t, w in enumerate(widths):
        for r in range(tile_rows):
            n = w if r == 0 else int(rng.integers(1, w + 1))
            rows.append(np.full(n, t * tile_rows + r, np.int32))
            cols.append(rng.choice(n_cols, n, replace=False).astype(np.int32))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return tm.SparseMatrix(len(widths) * tile_rows, n_cols, rows, cols,
                           vals).canonical()


def _plan(m, storage="float32", fuse=False, graph=ELL):
    fmt, spec = plan_format(run_graph(m, graph), storage_dtype=storage,
                            fuse_combine=fuse)
    return fmt, spec


def _per_step(order):
    """A program's orders without its groups: every step runs alone."""
    return {k: v for k, v in order.items() if k != ELL_GROUPS}


def _both(spec, fmt, x):
    """The grouped call and the per-step loop of one cuda program."""
    run = build_kernel(spec, backend="cuda")
    order = combine_orders(spec, fmt, "cuda")
    return run(fmt, x, order), run(fmt, x, _per_step(order))


def _run_order(order, ndim):
    """The run order as step indices, a group as a list of its steps."""
    return [list(it.steps) if isinstance(it, StepGroup) else it
            for it in order[ELL_GROUPS][ndim]]


# ------------------------- synthetic specs ---------------------------------

class Spec:
    """A hand-made program: ``ell(...)`` / ``seg(...)`` append steps."""

    def __init__(self, n_rows=64, n_cols=50, seed=0):
        self.n_rows, self.n_cols = n_rows, n_cols
        self.rng = np.random.default_rng(seed)
        self.fmt, self.steps = {}, []

    def _tiles(self, key, t, r, w, vals_dtype, cols_dtype):
        v = self.rng.standard_normal((t, r, w)).astype(np.float32)
        c = self.rng.integers(0, self.n_cols, (t, r, w))
        self.fmt[f"{key}_vals"] = torch.from_numpy(v).to(vals_dtype)
        return torch.from_numpy(c.astype(np.int32)).to(cols_dtype)

    def ell(self, rows=None, b0=None, nv=None, *, t=1, r=8, w=40,
            fused=False, direct=False, vals=torch.float32,
            cols=torch.int32, model=False):
        """An ELL step scattering through ``rows`` (its rowmap's valid
        rows, -1 padded to t * r) or affine over [b0, b0 + nv)."""
        key = f"b{len(self.steps)}k0"
        c = self._tiles(key, t, r, w, vals, cols)
        if model:
            # cols[t, r, w] = w: a periodic column model of period W
            cspec = {"mode": "model", "model": "periodic",
                     "params": [1, 0, 0, w], "n": t * r * w,
                     "shape": [t, r, w]}
        else:
            self.fmt[f"{key}_cols"] = c
            cspec = {"mode": "array", "key": f"{key}_cols"}
        if rows is None:
            comb = {"mode": "affine", "direct": direct, "b0": b0,
                    "nv": t * r if nv is None else nv}
        else:
            rm = np.full(t * r, -1, np.int32)
            rm[:len(rows)] = rows
            self.fmt[f"{key}_rowmap"] = torch.from_numpy(rm.reshape(t, r))
            comb = {"mode": "rowmap", "key": f"{key}_rowmap"}
        self.steps.append({"kind": "ell", "key": key, "cols": cspec,
                           "combine": comb, "fused": fused, "report": {}})
        return self

    def seg(self, rows, fused=False):
        """A seg_scan step of one tile of 4 x 8 slots and len(rows)
        segments, adding segment m into ``rows[m]`` (fused: ``rows`` must
        ascend by one from rows[0])."""
        key = f"b{len(self.steps)}s"
        m = len(rows)
        self.fmt[f"{key}_cols"] = self._tiles(key, 1, 4, 8, torch.float32,
                                              torch.int32)
        self.fmt[f"{key}_end"] = torch.from_numpy(np.sort(
            self.rng.integers(0, 33, (1, m))).astype(np.int32))
        self.fmt[f"{key}_rowmap"] = torch.tensor([rows], dtype=torch.int32)
        if fused:
            self.fmt[f"{key}_r0"] = torch.tensor([rows[0]], dtype=torch.int32)
        self.steps.append({"kind": "seg", "key": key, "reduce": "seg_scan",
                           "seg_rows": m, "rows_sorted": False,
                           "cols": {"mode": "array", "key": f"{key}_cols"},
                           "fused": fused, "report": {}})
        return self

    @property
    def spec(self):
        return {"version": SPEC_VERSION, "n_rows": self.n_rows,
                "n_cols": self.n_cols, "tiles_per_step": 1,
                "steps": self.steps}

    def check(self, want: dict):
        """The run order for each x dimension (None: no group forms),
        and both calls bit-equal at B = 1, 3 and 8."""
        order = combine_orders(self.spec, self.fmt, "cuda")
        for ndim in (1, 2):
            got = (_run_order(order, ndim)
                   if ndim in order.get(ELL_GROUPS, {}) else None)
            assert got == want[ndim], (ndim, got)
        for b in (1, 3, 8):
            g, s = _both(self.spec, self.fmt, _x(self.n_cols, b, seed=b))
            assert torch.equal(g, s), b


def _rows(lo, n):
    return list(range(lo, lo + n))


def test_steps_in_any_order_group_and_run_where_the_group_closes():
    s = (Spec().ell(_rows(0, 5)).ell(b0=8, nv=8).ell(_rows(20, 3), t=2)
         .ell(_rows(40, 8), w=64))
    s.check({1: [[0, 1, 2, 3]], 2: [[0, 1, 2, 3]]})


def test_an_interleaved_fused_step_on_other_rows_leaves_the_group_open():
    s = Spec().ell(_rows(0, 8)).ell(b0=16, fused=True).ell(_rows(8, 8))
    s.check({1: [1, [0, 2]], 2: [1, [0, 2]]})


def test_a_fused_step_on_a_row_of_an_earlier_member_ends_the_group():
    # the fused step writes rows 16-23: every row of its tile, and row 20
    # is the first member's
    s = (Spec().ell([1, 20, 3]).ell(_rows(30, 4)).ell(b0=16, fused=True)
         .ell(_rows(40, 4)).ell(_rows(50, 4)))
    s.check({1: [[0, 1], 2, [3, 4]], 2: [[0, 1], 2, [3, 4]]})


def test_a_fused_step_counts_its_padding_rows():
    # nv = 3 valid rows, but K9 / K5 add all 8 tile rows from row 16
    s = (Spec().ell([22, 1]).ell(b0=16, nv=3, fused=True).ell(_rows(40, 2))
         .ell(_rows(50, 2)))
    s.check({1: [0, 1, [2, 3]], 2: [0, 1, [2, 3]]})


def test_a_later_member_may_share_rows_with_a_step_in_between():
    # step 1 (direct) adds rows 8-15 before step 2 adds into row 9: the
    # group runs after both, so row 9 still gets step 1's add first
    s = (Spec().ell(_rows(0, 4)).ell(b0=8, direct=True).ell([9, 30])
         .ell(_rows(40, 4)))
    s.check({1: [1, [0, 2, 3]], 2: [1, [0, 2, 3]]})


def test_members_that_share_rows_add_in_step_order():
    s = Spec().ell([5, 5, 6]).ell([6, 5, 7], t=2).ell([5, 7, 7, 5])
    s.check({1: [[0, 1, 2]], 2: [[0, 1, 2]]})


@pytest.mark.parametrize("fused", [False, True])
def test_a_seg_step_ends_the_group_only_on_shared_rows(fused):
    s = (Spec().ell(_rows(0, 8)).seg(_rows(10, 4), fused).ell(_rows(20, 3))
         .seg(_rows(21, 3), fused).ell(_rows(40, 4)).ell(_rows(50, 4)))
    s.check({1: [1, [0, 2], 3, [4, 5]], 2: [1, [0, 2], 3, [4, 5]]})


def test_steps_of_other_dtypes_form_their_own_groups():
    s = (Spec().ell(_rows(0, 4)).ell(_rows(4, 4))
         .ell(_rows(8, 4), cols=torch.int16).ell(_rows(12, 4),
                                                  cols=torch.int16)
         .ell(_rows(16, 4), vals=torch.bfloat16, cols=torch.int16)
         .ell(_rows(20, 4), vals=torch.bfloat16, cols=torch.int16))
    s.check({1: [[0, 1], [2, 3], [4, 5]], 2: [[0, 1], [2, 3], [4, 5]]})


def test_model_expression_cols_join_materialised_once():
    s = (Spec().ell(_rows(0, 4), model=True).ell(_rows(4, 4))
         .ell(_rows(8, 4), model=True, w=48))
    s.check({1: [[0, 1, 2]], 2: [[0, 1, 2]]})
    order = combine_orders(s.spec, s.fmt, "cuda")
    group = order[ELL_GROUPS][2][0]
    assert [ck for _, ck in group.keys] == [None, "b1k0_cols", None]
    want = torch.arange(40, dtype=torch.int32).expand(1, 8, 40)
    assert torch.equal(group.tiles.cols[0], want)


def test_slab_buckets_group_for_a_2d_x_and_run_alone_for_a_1d_x():
    # W <= 32 runs through K1's slab kernel, one launch a bucket; step 2
    # shares row 3 with step 0, so K1's group ends before it
    s = (Spec().ell(_rows(0, 4), w=40).ell(_rows(8, 4), w=16)
         .ell([3, 30], w=32).ell(_rows(40, 4), w=33).ell(_rows(50, 4)))
    s.check({1: [1, 0, 2, [3, 4]], 2: [[0, 1, 2, 3, 4]]})


def test_direct_and_fused_steps_never_group():
    s = (Spec().ell(b0=0, direct=True).ell(b0=8, fused=True)
         .ell(b0=16, direct=True))
    s.check({1: None, 2: None})
    assert ELL_GROUPS not in combine_orders(s.spec, s.fmt, "cuda")


def test_one_step_alone_is_no_group():
    s = Spec().ell(_rows(0, 8)).ell(b0=8, fused=True)
    s.check({1: None, 2: None})


# ------------------------- designed plans ----------------------------------

@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_buckets", [1, 2, 5, 26])
def test_designed_plan_groups_every_bucket_bit_for_bit(n_buckets, storage):
    m = _bucketed(n_buckets, seed=n_buckets)
    fmt, spec = _plan(m, storage)
    assert len(spec["steps"]) == n_buckets
    order = combine_orders(spec, fmt, "cuda")
    if n_buckets == 1:
        assert ELL_GROUPS not in order
    else:
        every = [list(range(n_buckets))]
        assert _run_order(order, 1) == _run_order(order, 2) == every
        group = order[ELL_GROUPS][2][0]
        assert order[ELL_GROUPS][1][0] is group      # one build serves both
        assert group.tiles.n_rows == sum(
            fmt[f"{st['key']}_vals"].shape[0] * fmt[f"{st['key']}_vals"]
            .shape[1] for st in spec["steps"])
    for b in (1, 3, 8):
        got, want = _both(spec, fmt, _x(m.n_cols, b, seed=b))
        assert torch.equal(got, want), b
        oracle = (m.spmv_dense_oracle(_x(m.n_cols, b, seed=b).numpy())
                  if b == 1 else m.spmm_dense_oracle(
                      _x(m.n_cols, b, seed=b).numpy()))
        err = np.abs(got.numpy() - oracle).max()
        assert err <= SEARCH_TOL[storage] * np.abs(oracle).max() + 1e-5


@pytest.mark.parametrize("b", [1, 3, 8])
def test_fused_plan_groups_around_its_fused_buckets(b):
    """The default ``fuse_combine``: single-tile buckets have contiguous
    rows and run fused (K5 / K9) between the group's members; their rows
    are the group's by none, so one group holds every other bucket."""
    m = _bucketed(12, seed=4)
    fmt, spec = _plan(m, fuse=True)
    fused = [i for i, st in enumerate(spec["steps"]) if st.get("fused")]
    assert fused and len(fused) < len(spec["steps"]) - 1
    order = combine_orders(spec, fmt, "cuda")
    rest = [i for i in range(len(spec["steps"])) if i not in fused]
    assert _run_order(order, 2) == fused + [rest]
    got, want = _both(spec, fmt, _x(m.n_cols, b, seed=b))
    assert torch.equal(got, want)


def test_narrow_buckets_split_the_1d_run_order_only():
    """Widths 25-40: K1 runs its slab buckets (W <= 32) alone and groups
    the others; K7 groups them all."""
    m = _bucketed(16, base=25, seed=6)
    fmt, spec = _plan(m)
    widths = [fmt[f"{st['key']}_vals"].shape[2] for st in spec["steps"]]
    order = combine_orders(spec, fmt, "cuda")
    narrow = [i for i, w in enumerate(widths) if w <= 32]
    wide = [i for i, w in enumerate(widths) if w > 32]
    assert narrow and len(wide) > 1
    assert _run_order(order, 1) == narrow + [wide]
    assert _run_order(order, 2) == [list(range(len(widths)))]
    for b in (1, 8):
        got, want = _both(spec, fmt, _x(m.n_cols, b, seed=b))
        assert torch.equal(got, want)


def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_serving_like_plan_matches_reference_build_kernel(storage, b):
    """A pruned random layer's ELL scatter plan (tiles of 128 rows, the
    serving plan's design, its widths in many buckets): the grouped call
    against the reference's ``build_kernel`` on the same spec."""
    from repro_torch.serve import prune_magnitude
    w = np.random.default_rng(0).standard_normal((2048, 768),
                                                 dtype=np.float32)
    m = prune_magnitude(w, 0.08)
    graph = OperatorGraph.chain(OpSpec.make("COMPRESS"),
                                OpSpec.make("TILE_ROW_BLOCK", rows=128),
                                OpSpec.make("LANE_ROW_BLOCK"),
                                OpSpec.make("LANE_TOTAL_RED"))
    fmt, spec = _plan(m, storage, graph=graph)
    order = combine_orders(spec, fmt, "cuda")
    assert len(spec["steps"]) > 4
    assert _run_order(order, 2) == [list(range(len(spec["steps"])))]
    x = _x(m.n_cols, b, seed=20 + b)
    got = build_kernel(spec, backend="cuda")(fmt, x, order).numpy()
    want = np.asarray(ref_build_kernel(spec, backend="jax")(
        {k: _to_jax(v) for k, v in fmt.items()}, x.numpy()))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SEARCH_TOL[storage] * scale + 1e-5)


# ------------------------- plans: update, load -----------------------------

def _cuda_call(plan, x, order=None):
    """A torch-backend plan's spec and tensors through the cuda
    interpreter (the plain versions on CPU tensors), grouped."""
    spec = plan.spec
    order = order or combine_orders(spec, plan.fmt, "cuda")
    return build_kernel(spec, backend="cuda")(plan.fmt, x, order)


def _keep_lengths(m, seed):
    """Revalue a tenth of the entries and move a twentieth to other
    columns of their rows: every row keeps its length."""
    rng = np.random.default_rng(seed)
    cols, vals = m.cols.copy(), m.vals.copy()
    rev = rng.choice(m.nnz, m.nnz // 10, replace=False)
    vals[rev] = rng.standard_normal(rev.size).astype(np.float32) + 0.1
    taken = set(zip(m.rows.tolist(), cols.tolist()))
    for i in rng.choice(m.nnz, m.nnz // 20, replace=False):
        r = int(m.rows[i])
        for c in rng.permutation(m.n_cols)[:20]:
            if (r, int(c)) not in taken:
                taken.discard((r, int(cols[i])))
                taken.add((r, int(c)))
                cols[i] = c
                break
    return tm.SparseMatrix(m.n_rows, m.n_cols, m.rows.copy(), cols,
                           vals).canonical()


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_patched_plan_groups_like_a_fresh_compile(storage):
    target = repro_torch.Target(backend="torch", dtype=storage)
    m = tm.powerlaw_matrix(200, 180, 20.0, 1.1, seed=3)
    plan = repro_torch.compile(m, target, graph=capacity_graph())
    m1 = _keep_lengths(m, seed=5)
    upd = PlanPatcher(plan).apply(PatternDelta.from_matrices(m, m1))
    fresh = repro_torch.compile(m1, target, graph=capacity_graph())
    order = combine_orders(upd.spec, upd.fmt, "cuda")
    assert any(isinstance(it, StepGroup) for it in order[ELL_GROUPS][2])
    for it in order[ELL_GROUPS][2]:
        if isinstance(it, StepGroup):                # the patched tensors
            assert all(v is upd.fmt[k] for (k, _), v in zip(it.keys,
                                                            it.tiles.vals))
    stale = combine_orders(plan.spec, plan.fmt, "cuda")
    for b in (1, 3, 8):
        x = _x(m.n_cols, b, seed=b)
        got = _cuda_call(upd, x, order)
        assert torch.equal(got, _cuda_call(fresh, x))
        assert torch.equal(got, build_kernel(upd.spec, backend="cuda")(
            upd.fmt, x, _per_step(order)))
        # the source plan's groups, handed the patched tensors, build a
        # launch of those (the rowmaps are the same)
        assert torch.equal(got, _cuda_call(upd, x, stale))


def test_loaded_plan_builds_the_same_groups(tmp_path):
    m = _bucketed(6, seed=9)
    plan = repro_torch.compile(m, repro_torch.Target(backend="torch"),
                               graph=ELL)
    path = tmp_path / "p.plan.npz"
    plan.save(path)
    with np.load(path) as z:
        assert not any("group" in k for k in z.files)
    loaded = repro_torch.load_plan(path)
    a = combine_orders(plan.spec, plan.fmt, "cuda")[ELL_GROUPS][2][0]
    b = combine_orders(loaded.spec, loaded.fmt, "cuda")[ELL_GROUPS][2][0]
    assert a.steps == b.steps and a.keys == b.keys
    assert all(torch.equal(s, t) for s, t in zip(a.order, b.order))
    for b_ in (1, 8):
        x = _x(m.n_cols, b_)
        assert torch.equal(_cuda_call(plan, x), _cuda_call(loaded, x))


def test_torch_backend_and_the_dispatch_stay_per_step():
    m = _bucketed(5, seed=2)
    fmt, spec = _plan(m)
    assert ELL_GROUPS not in combine_orders(spec, fmt, "torch")
    assert spec_kernels(spec) == ["K1", "rowmap_combine"]
    assert spec_kernels(spec, batched=True) == ["K7", "rowmap_combine"]


# ------------------------- the grouped wrappers ----------------------------

@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("types", [(torch.float32, torch.int32),
                                   (torch.bfloat16, torch.int16)])
def test_grouped_wrappers_are_the_buckets_concatenated(types, b):
    rng = np.random.default_rng(b)
    shapes = [(1, 8, 40), (3, 4, 33), (2, 16, 7), (1, 1, 100)]
    vals = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(types[0]) for s in shapes]
    cols = [torch.from_numpy(rng.integers(0, 55, s).astype(np.int32))
            .to(types[1]) for s in shapes]
    x = _x(55, b, seed=b)
    group = TileGroup(vals, cols)
    assert group.offsets == (0, 8, 20, 52, 53) and group.n_rows == 53
    assert group.chunks == ()                        # none on the CPU
    if b == 1:
        got = ops.ell_spmv_grouped(group, x)
        want = torch.cat([ops.ell_spmv(v, c, x).reshape(-1)
                          for v, c in zip(vals, cols)])
        assert torch.equal(got, ref.ell_spmv_grouped_ref(vals, cols, x))
    else:
        got = ops.ell_spmm_grouped(group, x)
        want = torch.cat([ops.ell_spmm(v, c, x).reshape(-1, b)
                          for v, c in zip(vals, cols)])
        assert torch.equal(got, ref.ell_spmm_grouped_ref(vals, cols, x))
    assert torch.equal(got, want)


def test_tile_group_refuses_what_one_launch_cannot_take():
    v = torch.zeros((1, 4, 8))
    c = torch.zeros((1, 4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        TileGroup([v, v], [c, c.to(torch.int16)])
    with pytest.raises(TypeError):
        TileGroup([v, v.to(torch.bfloat16)], [c, c])
    with pytest.raises(ValueError):
        TileGroup([v, torch.zeros((1, 0, 8))], [c, torch.zeros(
            (1, 0, 8), dtype=torch.int32)])
    with pytest.raises(ValueError):
        TileGroup([v], [c, c])
    with pytest.raises(ValueError):
        TileGroup([v.transpose(1, 2)], [c.transpose(1, 2)])
    assert GROUP_MAX == 64


def test_launch_counts_hold_the_grouped_kernels_under_k1_and_k7():
    before = ops.launch_counts()
    ops.ell_spmv_grouped.launches += 2
    ops.ell_spmm_grouped.launches += 3
    try:
        after = ops.launch_counts()
        assert after["K1"] == before["K1"] + 2
        assert after["K7"] == before["K7"] + 3
    finally:
        ops.ell_spmv_grouped.launches -= 2
        ops.ell_spmm_grouped.launches -= 3
