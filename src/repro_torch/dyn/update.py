"""Patch-in-place plan updates: new tensors, same spec (port of
``repro.dyn.update``).

``update_plan(plan, delta)`` rewrites only the format *tensors* of a
compiled ``SpmvPlan`` — vals, cols, nothing else — so the returned plan
has byte-identical static metadata (spec JSON, graph, target) and the
same format keys with identically-shaped/typed tensors on the same
device. It therefore gets the same interpreted kernel function as the
source plan (``api._dense_kernel`` is keyed on the spec JSON): the
patched tensors ride the existing dispatch, kernels and all.

The source plan is never written: each patched array is uploaded as a
*new* tensor, because a serving ``PlanExecutor`` may still be running
the old plan's tensors while an update is applied.

The patch reproduces what the format builders would pack for the mutated
matrix whenever the geometry is preserved: ELL lanes keep their entries
as a column-sorted prefix (re-packed after every mutation), padding stays
``val=0 / col=0``, and seg streams keep every descriptor fixed (removals
zero values in place, adds re-fill holes owned by the same row). With an
ELL-family plan this makes in-capacity updates bit-exact against a fresh
``repro_torch.compile`` of the mutated matrix.

:class:`PlanPatcher` is the stateful fast path: it indexes the plan's
arrays once and applies a stream of deltas in O(delta) work each, which
is what makes an update orders of magnitude cheaper than re-running the
Operator Graph. ``update_plan`` is the stateless one-shot convenience.

Semantics are reconciliation, not strict set algebra: a removal of an
entry the plan doesn't store is a no-op, a revalue of a missing entry is
an add, an add over an existing entry is a revalue. This keeps the
patcher robust to bfloat16 storage underflow (a live value that rounds
to bf16 zero frees its slot — by the free-slot invariant it *must*).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.kernel_builder import materialize_cols

from .capacity import ell_lane_rows, host_array, seg_position_rows
from .delta import PatternDelta

__all__ = ["CapacityError", "CapacityCheck", "PlanPatcher", "update_plan",
           "check_capacity"]


class CapacityError(ValueError):
    """The delta does not fit the plan's packed format in place; escalate
    to a re-search (``repro_torch.dyn.manager``) or a fresh compile."""


@dataclasses.dataclass(frozen=True)
class CapacityCheck:
    """Result of a dry-run fit check."""
    fits: bool
    reasons: tuple

    def __bool__(self) -> bool:
        return self.fits


def _bf16_round(v):
    """float32 value(s) rounded through bfloat16 storage and widened back:
    torch's float32 -> bfloat16 cast rounds to nearest even, as the
    reference's ``jnp.asarray(v, jnp.bfloat16)`` does."""
    t = torch.from_numpy(np.asarray(v, np.float32).reshape(-1))
    return t.to(torch.bfloat16).float().numpy().reshape(np.shape(v))


def _upload(host: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``host`` as a new tensor of ``like``'s dtype and device (the caller
    gives ``like``'s shape). bfloat16 storage takes the float32 working
    values, already rounded through bfloat16, so the cast is exact."""
    return torch.from_numpy(np.ascontiguousarray(host)).to(
        device=like.device, dtype=like.dtype, copy=True)


class _EllStep:
    """Working state for one ELL spec step (T, R, W arrays)."""

    def __init__(self, step: dict, fmt: dict):
        self.step = step
        self.key = step["key"]
        vals = fmt[f"{self.key}_vals"]
        self.shape = tuple(vals.shape)
        self.vals = host_array(vals).astype(np.float32)
        self.mutable = step["cols"]["mode"] == "array"
        self.cols = materialize_cols(step["cols"], fmt).astype(np.int64)
        self.cols_key = step["cols"]["key"] if self.mutable else None
        rows = ell_lane_rows(step, fmt)
        self.W = int(self.vals.shape[2])
        t, r = np.nonzero(rows >= 0)
        self.lane_of = {int(rows[ti, ri]): (int(ti), int(ri))
                        for ti, ri in zip(t, r)}
        # dense row -> (t, r) lookup for the vectorized revalue path
        n = int(rows.max()) + 1 if rows.size else 0
        self.lane_t = np.full(n, -1, np.int64)
        self.lane_r = np.full(n, -1, np.int64)
        self.lane_t[rows[t, r]] = t
        self.lane_r[rows[t, r]] = r
        # builders pack each lane's live entries as a col-sorted prefix;
        # verify once so the bulk path may binary-search wide lanes
        live = self.vals != 0.0
        self.cols_sorted = bool(
            ((self.cols[:, :, 1:] >= self.cols[:, :, :-1])
             | ~live[:, :, 1:]).all())
        self.dirty_vals = False
        self.dirty_cols = False

    def lane(self, row: int):
        return self.lane_of.get(row)

    def find(self, row: int, col: int):
        tr = self.lane_of.get(row)
        if tr is None:
            return None
        t, r = tr
        hit = np.nonzero((self.cols[t, r] == col)
                         & (self.vals[t, r] != 0.0))[0]
        return (t, r, int(hit[0])) if hit.size else None

    def row_len(self, t: int, r: int) -> int:
        return int((self.vals[t, r] != 0.0).sum())

    def repack(self, t: int, r: int, undo: list) -> None:
        """Restore the builder invariant: live entries as a col-sorted
        prefix, zero padding (val=0, col=0) behind them."""
        undo.append((self.vals, (t, r), self.vals[t, r].copy()))
        undo.append((self.cols, (t, r), self.cols[t, r].copy()))
        live = self.vals[t, r] != 0.0
        order = np.argsort(self.cols[t, r][live], kind="stable")
        v = self.vals[t, r][live][order]
        c = self.cols[t, r][live][order]
        self.vals[t, r] = 0.0
        self.cols[t, r] = 0
        self.vals[t, r, :v.size] = v
        self.cols[t, r, :c.size] = c
        self.dirty_vals = True
        self.dirty_cols = True


class _SegStep:
    """Working state for one seg spec step (flat stream view)."""

    def __init__(self, step: dict, fmt: dict):
        self.step = step
        self.key = step["key"]
        vals = fmt[f"{self.key}_vals"]
        self.shape = tuple(vals.shape)
        self.vals = host_array(vals).astype(np.float32).reshape(-1)
        self.mutable = step["cols"]["mode"] == "array"
        self.cols = materialize_cols(step["cols"], fmt) \
            .astype(np.int64).reshape(-1)
        self.cols_key = step["cols"]["key"] if self.mutable else None
        self.row_at = seg_position_rows(step, fmt).reshape(-1)
        # sorted index: positions of row r are order[lo:hi]
        self.order = np.argsort(self.row_at, kind="stable")
        self.sorted_rows = self.row_at[self.order]
        self.dirty_vals = False
        self.dirty_cols = False

    def positions(self, row: int) -> np.ndarray:
        lo = np.searchsorted(self.sorted_rows, row, side="left")
        hi = np.searchsorted(self.sorted_rows, row, side="right")
        return self.order[lo:hi]

    def find(self, row: int, col: int):
        p = self.positions(row)
        hit = p[(self.cols[p] == col) & (self.vals[p] != 0.0)]
        return int(hit[0]) if hit.size else None

    def free_position(self, row: int):
        p = self.positions(row)
        hole = p[self.vals[p] == 0.0]
        return int(hole[0]) if hole.size else None


class PlanPatcher:
    """Applies :class:`PatternDelta` streams to one plan, incrementally.

    Holds host-side working copies of every step's vals/cols plus the
    row-ownership index, built once; each :meth:`apply` is O(delta) and
    transactional (all-or-nothing: a :class:`CapacityError` rolls every
    write back). ``self.plan`` always points at the latest patched plan.
    Single-writer: one patcher per live plan lineage.
    """

    def __init__(self, plan):
        if not hasattr(plan, "fmt") or not hasattr(plan, "spec"):
            raise TypeError(
                f"PlanPatcher needs a dense SpmvPlan, got "
                f"{type(plan).__name__} (sharded plans re-compile per "
                "shard instead of patching)")
        self.plan = plan
        self.spec = plan.spec
        self.bf16 = self.spec.get("storage_dtype") == "bfloat16"
        self.steps = []
        for step in self.spec["steps"]:
            if step["kind"] == "ell":
                self.steps.append(_EllStep(step, plan.fmt))
            elif step["kind"] == "seg":
                self.steps.append(_SegStep(step, plan.fmt))
            else:
                raise TypeError(f"unknown spec step kind {step['kind']!r}: "
                                "cannot patch custom layouts in place")

    # -- value quantization ------------------------------------------------
    def _store_value(self, v: float) -> float:
        """The value as the plan will actually store it (bf16 plans round
        through storage precision so the free-slot invariant survives)."""
        if self.bf16:
            return float(_bf16_round(np.float32(v)))
        return float(np.float32(v))

    # -- op primitives (each records its writes into `undo`) ---------------
    def _locate(self, row: int, col: int):
        for st in self.steps:
            found = st.find(row, col)
            if found is not None:
                return st, found
        return None, None

    def _remove(self, row: int, col: int, undo: list) -> None:
        st, found = self._locate(row, col)
        if st is None:
            return   # already absent from storage (e.g. bf16 underflow)
        if isinstance(st, _EllStep):
            t, r, w = found
            undo.append((st.vals, (t, r, w), float(st.vals[t, r, w])))
            st.vals[t, r, w] = 0.0
            st.dirty_vals = True
            if st.mutable:
                st.repack(t, r, undo)
        else:
            undo.append((st.vals, (found,), float(st.vals[found])))
            st.vals[found] = 0.0
            st.dirty_vals = True

    def _revalue(self, row: int, col: int, v: float, undo: list,
                 reasons: list) -> None:
        q = self._store_value(v)
        if q == 0.0:
            self._remove(row, col, undo)
            return
        st, found = self._locate(row, col)
        if st is None:
            self._add(row, col, v, undo, reasons)
            return
        if isinstance(st, _EllStep):
            t, r, w = found
            undo.append((st.vals, (t, r, w), float(st.vals[t, r, w])))
            st.vals[t, r, w] = q
        else:
            undo.append((st.vals, (found,), float(st.vals[found])))
            st.vals[found] = q
        st.dirty_vals = True

    def _add(self, row: int, col: int, v: float, undo: list,
             reasons: list) -> None:
        if not (0 <= row < self.spec["n_rows"]):
            raise ValueError(f"add row {row} out of range "
                             f"[0, {self.spec['n_rows']})")
        if not (0 <= col < self.spec["n_cols"]):
            raise ValueError(f"add col {col} out of range "
                             f"[0, {self.spec['n_cols']})")
        q = self._store_value(v)
        if q == 0.0:
            return                       # stores as zero: a no-op
        st, found = self._locate(row, col)
        if st is not None:               # already present: revalue
            self._revalue(row, col, v, undo, reasons)
            return
        # 1) an ELL lane owning this row with slack
        for s in self.steps:
            if isinstance(s, _EllStep) and s.mutable:
                tr = s.lane(row)
                if tr is None:
                    continue
                t, r = tr
                if s.row_len(t, r) >= s.W:
                    continue
                undo.append((s.vals, (t, r), s.vals[t, r].copy()))
                undo.append((s.cols, (t, r), s.cols[t, r].copy()))
                w = s.row_len(t, r)
                s.vals[t, r, w] = q
                s.cols[t, r, w] = col
                s.repack(t, r, undo)
                return
        # 2) a seg hole already owned by this row
        for s in self.steps:
            if isinstance(s, _SegStep) and s.mutable:
                p = s.free_position(row)
                if p is None:
                    continue
                undo.append((s.vals, (p,), float(s.vals[p])))
                undo.append((s.cols, (p,), int(s.cols[p])))
                s.vals[p] = q
                s.cols[p] = col
                s.dirty_vals = True
                s.dirty_cols = True
                return
        reasons.append(self._why_no_capacity(row, col))

    def _revalue_bulk(self, rows, cols, vals, undo: list,
                      reasons: list) -> None:
        """Vectorized revalue of existing ELL entries; everything else
        (zero-quantized, missing, seg-resident) falls back to the per-op
        path. Training-style churn is revalue-dominated, so this is what
        keeps ``apply`` O(delta) with array-op (not per-entry) constants.
        """
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float32)
        if self.bf16:
            q = _bf16_round(vals)
        else:
            q = vals
        pending = q != 0.0           # zero-quantized -> per-op remove path
        for st in self.steps:
            if not isinstance(st, _EllStep) or not st.lane_t.size \
                    or not pending.any():
                continue
            idx = np.nonzero(pending)[0]
            ridx = rows[idx]
            inb = ridx < st.lane_t.size
            t = np.where(inb, st.lane_t[np.minimum(ridx,
                                                   st.lane_t.size - 1)], -1)
            owned = t >= 0
            if not owned.any():
                continue
            idx = idx[owned]
            t = t[owned]
            r = st.lane_r[rows[idx]]
            if st.W <= 32 or not st.cols_sorted:
                # narrow lanes: dense (k, W) match is cheapest
                lanes_c = st.cols[t, r]
                lanes_v = st.vals[t, r]
                match = (lanes_c == cols[idx][:, None]) \
                    & (lanes_v != 0.0)
                hit = match.any(axis=1)
                w = np.argmax(match[hit], axis=1) if hit.any() else None
            else:
                # binary-search each lane's col-sorted live prefix; the
                # entries are grouped by lane with one sort (the
                # reference scans all of them once per lane, which is
                # quadratic when every lane is wide, as in a plan
                # padded to 512 slots)
                R = st.vals.shape[1]
                w_all = np.full(idx.size, -1, np.int64)
                lid = t * R + r
                ec = cols[idx]
                by_lane = np.argsort(lid, kind="stable")
                starts = np.flatnonzero(np.diff(lid[by_lane])) + 1
                for sel in np.split(by_lane, starts):
                    tt, rr = divmod(int(lid[sel[0]]), R)
                    ln = int((st.vals[tt, rr] != 0.0).sum())
                    lc = st.cols[tt, rr, :ln]
                    pos = np.searchsorted(lc, ec[sel])
                    ok = pos < ln
                    ok[ok] &= lc[pos[ok]] == ec[sel][ok]
                    w_all[sel[ok]] = pos[ok]
                hit = w_all >= 0
                w = w_all[hit] if hit.any() else None
            if w is None:
                continue
            ti, ri, ii = t[hit], r[hit], idx[hit]
            undo.append((st.vals, (ti, ri, w), st.vals[ti, ri, w].copy()))
            st.vals[ti, ri, w] = q[ii]
            st.dirty_vals = True
            pending[ii] = False
        for i in np.nonzero(pending | (q == 0.0))[0]:
            self._revalue(int(rows[i]), int(cols[i]), float(vals[i]),
                          undo, reasons)

    def _why_no_capacity(self, row: int, col: int) -> str:
        owners = []
        for s in self.steps:
            if isinstance(s, _EllStep) and s.lane(row) is not None:
                t, r = s.lane(row)
                tag = (f"{s.key}:lane full ({s.row_len(t, r)}/{s.W})"
                       if s.mutable else f"{s.key}:cols frozen(model-elided)")
                owners.append(tag)
            elif isinstance(s, _SegStep) and s.positions(row).size:
                tag = (f"{s.key}:no free position in row segment"
                       if s.mutable else f"{s.key}:cols frozen(model-elided)")
                owners.append(tag)
        why = "; ".join(owners) if owners else "row unmapped in every step"
        return f"add ({row},{col}): {why}"

    # -- transactions ------------------------------------------------------
    def _run(self, delta: PatternDelta, undo: list, reasons: list) -> None:
        # removals first so freed slots serve this delta's adds
        for row, col in zip(delta.drop_rows, delta.drop_cols):
            self._remove(int(row), int(col), undo)
        if len(delta.reval_rows):
            self._revalue_bulk(delta.reval_rows, delta.reval_cols,
                               delta.reval_vals, undo, reasons)
        for row, col, v in zip(delta.add_rows, delta.add_cols,
                               delta.add_vals):
            self._add(int(row), int(col), float(v), undo, reasons)

    @staticmethod
    def _rollback(undo: list) -> None:
        for arr, idx, old in reversed(undo):
            arr[idx] = old

    def check(self, delta: PatternDelta) -> CapacityCheck:
        """Dry-run fit check: no state survives, whatever the outcome."""
        undo, reasons = [], []
        try:
            self._run(delta, undo, reasons)
        finally:
            self._rollback(undo)
        return CapacityCheck(fits=not reasons, reasons=tuple(reasons))

    def apply(self, delta: PatternDelta):
        """Patch the plan; returns the new ``SpmvPlan`` (version +1).

        Raises :class:`CapacityError` (state rolled back, plan unchanged)
        when any add has no in-place slot."""
        if delta.n_rows != self.spec["n_rows"] \
                or delta.n_cols != self.spec["n_cols"]:
            raise ValueError(
                f"delta is for a {delta.n_rows}x{delta.n_cols} matrix; "
                f"plan is {self.spec['n_rows']}x{self.spec['n_cols']}")
        undo, reasons = [], []
        self._run(delta, undo, reasons)
        if reasons:
            self._rollback(undo)
            raise CapacityError(
                "delta does not fit the plan in place: "
                + "; ".join(reasons[:8])
                + (f"; (+{len(reasons) - 8} more)" if len(reasons) > 8
                   else ""))
        fmt = dict(self.plan.fmt)
        # each dirty array goes up as a new tensor: the source plan's
        # tensors are never written, since an executor may still be
        # running them
        for st in self.steps:
            if st.dirty_vals:
                key = f"{st.key}_vals"
                fmt[key] = _upload(st.vals.reshape(st.shape), fmt[key])
            if st.dirty_cols and st.mutable:
                fmt[st.cols_key] = _upload(st.cols.reshape(st.shape),
                                           fmt[st.cols_key])
            st.dirty_vals = st.dirty_cols = False
        self.plan = dataclasses.replace(
            self.plan, fmt=fmt,
            plan_version=int(getattr(self.plan, "plan_version", 0)) + 1)
        return self.plan


def update_plan(plan, delta: PatternDelta):
    """One-shot ``SpmvPlan.update`` backend: index, patch, return."""
    return PlanPatcher(plan).apply(delta)


def check_capacity(plan, delta: PatternDelta) -> CapacityCheck:
    """Does ``delta`` fit ``plan`` in place? (stateless dry run)"""
    return PlanPatcher(plan).check(delta)
