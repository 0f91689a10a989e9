"""Capacity accounting for machine-designed formats (port of
``repro.dyn.capacity``).

A compiled plan's packed arrays carry more room than the pattern that
built them: ELL lanes are padded to the tile width (``LANE_PAD`` rounds
further), seg streams are padded to the chunk size, and removals free
slots behind them. This module turns a plan's JSON kernel spec + format
tensors into an explicit capacity model that :mod:`repro_torch.dyn.update`
consumes to prove a :class:`~repro_torch.dyn.delta.PatternDelta` fits in
place, and that ``SpmvPlan.describe()`` surfaces as headroom metadata.

The format tensors may live on the GPU and may be bfloat16, which numpy
cannot hold: every read goes through :func:`host_array`.

The free-slot invariant mirrors ``SparseMatrix.canonical``: *a stored
value of 0 marks a free slot* (the builders zero-fill padding and
``canonical()`` drops explicit zeros, so no live entry is ever stored as
0). Capacity semantics per family:

* **ELL** (``LANE_ROW_BLOCK``): each mapped row owns one lane of width W;
  headroom per row is ``W - row_len``. Adds need a mutable (array-mode)
  cols array and slack in the target row's lane.
* **seg** (``LANE_NNZ_BLOCK``): row ownership of every stream position is
  frozen in the segment descriptors; adds can only fill a free position
  *already owned by the same row* (a prior removal, or tail padding for
  the stream's last row). Removals and revalues always fit.
* **model-elided cols**: the column array was replaced by a fitted model
  at pack time — the pattern is frozen; only revalues and removals fit.
* **int16 cols**: narrowing only happens when ``n_cols`` fits int16, so
  any in-bounds column index fits; the margin is reported anyway.

Fused-combine metadata (affine rowmaps, ``r0`` slabs, seg descriptors)
is never touched by an in-place update, so fused-kernel preconditions
hold by construction.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["capacity_report", "capacity_lines", "host_array",
           "INT16_COL_LIMIT"]

INT16_COL_LIMIT = 32767


def host_array(t) -> np.ndarray:
    """A format tensor as a numpy array on the host.

    bfloat16 is widened to float32 through torch (exact; numpy has no
    bfloat16), every other dtype is kept (int16 cols stay int16), and a
    tensor on the GPU comes through ``.cpu()``. For a CPU tensor of a
    numpy dtype the result shares its memory: treat it as read-only."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _np_dtype(t: torch.Tensor) -> np.dtype:
    """The numpy dtype of an integer format tensor (no host copy)."""
    return np.dtype(str(t.dtype).removeprefix("torch."))


def ell_lane_rows(step: dict, fmt: dict) -> np.ndarray:
    """Global row owning each (tile, lane) of an ELL step; -1 = padding.

    Reads the rowmap array when stored, or rebuilds it from the affine
    combine parameters (slope-1 elided rowmap: lane ``i`` of the flat
    tile stream owns row ``b0 + i`` for ``i < nv``)."""
    comb = step["combine"]
    vals = fmt[f"{step['key']}_vals"]
    T, R = vals.shape[0], vals.shape[1]
    if comb["mode"] == "rowmap":
        return host_array(fmt[comb["key"]]).astype(np.int64)
    flat = np.arange(T * R, dtype=np.int64)
    rows = np.where(flat < int(comb["nv"]), int(comb["b0"]) + flat, -1)
    return rows.reshape(T, R)


def seg_position_rows(step: dict, fmt: dict) -> np.ndarray:
    """Global row owning each flat stream position of a seg step.

    Three sources, in order of directness: the stored global row stream
    (``gmem_atom``), the local-segment array composed with the rowmap
    (``onehot_mxu``), or the CSR5-style segment-end descriptor
    (``seg_scan`` — position p belongs to the segment whose index is the
    number of ends ``<= p``).

    For ``seg_scan`` the reference compares every end with every position,
    a (T, C, M) boolean (gigabytes at full size). Here each tile's ends,
    clipped to [0, C], are counted into a histogram of C + 1 bins whose
    running sum is that number: O(T * (C + M)), the same answer on any
    ends (descending, repeated, below 0, past C)."""
    key = step["key"]
    vals = fmt[f"{key}_vals"]
    T = int(vals.shape[0])
    chunk = int(np.prod(tuple(vals.shape[1:])))
    if f"{key}_rows" in fmt:
        return host_array(fmt[f"{key}_rows"]).reshape(T, chunk).astype(
            np.int64)
    rowmap = host_array(fmt[f"{key}_rowmap"]).astype(np.int64)
    if f"{key}_local" in fmt:
        local = host_array(fmt[f"{key}_local"]).reshape(T, chunk)
        return np.take_along_axis(rowmap, local.astype(np.int64), axis=1)
    seg_end = np.clip(host_array(fmt[f"{key}_end"]).astype(np.int64), 0,
                      chunk)                    # (T, seg_rows), ends
    bins = (np.arange(T, dtype=np.int64)[:, None] * (chunk + 1)
            + seg_end).reshape(-1)
    hist = np.bincount(bins, minlength=T * (chunk + 1)).reshape(T, chunk + 1)
    seg_of = np.cumsum(hist[:, :chunk], axis=1)
    return np.take_along_axis(rowmap, seg_of, axis=1)


def _occupancy(vals) -> np.ndarray:
    return host_array(vals).astype(np.float32) != 0.0


def capacity_report(plan) -> dict:
    """Headroom metadata for every step of a dense ``SpmvPlan``.

    Returns a JSON-able dict: per-step occupancy/slack plus the headline
    aggregates (``ell_slack``, ``seg_headroom``, ``frozen_steps``,
    ``int16_col_margin``, ``live_nnz``) the capacity checker and
    ``describe()`` share."""
    spec = plan.spec
    fmt = plan.fmt
    steps_out = []
    ell_slack = seg_headroom = live_nnz = frozen = 0
    int16_margin = None
    for step in spec["steps"]:
        key = step["key"]
        vals = fmt[f"{key}_vals"]
        occ = _occupancy(vals)
        used = int(occ.sum())
        live_nnz += used
        mutable = step["cols"]["mode"] == "array"
        if not mutable:
            frozen += 1
        entry = {"key": key, "kind": step["kind"], "mutable_cols": mutable,
                 "slots": int(occ.size), "used": used}
        if step["kind"] == "ell":
            rows = ell_lane_rows(step, fmt)
            W = occ.shape[2]
            lane_len = occ.sum(axis=2)
            mapped = rows >= 0
            free = int((W - lane_len[mapped]).sum())
            entry.update(width=int(W), mapped_rows=int(mapped.sum()),
                         free_slots=free,
                         min_row_slack=int((W - lane_len[mapped]).min())
                         if mapped.any() else 0)
            if mutable:
                ell_slack += free
            else:
                entry["free_slots"] = 0  # frozen pattern: slack unusable
        else:
            free = int(occ.size - used)
            entry.update(free_slots=free if mutable else 0)
            if mutable:
                seg_headroom += free
        if mutable:
            dt = _np_dtype(fmt[step["cols"]["key"]])
            entry["cols_dtype"] = str(dt)
            if dt == np.int16:
                margin = INT16_COL_LIMIT - (int(spec["n_cols"]) - 1)
                entry["int16_col_margin"] = margin
                int16_margin = (margin if int16_margin is None
                                else min(int16_margin, margin))
        steps_out.append(entry)
    return {"plan_version": int(getattr(plan, "plan_version", 0)),
            "live_nnz": live_nnz, "birth_nnz": int(spec["nnz"]),
            "ell_slack": ell_slack, "seg_headroom": seg_headroom,
            "frozen_steps": frozen, "int16_col_margin": int16_margin,
            "steps": steps_out}


def capacity_lines(plan) -> list:
    """``describe()`` rendering of :func:`capacity_report`."""
    rep = capacity_report(plan)
    head = (f"  capacity: live_nnz={rep['live_nnz']} "
            f"(birth {rep['birth_nnz']}) ell_slack={rep['ell_slack']} "
            f"seg_headroom={rep['seg_headroom']} "
            f"version={rep['plan_version']}")
    if rep["frozen_steps"]:
        head += f" frozen_steps={rep['frozen_steps']}"
    if rep["int16_col_margin"] is not None:
        head += f" int16_col_margin={rep['int16_col_margin']}"
    lines = [head]
    for s in rep["steps"]:
        detail = (f"    step {s['key']}: used {s['used']}/{s['slots']}"
                  f" free={s['free_slots']}")
        if not s["mutable_cols"]:
            detail += " cols=frozen(model-elided)"
        lines.append(detail)
    return lines
