"""Format & Kernel Generator (paper §V) on PyTorch: project an executed
Operator Graph (a MetadataSet) onto a concrete format (tensors) + kernel.

Port of ``repro.core.kernel_builder``. Two backends share one plan:
  * ``torch`` — plain PyTorch tensor code (the port's CPU path, the
    analogue of the reference's ``jax`` backend);
  * ``cuda``  — the hand-written Hopper kernels in ``repro_torch.kernels``
    (the analogue of ``pallas``), with the in-kernel fused combine.

The generator is two explicit stages, as in the reference:

1. ``plan_format(meta, device=...)`` packs the format arrays (``fmt``:
   name -> tensor on ``device``) and emits the JSON-able *kernel spec*.
   The spec is byte-for-byte the reference's (``json.dumps`` equal) and
   the arrays are bit-identical to the reference's, bf16 included, so a
   plan saved by either package loads in the other.
2. ``build_kernel(spec, backend)`` interprets the spec into the runnable
   ``fn(fmt, x)``.

``x`` is ``(n_cols,)`` (SpMV kernels K1-K6) or ``(n_cols, B)`` (the
multi-RHS SpMM kernels K7-K11, format read once for all B columns; the
output is ``(n_rows, B)``). A 2-D x with ``B = 1`` also takes the SpMM
kernels, as in the reference.

Model-Driven Format Compression (``compress.py``) runs here: fitted arrays
are elided from the stored format and recomputed at call time; an affine
rowmap upgrades the combine to GRID_ACC (direct output writes, no scatter).

Fused combine (cuda backend): when a step's output rows are provably
contiguous — affine slope-1 rowmap for ELL, per-tile ascending row runs
for the seg family — the step is marked ``fused`` and the kernel adds its
rows straight into y, so the scatter pass over tile partials disappears.

Fixed combine order: a program's rowmap combines and its fused seg steps'
shared rows add their partials in an order fixed once per program
(:func:`combine_orders`, derived from the descriptors and never saved), so
two calls of a program, or of a saved-and-loaded plan, give the same bits.

Mixed-precision storage: ``storage_dtype="bfloat16"`` stores vals as bf16
(and explicit cols arrays as int16 when ``n_cols`` fits), recorded per
step under ``"store"``; kernels upcast in registers and accumulate fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from . import compress
from .deprecation import warn_once
from .metadata import Block, EllTileLayout, MetadataSet, SegTileLayout

__all__ = ["SpmvProgram", "build_program", "build_spmv", "plan_format",
           "build_kernel",
           "register_layout_planner", "resolve_device", "run_spec_step",
           "step_reads", "spec_kernels", "materialize_cols", "combine_orders",
           "SPEC_VERSION", "BACKENDS"]

SPEC_VERSION = 2

BACKENDS = ("cuda", "torch")

# explicit cols arrays narrow to int16 when every column index fits
_INT16_MAX_COLS = 32767


def resolve_device(backend: str) -> torch.device:
    """The device a backend's tensors live on. ``cuda`` never falls back
    to the CPU: without a GPU it raises."""
    if backend == "torch":
        return torch.device("cpu")
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r} (cuda | torch)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "backend 'cuda' needs a CUDA device and none is available; "
            "ask for the CPU explicitly with backend='torch'")
    return torch.device("cuda", torch.cuda.current_device())


@dataclasses.dataclass
class SpmvProgram:
    """A generated SpMV program: format tensors + kernel spec + report.

    ``fmt`` (the packed format tensors) and ``spec`` (the JSON-able kernel
    description) fully determine the program; ``fn`` is
    ``build_kernel(spec, backend)`` and carries no baked-in constants.
    ``order`` is the program's fixed combine order (:func:`combine_orders`),
    derived from ``fmt`` and ``spec`` when the program is made.
    """

    n_rows: int
    n_cols: int
    nnz: int
    fmt: dict                     # name -> torch.Tensor (the stored format)
    fn: Callable                  # fn(fmt, x, order) -> y
    descriptor: dict              # structural report (kernels, combines, fits)
    spec: dict = None             # JSON-able kernel spec (see plan_format)
    backend: str = "cuda"
    order: dict = None            # derived: combine_orders(spec, fmt)

    def __post_init__(self):
        if self.order is None and self.spec is not None:
            self.order = combine_orders(self.spec, self.fmt, self.backend)

    def __call__(self, x):
        return self.fn(self.fmt, x, self.order)

    @property
    def stored_bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.fmt.values())

    @property
    def padded_nnz(self) -> int:
        return self.descriptor["padded_nnz"]

    def flops(self) -> int:
        return 2 * self.nnz  # useful flops; padding waste is padded_nnz-based


def _col_model_expr(kind: str, params, n: int, shape, device):
    """Recompute an elided int array (int32, on ``device``)."""
    i = torch.arange(int(n), dtype=torch.int32, device=device)
    if kind == "linear":
        a, b = params
        v = a * i + b
    elif kind == "step":
        a, b, k = params
        v = a * torch.div(i, k, rounding_mode="floor") + b
    else:
        a, b, c, p = params
        v = a * (i % p) + c * torch.div(i, p, rounding_mode="floor") + b
    return v.to(torch.int32).reshape(tuple(shape))


def materialize_cols(colspec: dict, fmt: dict) -> np.ndarray:
    """Host-side column-index array for a spec step (array or fitted model).

    A numpy copy on the host, whatever device the format lives on; stored
    int16 cols stay int16 and a model-elided array comes back int32. The
    in-place plan patcher (``repro_torch.dyn.update``) reads cols through
    it.
    """
    if colspec["mode"] == "array":
        return fmt[colspec["key"]].detach().cpu().numpy().copy()
    return _col_model_expr(colspec["model"], colspec["params"], colspec["n"],
                           colspec["shape"], "cpu").numpy()


def _plan_ell_block(bi: int, block: Block, fmt: dict,
                    steps: list, reports: list, do_compress: bool):
    """Plan one ELL-layout block: one spec step per width bucket."""
    layout: EllTileLayout = block.layout
    for ki, bucket in enumerate(layout.buckets):
        key = f"b{bi}k{ki}"
        fmt[f"{key}_vals"] = np.asarray(bucket.vals)
        rep = {"kernel": "ell", "width": bucket.width,
               "tiles": bucket.n_tiles, "tile_rows": bucket.tile_rows}

        # --- model-driven compression: cols ---
        col_model = compress.fit_array(bucket.cols) if do_compress else None
        if col_model is not None and col_model.n_exceptions == 0:
            rep["cols"] = f"elided({col_model.kind})"
            colspec = {"mode": "model", "model": col_model.kind,
                       "params": [int(p) for p in col_model.params],
                       "n": int(np.prod(bucket.cols.shape)),
                       "shape": [int(s) for s in bucket.cols.shape]}
        else:
            fmt[f"{key}_cols"] = np.asarray(bucket.cols)
            colspec = {"mode": "array", "key": f"{key}_cols"}

        # --- model-driven compression: rowmap -> combine upgrade ---
        affine = compress.affine_rowmap(bucket.rowmap) if do_compress else None
        want_direct = (block.reduce.combine == "grid_acc")
        if affine is not None and affine[0] == 1:
            _, b0 = affine
            nv = int((bucket.rowmap.ravel() >= 0).sum())
            rep["combine"] = "grid_acc" if want_direct else "scatter(affine)"
            rep["rowmap"] = "elided(linear)"
            combspec = {"mode": "affine", "direct": bool(want_direct),
                        "b0": int(b0), "nv": nv}
        else:
            if want_direct:
                rep["combine"] = "scatter(grid_acc-fallback: rowmap not affine)"
            else:
                rep["combine"] = "scatter"
            fmt[f"{key}_rowmap"] = np.asarray(bucket.rowmap)
            combspec = {"mode": "rowmap", "key": f"{key}_rowmap"}

        steps.append({"kind": "ell", "key": key, "cols": colspec,
                      "combine": combspec, "report": rep})
        reports.append(rep)


def _plan_seg_block(bi: int, block: Block, fmt: dict, steps: list,
                    reports: list, do_compress: bool):
    layout: SegTileLayout = block.layout
    key = f"b{bi}s"
    fmt[f"{key}_vals"] = np.asarray(layout.vals)
    rep = {"kernel": block.reduce.kind, "tiles": layout.n_tiles,
           "seg_rows": layout.seg_rows, "combine": "scatter"}
    rows_sorted = False
    if block.reduce.kind == "gmem_atom":
        # GMEM_ATOM_RED stores the global row stream directly (Merge/COO
        # style): the torch backend reduces it with one index_add_
        T = layout.vals.shape[0]
        rows_global = np.take_along_axis(
            layout.rowmap, layout.local_row.reshape(T, -1), axis=1)
        fmt[f"{key}_rows"] = rows_global.astype(np.int32)
        # without converting-stage reordering the row stream stays sorted
        rows_sorted = bool(np.all(np.diff(rows_global.ravel()) >= 0))
        rep["rows_sorted"] = rows_sorted
        # the cuda backend runs gmem_atom through the seg_scan kernel,
        # which needs the descriptor arrays
        fmt[f"{key}_rowmap"] = layout.rowmap
        fmt[f"{key}_local"] = layout.local_row
        fmt[f"{key}_end"] = layout.seg_end
    else:
        fmt[f"{key}_rowmap"] = layout.rowmap
        if block.reduce.kind == "onehot_mxu":
            fmt[f"{key}_local"] = layout.local_row
        else:  # seg_scan consumes the CSR5-style segment descriptor
            fmt[f"{key}_end"] = layout.seg_end
    col_model = compress.fit_array(layout.cols) if do_compress else None
    if col_model is not None and col_model.n_exceptions == 0:
        rep["cols"] = f"elided({col_model.kind})"
        colspec = {"mode": "model", "model": col_model.kind,
                   "params": [int(p) for p in col_model.params],
                   "n": int(np.prod(layout.cols.shape)),
                   "shape": [int(s) for s in layout.cols.shape]}
    else:
        fmt[f"{key}_cols"] = np.asarray(layout.cols)
        colspec = {"mode": "array", "key": f"{key}_cols"}
    steps.append({"kind": "seg", "key": key, "reduce": block.reduce.kind,
                  "seg_rows": int(layout.seg_rows),
                  "rows_sorted": rows_sorted, "cols": colspec,
                  "report": rep})
    reports.append(rep)


# Layout -> spec-step planner dispatch, keyed on the layout *type* so an
# out-of-tree operator that packs its own layout class can register a
# planner. Planners write numpy arrays into ``fmt``; ``plan_format`` moves
# them to the device at the end.
_LAYOUT_PLANNERS: dict[type, Callable] = {}


def register_layout_planner(layout_cls: type, *, replace: bool = False):
    """Register a format planner for a custom layout type."""
    def deco(fn: Callable) -> Callable:
        if layout_cls in _LAYOUT_PLANNERS and not replace:
            raise ValueError(f"planner for {layout_cls.__name__} already "
                             "registered; pass replace=True to override")
        _LAYOUT_PLANNERS[layout_cls] = fn
        return fn
    return deco


register_layout_planner(EllTileLayout)(_plan_ell_block)
register_layout_planner(SegTileLayout)(_plan_seg_block)


def _contiguous_rowmap(rm: np.ndarray) -> bool:
    """True when every tile's used slots are a prefix ascending by 1 from
    slot 0 (rowmap[t, m] = rowmap[t, 0] + m) — the precondition for the
    fused seg combine (dense accumulate at r0 instead of a scatter)."""
    used = rm >= 0
    if not used.any():
        return True
    prefix_ok = bool(np.all(used[:, 1:] <= used[:, :-1]))
    idx = np.arange(rm.shape[1])
    r0 = np.where(used[:, 0], rm[:, 0], 0)
    vals_ok = bool(np.all(np.where(used, rm == r0[:, None] + idx[None, :],
                                   True)))
    return prefix_ok and vals_ok


def _finalize_steps(fmt: dict, steps: list, n_cols: int, storage_dtype: str,
                    fuse_combine: bool) -> None:
    """Post-planner pass: mark fused-combine steps and narrow storage.

    bf16 vals stay fp32 numpy here and are narrowed by ``plan_format``
    when it converts to tensors (``_BF16_KEYS`` marks them)."""
    for step in steps:
        key = step["key"]
        if step["kind"] == "ell":
            # affine slope-1 rowmap: tile i owns rows [b0+i*R, b0+(i+1)*R)
            # -> the fused kernel writes them in place, no combine pass
            fused = bool(fuse_combine
                         and step["combine"]["mode"] == "affine")
            step["fused"] = fused
            if fused:
                step["report"]["combine"] = "fused(in-kernel)"
        elif step["kind"] == "seg":
            rm = np.asarray(fmt[f"{key}_rowmap"])
            if fuse_combine and rm.size and _contiguous_rowmap(rm):
                r0 = np.where(rm[:, 0] >= 0, rm[:, 0], 0).astype(np.int32)
                fmt[f"{key}_r0"] = r0
                step["fused"] = True
                # the reference's static slab bound, kept for spec parity
                step["fused_rows"] = int(r0.max()) + int(step["seg_rows"])
                step["report"]["combine"] = "fused(carry)"
            else:
                step["fused"] = False
        else:
            continue
        if storage_dtype == "bfloat16":
            store = {"vals": "bfloat16"}
            cspec = step["cols"]
            if cspec["mode"] == "array" and n_cols <= _INT16_MAX_COLS:
                fmt[cspec["key"]] = np.asarray(fmt[cspec["key"]], np.int16)
                store["cols"] = "int16"
            step["store"] = store
            step["report"]["store"] = "+".join(
                f"{k}:{v}" for k, v in sorted(store.items()))


def _to_tensor(a: np.ndarray, bf16: bool, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))   # a copy: fmt never aliases meta
    if bf16:
        # round-to-nearest-even fp32 -> bf16, as jnp.asarray(.., bfloat16)
        t = t.to(torch.bfloat16)
    return t.to(device)


def plan_format(meta: MetadataSet, do_compress: bool = True, *,
                storage_dtype: str = None, tiles_per_step: int = None,
                fuse_combine: bool = True, device="cpu"
                ) -> tuple[dict, dict]:
    """Stage 1: pack format tensors on ``device`` and emit the kernel spec.

    ``storage_dtype`` / ``tiles_per_step`` default to the MetadataSet's
    SET_RESOURCES decisions; pass them explicitly to override.
    ``fuse_combine=False`` disables the in-kernel combine.
    """
    for b in meta.blocks:
        if b.layout is None or b.reduce is None:
            raise ValueError("metadata not fully designed: run mapping and "
                             "implementing operators first")
    sd = storage_dtype or getattr(meta, "storage_dtype", "float32")
    if sd not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported storage_dtype {sd!r} "
                         "(float32 | bfloat16)")
    kts = int(tiles_per_step or getattr(meta, "tiles_per_step", 1) or 1)
    fmt: dict = {}
    steps: list = []
    reports: list = []
    for bi, block in enumerate(meta.blocks):
        planner = _LAYOUT_PLANNERS.get(type(block.layout))
        if planner is None:
            raise ValueError(
                f"no format planner registered for layout type "
                f"{type(block.layout).__name__}; register one with "
                "repro_torch.core.kernel_builder.register_layout_planner")
        planner(bi, block, fmt, steps, reports, do_compress)
    _finalize_steps(fmt, steps, int(meta.n_cols), sd, fuse_combine)
    bf16_keys = ({f"{s['key']}_vals" for s in steps if "store" in s}
                 if sd == "bfloat16" else set())
    fmt = {k: _to_tensor(v, k in bf16_keys, device) for k, v in fmt.items()}
    spec = {"version": SPEC_VERSION,
            "n_rows": int(meta.n_rows), "n_cols": int(meta.n_cols),
            "nnz": int(meta.nnz), "padded_nnz": int(meta.padded_nnz()),
            "tiles_per_step": max(kts, 1), "storage_dtype": sd,
            "history": list(meta.history), "steps": steps}
    return fmt, spec


def _step_cols(step: dict, fmt: dict, device):
    cspec = step["cols"]
    if cspec["mode"] == "array":
        return fmt[cspec["key"]]
    return _col_model_expr(cspec["model"], cspec["params"], cspec["n"],
                           cspec["shape"], device)


def combine_orders(spec: dict, fmt: dict, backend: str) -> dict:
    """The fixed combine order of a program, by fmt key: for each rowmap
    that a step scatters through on ``backend``, its ``(perm, offsets)``
    (``kernels.combine.combine_order``); for each fused seg step on the
    cuda backend, its ``FusedRows`` (``kernels.combine.fused_rows``)
    under ``{key}_r0``. Derived from the descriptors (rowmaps, r0,
    seg_end, local_row) on their device; never saved."""
    from repro_torch.kernels.combine import combine_order, fused_rows
    n_rows = spec["n_rows"]
    out = {}
    for step in spec["steps"]:
        key = step["key"]
        if step["kind"] == "ell":
            if step["combine"]["mode"] == "rowmap":
                rk = step["combine"]["key"]
                out[rk] = combine_order(fmt[rk], n_rows)
            continue
        kind = step["reduce"]
        if kind == "gmem_atom" and backend != "cuda":
            continue                    # one index_add_ over the row stream
        if (backend == "cuda" and step.get("fused")
                and f"{key}_r0" in fmt):
            mode = "seg_scan" if kind == "gmem_atom" else kind
            aux = fmt[f"{key}_end" if mode == "seg_scan" else f"{key}_local"]
            shape = fmt[f"{key}_vals"].shape
            out[f"{key}_r0"] = fused_rows(fmt[f"{key}_r0"], aux,
                                          step["seg_rows"], n_rows, mode,
                                          shape[1] * shape[2])
        else:
            rk = f"{key}_rowmap"
            out[rk] = combine_order(fmt[rk], n_rows)
    return out


def _add_rows(y, flat, order):
    """y[rm[i]] += flat[i] for every rm[i] >= 0 of the step's rowmap rm
    (the scatter combine); ``flat`` is (N,) or (N, B). The partials go
    through
    ``kernels.combine.rowmap_combine`` in the rowmap's ``order``
    (``perm``, ``offsets`` of ``kernels.combine.combine_order``), so a
    row's partials are added in one order on every call."""
    from repro_torch.kernels import ops as kops
    kops.rowmap_combine(y, flat.contiguous(), *order)


def _run_ell_step(step: dict, fmt: dict, x, y, n_rows: int,
                  backend: str, tiles_per_step: int, order: dict):
    rhs = tuple(x.shape[1:])
    key = step["key"]
    vals = fmt[f"{key}_vals"]
    cols = _step_cols(step, fmt, x.device)
    comb = step["combine"]
    if backend == "cuda":
        from repro_torch.kernels import ops as kops  # lazy: keeps core light
        if step.get("fused") and comb["mode"] == "affine":
            # fused combine: the kernel adds its rows straight into y
            op = kops.ell_spmm_fused if rhs else kops.ell_spmv_fused
            op(vals, cols, x, row0=comb["b0"], n_rows=n_rows,
               tiles_per_step=tiles_per_step, out=y)
            return y
        if comb["mode"] == "affine" and comb["direct"]:
            op = kops.ell_spmm_direct if rhs else kops.ell_spmv_direct
        else:
            op = kops.ell_spmm if rhs else kops.ell_spmv
        partial = op(vals, cols, x)
    else:
        from repro_torch.kernels import ref as kref
        op = kref.ell_spmm_ref if rhs else kref.ell_spmv_ref
        partial = op(vals, cols, x)
    flat = partial.reshape((-1,) + rhs)
    if comb["mode"] == "rowmap":
        rm_key = comb["key"]
        _add_rows(y, flat, order[rm_key])
        return y
    b0, nv = comb["b0"], comb["nv"]
    y[b0:b0 + nv] += flat[:nv]
    return y


def _run_seg_step(step: dict, fmt: dict, x, y, n_rows: int,
                  backend: str, tiles_per_step: int, order: dict):
    rhs = tuple(x.shape[1:])
    key = step["key"]
    kind = step["reduce"]
    vals = fmt[f"{key}_vals"]
    cols = _step_cols(step, fmt, x.device)
    if kind == "gmem_atom" and backend != "cuda":
        # GMEM_ATOM_RED: one global reduction of the product stream; rows
        # stored directly in the format (padded entries carry val=0 and a
        # valid row -> no masking)
        g = x[cols.long()].float()
        v = vals.float()[..., None] if rhs else vals.float()
        prod = (v * g).reshape((-1,) + rhs)
        y.index_add_(0, fmt[f"{key}_rows"].reshape(-1).long(), prod)
        return y
    local = fmt.get(f"{key}_local")
    seg_end = fmt.get(f"{key}_end")
    seg_rows = step["seg_rows"]
    if backend == "cuda":
        from repro_torch.kernels import ops as kops
        # no global-memory atomics in the reference's kernel set either:
        # gmem_atom runs through the seg_scan kernel, as on the TPU
        pk = "seg_scan" if kind == "gmem_atom" else kind
        if step.get("fused") and f"{key}_r0" in fmt:
            op = kops.seg_spmm_fused if rhs else kops.seg_spmv_fused
            op(vals, cols, local, seg_end, fmt[f"{key}_r0"], x, seg_rows,
               n_rows=n_rows, mode=pk, tiles_per_step=tiles_per_step, out=y,
               rows=order[f"{key}_r0"])
            return y
        op = kops.seg_spmm if rhs else kops.seg_spmv
        partial = op(vals, cols, local, seg_end, x, seg_rows, mode=pk)
    else:
        from repro_torch.kernels import ref as kref
        op = kref.seg_spmm_ref if rhs else kref.seg_spmv_ref
        partial = op(vals, cols, local, seg_end, x, seg_rows, mode=kind)
    rm_key = f"{key}_rowmap"
    _add_rows(y, partial.reshape((-1,) + rhs), order[rm_key])
    return y


def run_spec_step(step: dict, fmt: dict, x, y, n_rows: int,
                  backend: str, tiles_per_step: int, order: dict):
    """Accumulate one spec step's contribution into y in place and return
    y; ``x`` is (n_cols,) or (n_cols, B) and y (n_rows,) or (n_rows, B).
    ``order`` maps a rowmap's fmt key to its fixed combine order
    (``kernels.combine.combine_order``) and a fused seg step's
    ``{key}_r0`` to its ``FusedRows``: :func:`combine_orders` of the
    program."""
    run = _run_ell_step if step["kind"] == "ell" else _run_seg_step
    return run(step, fmt, x, y, n_rows, backend, tiles_per_step, order)


def step_reads(step: dict, backend: str) -> list[str]:
    """Format keys one spec step reads on ``backend``, as
    :func:`run_spec_step` dispatches it (``SpmvPlan.cost_analysis``
    counts their bytes)."""
    key = step["key"]
    keys = [f"{key}_vals"]
    if step["cols"]["mode"] == "array":
        keys.append(step["cols"]["key"])
    if step["kind"] == "ell":
        if step["combine"]["mode"] == "rowmap":
            keys.append(step["combine"]["key"])
        return keys
    kind = step["reduce"]
    if kind == "gmem_atom" and backend != "cuda":
        return keys + [f"{key}_rows"]      # one index_add_ over the rows
    keys.append(f"{key}_local" if kind == "onehot_mxu" else f"{key}_end")
    # the fused cuda kernels add at r0; everything else scatters by rowmap
    fused = backend == "cuda" and step.get("fused")
    keys.append(f"{key}_r0" if fused else f"{key}_rowmap")
    return keys


def spec_kernels(spec: dict, batched: bool = False) -> list[str]:
    """The kernel IDs (``kernels.ops.launch_counts``' keys) that a kernel
    spec's steps launch on the cuda backend, for an x of (n_cols,) or,
    with ``batched``, (n_cols, B); as :func:`run_spec_step` dispatches
    them."""
    ids = set()
    for st in spec["steps"]:
        fused = bool(st.get("fused"))
        if st["kind"] == "ell":
            comb = st["combine"]
            if fused and comb["mode"] == "affine":
                ids.add("K9" if batched else "K5")
            elif comb["mode"] == "affine" and comb.get("direct"):
                ids.add("K8" if batched else "K2")
            else:
                ids.add("K7" if batched else "K1")
            if comb["mode"] == "rowmap":
                ids.add("rowmap_combine")
        elif fused:
            ids.add("K11" if batched else "K6")
        else:
            onehot = st["reduce"] == "onehot_mxu"
            ids.add(("K10b" if onehot else "K10a") if batched
                    else ("K4" if onehot else "K3"))
            ids.add("rowmap_combine")
    return sorted(ids)

def build_kernel(spec: dict, backend: str = "cuda") -> Callable:
    """Stage 2: interpret a kernel spec into the runnable
    ``fn(fmt, x, order)``.

    ``fn`` takes an x on the format's device, ``(n_cols,)`` or
    ``(n_cols, B)``, and returns a fresh fp32 ``(n_rows,)`` or
    ``(n_rows, B)`` tensor; the steps accumulate into it in place.
    ``order`` is :func:`combine_orders` of the program: the fixed order
    of its combines (:func:`run_spec_step`)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (cuda | torch)")
    n_rows = spec["n_rows"]
    steps = spec["steps"]
    tiles_per_step = int(spec.get("tiles_per_step", 1))

    def run(fmt, x, order):
        if x.ndim not in (1, 2):
            raise ValueError(f"x must be (n_cols,) or (n_cols, B), got "
                             f"shape {tuple(x.shape)}")
        y = torch.zeros((n_rows,) + tuple(x.shape[1:]), dtype=torch.float32,
                        device=x.device)
        for step in steps:
            y = run_spec_step(step, fmt, x, y, n_rows, backend,
                              tiles_per_step, order)
        return y

    return run


def build_program(meta: MetadataSet, backend: str = "cuda",
                  do_compress: bool = True, storage_dtype: str = None,
                  tiles_per_step: int = None,
                  fuse_combine: bool = True) -> SpmvProgram:
    """Generate the SpMV program for a designed MetadataSet.

    The format tensors go to the backend's device (``resolve_device``).
    Only the cuda backend implements the in-kernel combine, so torch
    programs are planned unfused — their reports and cost features then
    describe the combine they actually execute."""
    device = resolve_device(backend)
    fmt, spec = plan_format(meta, do_compress=do_compress,
                            storage_dtype=storage_dtype,
                            tiles_per_step=tiles_per_step,
                            fuse_combine=(fuse_combine
                                          and backend == "cuda"),
                            device=device)
    descriptor = {"backend": backend,
                  "blocks": [s["report"] for s in spec["steps"]],
                  "padded_nnz": spec["padded_nnz"],
                  "history": meta.history}
    return SpmvProgram(n_rows=meta.n_rows, n_cols=meta.n_cols, nnz=meta.nnz,
                       fmt=fmt, fn=build_kernel(spec, backend=backend),
                       descriptor=descriptor, spec=spec, backend=backend)


def build_spmv(meta: MetadataSet, backend: str = "cuda",
               do_compress: bool = True) -> SpmvProgram:
    """Deprecated alias of :func:`build_program` (old four-entrypoint API).

    Prefer ``repro_torch.compile(matrix, target)`` for the full matrix-in
    / plan-out path, or :func:`build_program` when you already hold a
    designed ``MetadataSet``. The reference's ``interpret`` and ``jit``
    (Pallas and XLA switches) have no counterpart.
    """
    warn_once("build_spmv",
              "repro_torch.core.build_spmv is deprecated; use "
              "repro_torch.compile(matrix, target) or "
              "repro_torch.core.build_program(meta)")
    return build_program(meta, backend=backend, do_compress=do_compress)
