"""The compile API on PyTorch: ``repro_torch.compile(matrix, target)``.

Port of ``repro.api``:

* :class:`Target` — where the plan runs: backend ``"cuda"`` (default, the
  hand-written Hopper kernels; raises without a GPU) or ``"torch"`` (the
  plain PyTorch versions on the CPU), an optional device mesh
  (:class:`repro_torch.dist.DataMesh`, sharded execution) with its
  partition mode and balance, decode batch size, dtype. The field names
  are the reference's, so plan headers and store keys stay comparable.
* :func:`compile` — matrix + Target (+ search budget) in, :class:`SpmvPlan`
  (or :class:`ShardedSpmvPlan` for a mesh) out. ``budget`` is a
  ``SearchConfig`` (or seconds); ``graph=`` skips the search and designs
  with a fixed Operator Graph; ``store=`` loads a prior plan from a
  :class:`PlanStore` instead of recompiling.
* :class:`SpmvPlan` / :class:`ShardedSpmvPlan` — the program artifact:
  format tensors on the device (per-family stacks, one slice a shard, for
  a sharded plan) plus the kernel spec, the winning Operator Graph and the
  Target. Both call on a 1-D x (SpMV) or an (n_cols, B) x (SpMM). The npz
  layout is the reference's (header, sha256 checksum, bf16 stored as
  uint16 under ``bf16!`` keys, ``format_version``), so :func:`load_plan`
  reads a plan saved by either package, mapping the reference's backends
  ``pallas -> cuda`` and ``jax -> torch``; a sharded plan gets its mesh
  back from the caller.
* :class:`PlanStore` — a directory of saved plans keyed by (matrix
  fingerprint, budget, Target, strategy), with integrity sweeps
  (``verify`` / ``repair``), statistics-keyed warm starts (``suggest``)
  and :class:`PlanWatch`, the serving plane's hot-swap hook.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
import os
import tempfile
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import OperatorGraph, run_graph
from repro_torch.core.kernel_builder import (build_kernel, build_program,
                                             combine_orders, resolve_device,
                                             step_reads)
from repro_torch.core.matrices import SparseMatrix
from repro_torch.core.search import (ProgramCache, SearchConfig, SearchResult,
                                     _graph_from_jsonable, _graph_to_jsonable,
                                     run_search)

__all__ = ["Target", "SpmvPlan", "ShardedSpmvPlan", "PlanStore", "PlanWatch",
           "PlanIntegrityError", "compile", "load_plan"]

# Version 2 adds bf16 storage (arrays saved as uint16 views under
# "bf16!"-marked keys). Plans without bf16 arrays are written as version 1.
PLAN_FORMAT_VERSION = 2

# backends of plans saved by the reference package
_REFERENCE_BACKENDS = {"pallas": "cuda", "jax": "torch"}


class PlanIntegrityError(ValueError):
    """A saved plan's content checksum does not match its arrays."""


def _content_checksum(header: dict, arrays: dict) -> str:
    """sha256 over the header (checksum field excluded) and every array's
    (key, dtype, shape, bytes), in sorted key order."""
    h = hashlib.sha256()
    h.update(json.dumps({k: v for k, v in header.items()
                         if k != "checksum"}, sort_keys=True).encode())
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _atomic_savez(path, header: dict, arrays: dict) -> None:
    """Crash-safe plan write: checksum the content, write to a tempfile in
    the destination directory, fsync, then ``os.replace``. ``np.savez``
    gets an open file because the path form appends ".npz"."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = dict(header)
    header["checksum"] = _content_checksum(header, arrays)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __plan__=np.str_(json.dumps(header)), **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _atomic_write_text(path, text: str) -> None:
    path = Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# --------------------------------- Target ----------------------------------

@dataclasses.dataclass(frozen=True)
class Target:
    """Where a compiled plan runs.

    ``backend="cuda"`` runs the hand-written CUDA kernels on the current
    GPU and raises when there is none; ``"torch"`` runs their plain
    PyTorch versions on the CPU. ``dtype`` is the activation AND preferred
    storage dtype: ``"bfloat16"`` feeds x as bf16 and lets the search
    choose bf16-stored vals (+ int16 cols where n_cols fits) per matrix;
    outputs stay fp32. A non-None ``mesh`` (:func:`repro_torch.dist.
    make_data_mesh`) compiles a sharded plan over ``axis_name`` with the
    given ``partition`` mode ("row" | "col") and boundary ``balance``
    ("nnz" | "rows"); its devices must suit the backend (CUDA devices for
    ``cuda``, the CPU for ``torch``). ``interpret`` is kept for header
    parity with the reference. ``batch_size`` is the number of
    right-hand sides the plan is tuned for: B > 1 makes the search check
    and time candidates on (n_cols, B) inputs through the SpMM kernels,
    and it is the top bucket of the serving plane's batches
    (``repro_torch.serve.decode_buckets``).
    """

    backend: str = "cuda"
    interpret: bool = True
    mesh: Optional[object] = None
    axis_name: str = "data"
    partition: str = "row"
    balance: str = "nnz"
    batch_size: int = 1
    dtype: str = "float32"

    def __post_init__(self):
        if self.backend not in ("cuda", "torch"):
            raise ValueError(f"unknown backend {self.backend!r} "
                             "(cuda | torch)")
        if self.partition not in ("row", "col"):
            raise ValueError(f"unknown partition {self.partition!r}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported dtype {self.dtype!r} "
                             "(float32 | bfloat16)")
        if self.mesh is not None:
            from repro_torch.dist.spmv import check_placement
            check_placement(self.mesh, self.backend)

    def spec_dict(self) -> dict:
        """JSON-able identity (the reference's field set; the mesh reduced
        to its axis shape)."""
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self) if f.name != "mesh"}
        d["mesh"] = (None if self.mesh is None
                     else sorted((str(k), int(v))
                                 for k, v in dict(self.mesh.shape).items()))
        return d

    def key(self) -> str:
        blob = json.dumps(self.spec_dict(), sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:8]


def _target_from_dict(d: dict, mesh=None,
                      backend: Optional[str] = None) -> Target:
    """A Target from its ``spec_dict()``, written by either package: the
    reference's backends map ``pallas -> cuda`` and ``jax -> torch``;
    ``backend`` overrides the saved one. A mesh is never saved: the caller
    attaches one."""
    kw = {k: v for k, v in d.items() if k != "mesh"}
    kw["backend"] = backend or _REFERENCE_BACKENDS.get(kw["backend"],
                                                       kw["backend"])
    return Target(mesh=mesh, **kw)


def _x_dtype(target: Target) -> torch.dtype:
    return torch.bfloat16 if target.dtype == "bfloat16" else torch.float32


# npz cannot hold bfloat16: bf16 arrays travel as uint16 views under a
# marked key and are view-cast back on load — a bit-identical round trip.
_BF16_PREFIX = "bf16!"


def _npz_arrays(prefix: str, tensors: dict) -> dict:
    out = {}
    for k, t in tensors.items():
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            out[f"{prefix}::{_BF16_PREFIX}{k}"] = (
                t.view(torch.int16).numpy().view(np.uint16))
        else:
            out[f"{prefix}::{k}"] = t.numpy()
    return out


def _format_version(npz_arrays: dict) -> int:
    """1 for plans any reader can restore; 2 when bf16 keys are present."""
    tag = f"::{_BF16_PREFIX}"
    return 2 if any(tag in k for k in npz_arrays) else 1


def _npz_restore(prefix: str, z, device) -> dict:
    tag = f"{prefix}::"
    out = {}
    for k in z.files:
        if not k.startswith(tag):
            continue
        name = k[len(tag):]
        a = np.array(z[k])
        if name.startswith(_BF16_PREFIX):
            name = name[len(_BF16_PREFIX):]
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out[name] = t.to(device)
    return out


# ------------------------------ dense plans ---------------------------------

@functools.lru_cache(maxsize=256)
def _dense_kernel(spec_json: str, backend: str):
    return build_kernel(json.loads(spec_json), backend=backend)


@dataclasses.dataclass(eq=False)
class SpmvPlan:
    """A compiled single-device SpMV/SpMM program artifact: the format
    tensors (``fmt``, on the backend's device) plus the static kernel
    spec, the winning Operator Graph and the Target."""

    supports_batch = True

    fmt: dict                       # name -> torch.Tensor
    spec_json: str                  # kernel spec (kernel_builder schema)
    graph_json: Optional[str]       # winning OperatorGraph, if any
    target: Target
    search_gflops: Optional[float] = None
    # failure-reason counts of the search that produced this plan, as a
    # sorted tuple of (taxonomy bucket, count) pairs; serialized
    failure_counts: Optional[tuple] = None
    plan_version: int = 0
    # the full SearchResult when this plan came from a search in this
    # process (not serialized)
    search_result: Optional[SearchResult] = dataclasses.field(
        default=None, compare=False, repr=False)
    # derived, never serialized: kernel_builder.combine_orders, the fixed
    # order of the plan's combines, built whenever a plan is made
    # (compile, load, update, dataclasses.replace)
    combine_state: Optional[dict] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        self.combine_state = combine_orders(json.loads(self.spec_json),
                                            self.fmt, self.target.backend)

    # -- geometry ----------------------------------------------------------
    @functools.cached_property
    def spec(self) -> dict:
        return json.loads(self.spec_json)

    @property
    def n_rows(self) -> int:
        return self.spec["n_rows"]

    @property
    def n_cols(self) -> int:
        return self.spec["n_cols"]

    @property
    def nnz(self) -> int:
        return self.spec["nnz"]

    @property
    def graph(self) -> Optional[OperatorGraph]:
        if self.graph_json is None:
            return None
        return _graph_from_jsonable(json.loads(self.graph_json))

    @property
    def stored_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.fmt.values())

    @property
    def device(self) -> torch.device:
        return next(iter(self.fmt.values())).device

    # -- execution ---------------------------------------------------------
    def __call__(self, x) -> torch.Tensor:
        """x: (n_cols,) -> fp32 (n_rows,), or (n_cols, B) -> (n_rows, B),
        on the plan's device (x is copied there first)."""
        x = torch.as_tensor(x).to(self.device, _x_dtype(self.target))
        fn = _dense_kernel(self.spec_json, self.target.backend)
        return fn(self.fmt, x.contiguous(), self.combine_state)

    # -- dynamic sparsity --------------------------------------------------
    def update(self, delta) -> "SpmvPlan":
        """Patch-in-place dynamic-sparsity step (``repro_torch.dyn``).

        Applies a :class:`repro_torch.dyn.PatternDelta` to the packed
        format tensors — new tensors of the same shapes, dtypes and
        device, the same kernel spec, no Operator Graph replay, no kernel
        rebuild — and returns the patched plan with ``plan_version + 1``.
        This plan's tensors are left as they were. Raises
        ``repro_torch.dyn.CapacityError`` when the delta does not fit the
        format in place (escalate to
        ``repro_torch.dyn.DynamicSparsityManager`` or a fresh
        :func:`compile`). For streams of deltas, hold a
        ``repro_torch.dyn.PlanPatcher`` instead: it keeps the capacity
        index across calls, making each update O(delta)."""
        from repro_torch.dyn.update import update_plan
        return update_plan(self, delta)

    # -- reporting ---------------------------------------------------------
    def describe(self) -> str:
        spec = self.spec
        g = self.graph
        lines = [f"SpmvPlan {spec['n_rows']}x{spec['n_cols']} "
                 f"nnz={spec['nnz']} padded={spec['padded_nnz']} "
                 f"stored={self.stored_bytes}B",
                 f"  target: backend={self.target.backend} "
                 f"batch_size={self.target.batch_size} "
                 f"dtype={self.target.dtype}",
                 f"  graph: {g.label() if g else '(heuristic)'}"]
        if self.search_gflops is not None:
            lines.append(f"  searched: {self.search_gflops:.3f} GFLOPS")
        if self.failure_counts:
            buckets = ", ".join(f"{k}={v}" for k, v in self.failure_counts)
            lines.append(f"  search failures: {buckets}")
        for s in spec["steps"]:
            lines.append(f"  step {s['key']}: {s['report']}")
        from repro_torch.dyn.capacity import capacity_lines
        lines.extend(capacity_lines(self))
        return "\n".join(lines)

    def cost_analysis(self, batch_size: Optional[int] = None) -> dict:
        """Bytes and flops of one call with B = ``batch_size`` right-hand
        sides (default ``target.batch_size``), counted from the kernel
        spec. This is not XLA's analysis of a compiled program, as in the
        reference, so the numbers are not expected to equal its.

        * ``"flops"``: 2 x stored slots x B, padding included (what the
          kernels compute);
        * ``"bytes accessed"``: every format tensor that the spec's steps
          read on this plan's backend, each once, plus x (n_cols x B of
          the activation dtype) and y (n_rows x B float32);
        * ``"capacity"``: :func:`repro_torch.dyn.capacity.capacity_report`.
        """
        from repro_torch.dyn.capacity import capacity_report
        b = max(int(batch_size if batch_size is not None
                    else self.target.batch_size), 1)
        keys, slots = set(), 0
        for step in self.spec["steps"]:
            keys.update(step_reads(step, self.target.backend))
            slots += self.fmt[f"{step['key']}_vals"].numel()
        fmt_bytes = sum(self.fmt[k].numel() * self.fmt[k].element_size()
                        for k in keys)
        x_item = _x_dtype(self.target).itemsize
        return {"flops": 2 * slots * b,
                "bytes accessed": (fmt_bytes + self.n_cols * b * x_item
                                   + self.n_rows * b * 4),
                "capacity": capacity_report(self)}

    # -- serialization -----------------------------------------------------
    def save(self, path) -> None:
        arrays = _npz_arrays("fmt", self.fmt)
        header = {"format_version": _format_version(arrays), "kind": "dense",
                  "spec": self.spec, "graph": (None if self.graph_json is None
                                               else json.loads(self.graph_json)),
                  "target": self.target.spec_dict(),
                  "search_gflops": self.search_gflops,
                  "plan_version": int(self.plan_version),
                  "failure_counts": (None if self.failure_counts is None
                                     else [list(p)
                                           for p in self.failure_counts])}
        _atomic_savez(path, header, arrays)

    @staticmethod
    def load(path, backend: Optional[str] = None, mesh=None):
        """Load any saved plan; sharded plans need ``mesh`` re-attached."""
        return load_plan(path, backend=backend, mesh=mesh)


# ------------------------------ sharded plans -------------------------------

@functools.lru_cache(maxsize=64)
def _sharded_fn(steps_json: str, mode: str, n_out: int, mesh, axis_name: str,
                backend: str):
    from repro_torch.dist.spmv import make_stacked_fn
    return make_stacked_fn(json.loads(steps_json), mode, n_out, mesh,
                           axis_name, backend=backend)


@dataclasses.dataclass(eq=False)
class ShardedSpmvPlan:
    """A compiled sharded plan: per-family stacked format tensors (leading
    dim = shard) plus the static shard geometry.

    Shard i runs on ``target.mesh.devices[i]`` with slice i of every
    stack; the stacks lie on the device all shards share (or on the host,
    each shard holding a copy of its slice, when the shards sit on several
    devices). A plan loaded without a mesh is detached: it refuses to run
    until one is attached (``load_plan(path, mesh=...)``).
    """

    supports_batch = True

    stacks: dict                    # name -> (n_shards, ...) tensors
    steps_json: str                 # synthetic per-family kernel spec
    mode: str                       # 'row' | 'col'
    n_rows: int
    n_cols: int
    nnz: int
    band_rows: int                  # row mode: padded per-shard band size
    bounds: tuple                   # ((start, stop), ...) per shard
    target: Target
    replicated_bytes: int = 0       # every shard's format on every device
    # aggregated per-shard failure taxonomy (sorted (bucket, count) pairs);
    # a "fallback" entry counts shards substituted with the baseline
    failure_counts: Optional[tuple] = None
    search_result: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False)
    # the stacks placed on the mesh (per shard: slice + combine order)
    operands: Optional[list] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def n_shards(self) -> int:
        return len(self.bounds)

    @property
    def per_device_format_bytes(self) -> int:
        n = max(self.n_shards, 1)
        return sum(v.numel() * v.element_size() // n
                   for v in self.stacks.values())

    @property
    def replicated_format_bytes(self) -> int:
        return self.replicated_bytes

    @functools.cached_property
    def steps(self) -> list:
        return json.loads(self.steps_json)

    @classmethod
    def from_program(cls, sprog, target: Target,
                     search_result=None) -> "ShardedSpmvPlan":
        """Adopt a ``dist.spmv.ShardedSpmvProgram``'s stacked operands."""
        failure_counts = None
        if search_result is not None and getattr(search_result,
                                                 "failure_counts", None):
            failure_counts = tuple(
                sorted(search_result.failure_counts.items()))
        return cls(stacks=dict(sprog.stacks),
                   steps_json=json.dumps(sprog.steps),
                   mode=sprog.mode, n_rows=sprog.n_rows,
                   n_cols=sprog.n_cols, nnz=sprog.nnz,
                   band_rows=sprog.band_rows,
                   bounds=tuple((s.start, s.stop) for s in sprog.shards),
                   target=target,
                   replicated_bytes=sprog.replicated_format_bytes,
                   failure_counts=failure_counts,
                   search_result=search_result,
                   operands=(sprog.operands if sprog.mesh == target.mesh
                             else None))

    def _n_out(self) -> int:
        return self.band_rows if self.mode == "row" else self.n_rows

    def _mesh(self):
        if self.target.mesh is None:
            raise ValueError("sharded plan has no mesh attached; load with "
                             "load_plan(path, mesh=...) or rebuild the "
                             "Target with a mesh")
        return self.target.mesh

    def __call__(self, x) -> torch.Tensor:
        """x: (n_cols,) -> fp32 (n_rows,), or (n_cols, B) -> (n_rows, B),
        on ``mesh.devices[0]``."""
        from repro_torch.dist.spmv import place_operands, stacked_call
        mesh = self._mesh()
        if self.operands is None:
            self.operands = place_operands(self.stacks, self.steps, mesh,
                                           self._n_out())
        fn = _sharded_fn(self.steps_json, self.mode, self._n_out(), mesh,
                         self.target.axis_name, self.target.backend)
        return stacked_call(fn, self.operands, x, self.mode, self.n_cols,
                            [stop - start for start, stop in self.bounds],
                            mesh.devices[0], dtype=_x_dtype(self.target))

    def update(self, delta):
        """Sharded plans do not support patch-in-place updates: a delta
        can move nnz across shard bounds, which changes the static shard
        geometry. Re-compile for the mutated matrix instead."""
        raise NotImplementedError(
            "ShardedSpmvPlan.update is not supported (a PatternDelta can "
            "cross shard bounds); re-run repro_torch.compile on the mutated "
            "matrix")

    def describe(self) -> str:
        lines = [f"ShardedSpmvPlan {self.n_rows}x{self.n_cols} "
                 f"nnz={self.nnz} mode={self.mode} "
                 f"shards={self.n_shards}",
                 f"  target: backend={self.target.backend} "
                 f"interpret={self.target.interpret} "
                 f"axis={self.target.axis_name}",
                 f"  format bytes/device: {self.per_device_format_bytes} "
                 f"(closure baseline {self.replicated_bytes})"]
        if self.failure_counts:
            buckets = ", ".join(f"{k}={v}" for k, v in self.failure_counts)
            lines.append(f"  shard-search failures: {buckets}")
        for s in self.steps:
            lines.append(f"  family {s['key']}: {s['report']}")
        return "\n".join(lines)

    def cost_analysis(self, batch_size: Optional[int] = None) -> dict:
        """Bytes and flops of one call with B = ``batch_size`` right-hand
        sides (default ``target.batch_size``), counted from the steps as
        :meth:`SpmvPlan.cost_analysis` counts them, over all shards:

        * ``"flops"``: 2 x stacked slots x B, padding included;
        * ``"bytes accessed"``: every stack the steps read on this plan's
          backend, each once, plus x as the shards read it (all of it in
          row mode, a slice of the padded x in col mode) and the partial
          y they write (a band in row mode, all rows in col mode).
        """
        b = max(int(batch_size if batch_size is not None
                    else self.target.batch_size), 1)
        keys, slots = set(), 0
        for step in self.steps:
            keys.update(step_reads(step, self.target.backend))
            slots += self.stacks[f"{step['key']}_vals"].numel()
        fmt_bytes = sum(self.stacks[k].numel() * self.stacks[k].element_size()
                        for k in keys)
        n = max(self.n_shards, 1)
        x_rows = (n * self.n_cols if self.mode == "row"
                  else -(-self.n_cols // n) * n)
        x_item = _x_dtype(self.target).itemsize
        return {"flops": 2 * slots * b,
                "bytes accessed": (fmt_bytes + x_rows * b * x_item
                                   + n * self._n_out() * b * 4)}

    def save(self, path) -> None:
        arrays = _npz_arrays("stack", self.stacks)
        header = {"format_version": _format_version(arrays),
                  "kind": "sharded",
                  "steps": self.steps, "mode": self.mode,
                  "n_rows": self.n_rows, "n_cols": self.n_cols,
                  "nnz": self.nnz, "band_rows": self.band_rows,
                  "bounds": [list(b) for b in self.bounds],
                  "replicated_bytes": self.replicated_bytes,
                  "failure_counts": (None if self.failure_counts is None
                                     else [[p[0], int(p[1])]
                                           for p in self.failure_counts]),
                  "target": self.target.spec_dict()}
        _atomic_savez(path, header, arrays)

    load = staticmethod(SpmvPlan.load)


def load_plan(path, backend: Optional[str] = None, mesh=None):
    """Load a plan saved by this package or by the reference.

    The reference's backends map ``pallas -> cuda`` and ``jax -> torch``;
    ``backend`` overrides the saved one (``"torch"`` runs a GPU plan's
    format on the CPU). The format tensors come back bit-identical, bf16
    included. A dense plan's land on the backend's device. A sharded plan
    needs a live ``mesh`` (meshes name devices and are not saved): with one
    whose shard count matches, the stacks land on it; without one the plan
    is detached (its stacks stay on the CPU) and refuses to run."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(str(z["__plan__"]))
        if header.get("format_version", 0) > PLAN_FORMAT_VERSION:
            raise ValueError(f"plan {path} has format_version "
                             f"{header['format_version']} > supported "
                             f"{PLAN_FORMAT_VERSION}")
        want = header.get("checksum")
        if want is not None:
            arrays = {k: z[k] for k in z.files if k != "__plan__"}
            got = _content_checksum(header, arrays)
            if got != want:
                raise PlanIntegrityError(
                    f"plan {path} failed its content checksum "
                    f"(stored {want[:12]}…, computed {got[:12]}…): the "
                    "file is corrupt or was modified after save")
        fc = header.get("failure_counts")
        fc = None if fc is None else tuple((k, int(v)) for k, v in fc)
        if header["kind"] == "sharded":
            return _load_sharded(path, header, z, backend, mesh, fc)
        if header["kind"] != "dense":
            raise ValueError(f"plan {path} has unknown kind "
                             f"{header['kind']!r}")
        target = _target_from_dict(header["target"], backend=backend)
        return SpmvPlan(
            fmt=_npz_restore("fmt", z, resolve_device(target.backend)),
            spec_json=json.dumps(header["spec"]),
            graph_json=(None if header["graph"] is None
                        else json.dumps(header["graph"])),
            target=target,
            search_gflops=header.get("search_gflops"),
            failure_counts=fc,
            plan_version=int(header.get("plan_version", 0)))


def _load_sharded(path, header: dict, z, backend: Optional[str], mesh,
                  failure_counts) -> ShardedSpmvPlan:
    target = _target_from_dict(header["target"], mesh=mesh, backend=backend)
    stacks = _npz_restore("stack", z, "cpu")
    if mesh is not None:
        from repro_torch.dist.spmv import place_stacks
        n_saved = len(header["bounds"])
        n_mesh = dict(mesh.shape).get(target.axis_name)
        if n_mesh != n_saved:
            raise ValueError(
                f"plan {path} was compiled for {n_saved} shards but the "
                f"attached mesh has {n_mesh} devices on axis "
                f"{target.axis_name!r}; re-compile for this mesh or "
                "attach a matching one")
        stacks = place_stacks(stacks, mesh)
    return ShardedSpmvPlan(
        stacks=stacks, steps_json=json.dumps(header["steps"]),
        mode=header["mode"], n_rows=header["n_rows"],
        n_cols=header["n_cols"], nnz=header["nnz"],
        band_rows=header["band_rows"],
        bounds=tuple(tuple(b) for b in header["bounds"]),
        target=target, replicated_bytes=header["replicated_bytes"],
        failure_counts=failure_counts)


# -------------------------------- compile -----------------------------------

def _as_search_config(budget, target: Target) -> SearchConfig:
    if budget is None:
        cfg = SearchConfig()
    elif isinstance(budget, SearchConfig):
        cfg = budget
    elif isinstance(budget, (int, float)):
        cfg = SearchConfig(max_seconds=float(budget))
    else:
        raise TypeError(f"budget must be a SearchConfig or seconds, got "
                        f"{type(budget).__name__}")
    bsz = target.batch_size if target.batch_size > 1 else cfg.batch_size
    cfg = dataclasses.replace(cfg, backend=target.backend,
                              batch_size=max(bsz, 1))
    # widen the SET_RESOURCES knob choices from the Target, but only when
    # the budget left them at None ("auto"): cuda kernels have the fused
    # path, so the search tunes tiles_per_step; dtype="bfloat16" means
    # both precisions are searched and the winner is picked per matrix
    if target.backend == "cuda" and cfg.tiles_per_step_choices is None:
        cfg = dataclasses.replace(cfg, tiles_per_step_choices=(1, 4, 8))
    if target.dtype == "bfloat16" and cfg.dtype_choices is None:
        cfg = dataclasses.replace(cfg,
                                  dtype_choices=("float32", "bfloat16"))
    return cfg


def _plan_from_program(prog, graph: Optional[OperatorGraph],
                       target: Target, search_result=None) -> SpmvPlan:
    graph_json = (None if graph is None
                  else json.dumps(_graph_to_jsonable(graph)))
    failure_counts = None
    if search_result is not None and search_result.failure_counts:
        failure_counts = tuple(sorted(search_result.failure_counts.items()))
    return SpmvPlan(fmt=dict(prog.fmt), spec_json=json.dumps(prog.spec),
                    graph_json=graph_json, target=target,
                    search_gflops=(search_result.gflops
                                   if search_result else None),
                    failure_counts=failure_counts,
                    search_result=search_result)


def compile(matrix: SparseMatrix, target: Optional[Target] = None,
            budget=None, *, graph: Optional[OperatorGraph] = None,
            strategy=None, warm_start=None, deadline_s: Optional[float] = None,
            cache: Optional[ProgramCache] = None,
            store: Optional["PlanStore"] = None):
    """Matrix in, machine-designed program artifact out (paper §III).

    * ``target`` — where the plan runs (default ``Target()``: the CUDA
      kernels on the current GPU; raises when there is none). With
      ``target.mesh`` the result is a :class:`ShardedSpmvPlan`.
    * ``budget`` — search budget: a ``SearchConfig``, a number of seconds,
      or None for the default budget. With ``target.mesh`` set and
      ``budget=None``, shards take the search-free heuristic design
      (``dist.spmv.default_shard_graph``); a
      ``dist.search.ShardedSearchConfig`` gives full per-shard control
      (the Target still decides placement and backend); seconds or a
      ``SearchConfig`` is every shard's search budget.
    * ``graph`` — skip the search and design with this Operator Graph
      (sharded targets apply it per shard).
    * ``strategy`` — the search policy: a ``SearchStrategy`` instance or
      class, or a registered name ("anneal" | "grid" | "cost_model" |
      "learned" | "portfolio"). Store-aware strategies get
      ``bind_store(store)`` before the search: that is how "learned" and
      "portfolio" find the corpus model saved next to the store and
      "portfolio" its reuse suggestions.
    * ``warm_start`` — ``OperatorGraph`` objects timed before the walk
      (dense targets only).
    * ``deadline_s`` — hard wall-clock budget for the whole search.
    * ``cache`` — a ``ProgramCache`` memoising raw search results.
    * ``store`` — a :class:`PlanStore`; a prior plan for the same
      (matrix, budget, target) is loaded instead of recompiled, and new
      plans are saved. Without an explicit ``warm_start``,
      ``store.suggest(matrix)`` seeds the search. Store hits carry no
      ``search_result``; ``search_gflops`` survives the round trip.

    On a cuda target the kernel libraries are built before the search
    starts, so a failed ``nvcc`` raises here instead of turning every
    candidate into a crash and the plan into a fallback.
    """
    target = target or Target()
    resolve_device(target.backend)
    if strategy is not None:
        # normalize once so store keys see the *bound* strategy: a
        # store-aware strategy ("portfolio", "learned") keys on its model
        # fingerprint, and get/put must agree on it
        from repro_torch.design.strategies import make_strategy
        strategy = make_strategy(strategy)
        if store is not None and hasattr(strategy, "bind_store"):
            strategy.bind_store(store)
    if store is not None:
        hit = store.get(matrix, target, budget, graph, strategy)
        if hit is not None:
            return hit
        if warm_start is None and graph is None and target.mesh is None:
            # statistics-keyed warm start from the nearest stored plan
            # (dense targets only: per-shard warm start is future work)
            suggested = store.suggest(matrix)
            warm_start = (suggested,) if suggested is not None else None
    if target.backend == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    if target.mesh is not None:
        plan = _compile_sharded(matrix, target, budget, graph, strategy,
                                cache)
    elif graph is not None:
        meta = run_graph(matrix, graph)
        # Target.dtype overrides the storage dtype for fixed-graph
        # compiles (searched compiles pick it via SET_RESOURCES)
        prog = build_program(meta, backend=target.backend,
                             storage_dtype=(target.dtype
                                            if target.dtype != "float32"
                                            else None))
        plan = _plan_from_program(prog, graph, target)
    else:
        cfg = _as_search_config(budget, target)
        if deadline_s is not None:
            cfg = dataclasses.replace(
                cfg, max_seconds=min(cfg.max_seconds, float(deadline_s)),
                hard_deadline=True)
        res = run_search(matrix, cfg, cache=cache, strategy=strategy,
                         warm_start=warm_start)
        plan = _plan_from_program(res.best_program, res.best_graph, target,
                                  search_result=res)
    if store is not None:
        store.put(matrix, target, budget, graph, plan, strategy)
    return plan


def _compile_sharded(matrix, target: Target, budget, graph, strategy,
                     cache) -> ShardedSpmvPlan:
    """The mesh branch of :func:`compile`."""
    from repro_torch.dist.search import ShardedSearchConfig, dist_search
    from repro_torch.dist.spmv import default_shard_graph, shard_map_spmv
    search_result = None
    if graph is not None or budget is None:
        sprog = shard_map_spmv(matrix, target.mesh,
                               axis_name=target.axis_name,
                               mode=target.partition, balance=target.balance,
                               graph_for=(default_shard_graph if graph is None
                                          else lambda m: graph),
                               backend=target.backend,
                               storage_dtype=target.dtype)
    else:
        if isinstance(budget, ShardedSearchConfig):
            # full per-shard control (min_nnz_for_search, seeds, ...); the
            # Target still decides placement and backend
            dcfg = dataclasses.replace(
                budget, axis_name=target.axis_name, mode=target.partition,
                balance=target.balance, backend=target.backend,
                interpret=target.interpret)
            if strategy is not None:
                dcfg = dataclasses.replace(dcfg, strategy=strategy)
        else:
            dcfg = ShardedSearchConfig(
                axis_name=target.axis_name, mode=target.partition,
                balance=target.balance,
                search=_as_search_config(budget, target),
                backend=target.backend, interpret=target.interpret,
                strategy=strategy)
        search_result = dist_search(matrix, target.mesh, dcfg, cache=cache)
        sprog = search_result.program
    return ShardedSpmvPlan.from_program(sprog, target,
                                        search_result=search_result)


# -------------------------------- PlanStore ---------------------------------

def _matrix_stats(matrix: SparseMatrix) -> list[float]:
    """Statistics key for nearest-plan lookup: row count and the mean,
    std and coefficient of variation of nnz per row (the axes of the
    §VI-B pruning rules)."""
    lengths = np.bincount(np.asarray(matrix.rows, np.int64),
                          minlength=matrix.n_rows).astype(np.float64)
    mean = float(lengths.mean()) if lengths.size else 0.0
    std = float(lengths.std()) if lengths.size else 0.0
    cv = std / mean if mean > 0 else 0.0
    return [float(matrix.n_rows), mean, std, cv]


def _stats_distance(a, b) -> float:
    """Scale-normalized distance: log-scale for counts, linear for CV."""
    d = 0.0
    d += (np.log10(1.0 + a[0]) - np.log10(1.0 + b[0])) ** 2
    d += (np.log10(1.0 + a[1]) - np.log10(1.0 + b[1])) ** 2
    d += (np.log10(1.0 + a[2]) - np.log10(1.0 + b[2])) ** 2
    d += (a[3] - b[3]) ** 2
    return float(np.sqrt(d))


class PlanWatch:
    """Poll one PlanStore entry for changes (the serving hot-swap hook).

    Created by :meth:`PlanStore.watch`. ``poll()`` stats the entry's file
    and returns a freshly loaded plan iff its (mtime_ns, size) stamp
    changed since the last observation, None otherwise. A half-written or
    corrupt entry is skipped (the old plan keeps serving) and retried on
    the next poll.
    """

    def __init__(self, store: "PlanStore", key: str, mesh=None):
        self.store = store
        self.key = key
        self.mesh = mesh
        self._seen = self._stamp()

    @property
    def path(self) -> Path:
        return self.store._path(self.key)

    def _stamp(self):
        try:
            st = self.path.stat()
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    def poll(self):
        stamp = self._stamp()
        if stamp is None or stamp == self._seen:
            return None
        try:
            plan = load_plan(self.path, mesh=self.mesh)
        except Exception:
            return None   # mid-write or corrupt: retry on the next poll
        self._seen = stamp
        return plan


class PlanStore:
    """A directory of saved plans keyed by (matrix, budget/graph, strategy,
    Target).

    A hit is a load of the full artifact (spec + format tensors),
    bit-identical to the saved plan, with no Designer replay. Each ``put``
    also writes a small ``.stats.json`` sidecar (matrix row statistics,
    corpus features, winning graph) that :meth:`suggest` reads to
    warm-start the search of a statistically similar matrix. The file
    layout is the reference's, so either package reads the other's
    plans.
    """

    def __init__(self, cache_dir):
        self.cache_dir = Path(cache_dir)
        self.hits = 0
        self.misses = 0
        # suggest() sidecar index: path -> ((mtime_ns, size), payload);
        # payload None for a corrupt sidecar. Revalidated only when the
        # directory's mtime moves (sidecars are written atomically).
        self._sidecars: dict[Path, tuple[tuple[int, int], Optional[dict]]] = {}
        self._sidecar_dir_stamp: Optional[int] = None

    @staticmethod
    def key(matrix: SparseMatrix, target: Target, budget=None,
            graph: Optional[OperatorGraph] = None, strategy=None) -> str:
        from repro_torch.design.strategies import make_strategy
        mfp = ProgramCache.matrix_fingerprint(matrix)
        if graph is not None:
            bkey = "g" + hashlib.sha1(json.dumps(
                _graph_to_jsonable(graph)).encode()).hexdigest()[:8]
        elif budget is None:
            bkey = "default"
        elif dataclasses.is_dataclass(budget):   # SearchConfig / sharded cfg
            blob = json.dumps(dataclasses.asdict(budget), sort_keys=True,
                              default=str)
            bkey = hashlib.sha1(blob.encode()).hexdigest()[:8]
        else:
            bkey = f"s{float(budget):g}"
        if graph is None:
            # a grid-searched plan must not serve an anneal-searched
            # request for the same matrix/budget
            bkey += "-" + hashlib.sha1(
                make_strategy(strategy).key().encode()).hexdigest()[:8]
        return f"{mfp}-{bkey}-{target.key()}"

    def _path(self, key: str) -> Path:
        return self.cache_dir / f"{key}.plan.npz"

    def get(self, matrix, target, budget=None, graph=None, strategy=None):
        path = self._path(self.key(matrix, target, budget, graph, strategy))
        if not path.exists():
            self.misses += 1
            return None
        try:
            plan = load_plan(path, mesh=target.mesh)
        except Exception as e:  # truncated/corrupt npz or checksum mismatch
            warnings.warn(f"plan store entry {path} unusable ({e!r}); "
                          "recompiling", RuntimeWarning)
            self.misses += 1
            return None
        self.hits += 1
        return plan

    def put(self, matrix, target, budget, graph, plan,
            strategy=None) -> None:
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        key = self.key(matrix, target, budget, graph, strategy)
        plan.save(self._path(key))
        graph_json = getattr(plan, "graph_json", None)
        if graph_json is not None:
            from repro_torch.corpus.features import matrix_features
            sidecar = {"stats": _matrix_stats(matrix),
                       "features": matrix_features(matrix).tolist(),
                       "graph": json.loads(graph_json),
                       "gflops": getattr(plan, "search_gflops", None)}
            _atomic_write_text(self.cache_dir / f"{key}.stats.json",
                               json.dumps(sidecar))

    def verify(self) -> dict:
        """Integrity sweep: load every ``*.plan.npz`` on the CPU (sharded
        plans detached, with no mesh) and return
        ``{"ok": [keys], "corrupt": [(key, reason)]}``. Nothing is
        modified; :meth:`repair` quarantines the corrupt entries."""
        ok, corrupt = [], []
        if self.cache_dir.is_dir():
            for path in sorted(self.cache_dir.glob("*.plan.npz")):
                key = path.name[:-len(".plan.npz")]
                try:
                    load_plan(path, backend="torch")
                except Exception as e:
                    corrupt.append((key, repr(e)))
                else:
                    ok.append(key)
        return {"ok": ok, "corrupt": corrupt}

    def repair(self) -> list[str]:
        """Move every corrupt entry found by :meth:`verify` (and its
        sidecar) into ``quarantine/``; the next ``get`` for that key
        recompiles. Returns the quarantined keys."""
        quarantined = []
        qdir = self.cache_dir / "quarantine"
        for key, _reason in self.verify()["corrupt"]:
            qdir.mkdir(parents=True, exist_ok=True)
            for suffix in (".plan.npz", ".stats.json"):
                src = self.cache_dir / f"{key}{suffix}"
                if src.exists():
                    os.replace(src, qdir / src.name)
            quarantined.append(key)
        return quarantined

    def watch(self, matrix, target, budget=None, graph=None,
              strategy=None) -> PlanWatch:
        """A :class:`PlanWatch` on this key. It records the entry's stamp
        at creation, so only later puts trigger a reload; the serving
        executor polls it between batches."""
        return PlanWatch(self, self.key(matrix, target, budget, graph,
                                        strategy), mesh=target.mesh)

    def _refresh_sidecars(self) -> None:
        """Revalidate the in-memory sidecar index, O(changed files)."""
        try:
            dir_stamp = self.cache_dir.stat().st_mtime_ns
        except OSError:
            self._sidecars.clear()
            self._sidecar_dir_stamp = None
            return
        if dir_stamp == self._sidecar_dir_stamp:
            return
        seen = set()
        for path in self.cache_dir.glob("*.stats.json"):
            try:
                st = path.stat()
            except OSError:
                continue   # removed between glob and stat
            seen.add(path)
            stamp = (st.st_mtime_ns, st.st_size)
            cached = self._sidecars.get(path)
            if cached is not None and cached[0] == stamp:
                continue
            try:
                payload = json.loads(path.read_text())
                payload["stats"][0]   # shape check: stats must index
                payload["graph"]
            except (OSError, ValueError, KeyError, IndexError, TypeError):
                payload = None        # negative cache: skip until it changes
            self._sidecars[path] = (stamp, payload)
        for path in list(self._sidecars):
            if path not in seen:
                del self._sidecars[path]
        self._sidecar_dir_stamp = dir_stamp

    def suggest(self, matrix: SparseMatrix, max_distance: float = 1.0,
                with_distance: bool = False):
        """Winning graph of the statistically nearest stored plan, or None
        when nothing lies within ``max_distance`` (inclusive). With
        ``with_distance=True`` returns ``(graph_or_None, distance)``."""
        if not self.cache_dir.is_dir():
            return (None, math.inf) if with_distance else None
        self._refresh_sidecars()
        want = _matrix_stats(matrix)
        best_d, best_graph = math.inf, None
        for _stamp, payload in self._sidecars.values():
            if payload is None:
                continue
            try:
                d = _stats_distance(want, payload["stats"])
            except (ValueError, KeyError, IndexError, TypeError):
                continue
            if d < best_d:
                best_d, best_graph = d, payload["graph"]
        if best_graph is None or best_d > max_distance:
            return (None, math.inf) if with_distance else None
        graph = _graph_from_jsonable(best_graph)
        return (graph, best_d) if with_distance else graph
