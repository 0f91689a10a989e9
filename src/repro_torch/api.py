"""The compile API on PyTorch: ``repro_torch.compile(matrix, target)``.

Port of the dense (single-device) path of ``repro.api``:

* :class:`Target` — where the plan runs: backend ``"cuda"`` (default, the
  hand-written Hopper kernels; raises without a GPU) or ``"torch"`` (the
  plain PyTorch versions on the CPU), decode batch size, dtype. The field
  names are the reference's, so plan headers stay comparable; ``mesh``
  must be None here (sharded plans are a later slice).
* :func:`compile` — matrix + Target (+ search budget) in, :class:`SpmvPlan`
  out. ``budget`` is a ``SearchConfig`` (or seconds); ``graph=`` skips the
  search and designs with a fixed Operator Graph; ``store=`` loads a prior
  plan from a :class:`PlanStore` instead of recompiling.
* :class:`SpmvPlan` — the program artifact: format tensors on the device
  plus the winning Operator Graph, kernel spec and Target. It calls on a
  1-D x (SpMV) or an (n_cols, B) x (SpMM). Its npz layout is the
  reference's (header, sha256 checksum, bf16 stored as uint16 under
  ``bf16!`` keys, ``format_version``), so :func:`load_plan` reads a plan
  saved by either package, mapping the reference's backends
  ``pallas -> cuda`` and ``jax -> torch``.
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
                                             resolve_device)
from repro_torch.core.matrices import SparseMatrix
from repro_torch.core.search import (ProgramCache, SearchConfig, SearchResult,
                                     _graph_from_jsonable, _graph_to_jsonable,
                                     run_search)

__all__ = ["Target", "SpmvPlan", "PlanStore", "PlanWatch",
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
    outputs stay fp32. ``interpret``, ``axis_name``, ``partition`` and
    ``balance`` are kept for header parity with the reference; sharded
    targets (``mesh``) are a later slice. ``batch_size`` is the number of
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
            raise NotImplementedError(
                "sharded targets (mesh) are not ported yet; see ROADMAP "
                "queue 1, item 6")

    def spec_dict(self) -> dict:
        """JSON-able identity (the reference's field set)."""
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self) if f.name != "mesh"}
        d["mesh"] = None
        return d

    def key(self) -> str:
        blob = json.dumps(self.spec_dict(), sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:8]


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
        return fn(self.fmt, x.contiguous())

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
    def load(path, backend: Optional[str] = None) -> "SpmvPlan":
        return load_plan(path, backend=backend)


def load_plan(path, backend: Optional[str] = None) -> SpmvPlan:
    """Load a dense plan saved by this package or by the reference.

    The reference's backends map ``pallas -> cuda`` and ``jax -> torch``;
    ``backend`` overrides the saved one (``"torch"`` runs a GPU plan's
    format on the CPU). The format tensors come back bit-identical, bf16
    included, on the backend's device."""
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
        if header["kind"] != "dense":
            raise NotImplementedError(
                f"plan {path} is {header['kind']!r}; only dense plans are "
                "ported yet")
        kw = {k: v for k, v in header["target"].items() if k != "mesh"}
        kw["backend"] = backend or _REFERENCE_BACKENDS.get(kw["backend"],
                                                           kw["backend"])
        target = Target(**kw)
        fc = header.get("failure_counts")
        return SpmvPlan(
            fmt=_npz_restore("fmt", z, resolve_device(target.backend)),
            spec_json=json.dumps(header["spec"]),
            graph_json=(None if header["graph"] is None
                        else json.dumps(header["graph"])),
            target=target,
            search_gflops=header.get("search_gflops"),
            failure_counts=(None if fc is None
                            else tuple((k, int(v)) for k, v in fc)),
            plan_version=int(header.get("plan_version", 0)))


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
            store: Optional["PlanStore"] = None) -> SpmvPlan:
    """Matrix in, machine-designed program artifact out (paper §III).

    * ``target`` — where the plan runs (default ``Target()``: the CUDA
      kernels on the current GPU; raises when there is none).
    * ``budget`` — search budget: a ``SearchConfig``, a number of seconds,
      or None for the default budget.
    * ``graph`` — skip the search and design with this Operator Graph.
    * ``strategy`` — the search policy: a ``SearchStrategy`` instance or
      class, or a registered name ("anneal" | "grid" | "cost_model").
    * ``warm_start`` — ``OperatorGraph`` objects timed before the walk.
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
    if store is not None:
        hit = store.get(matrix, target, budget, graph, strategy)
        if hit is not None:
            return hit
        if warm_start is None and graph is None:
            # statistics-keyed warm start from the nearest stored plan
            suggested = store.suggest(matrix)
            warm_start = (suggested,) if suggested is not None else None
    if target.backend == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    if graph is not None:
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

    def __init__(self, store: "PlanStore", key: str):
        self.store = store
        self.key = key
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
            plan = load_plan(self.path)
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
        elif dataclasses.is_dataclass(budget):   # SearchConfig
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
            plan = load_plan(path)
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
        """Integrity sweep: load every ``*.plan.npz`` on the CPU and
        return ``{"ok": [keys], "corrupt": [(key, reason)]}``. Nothing is
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
                                        strategy))

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
