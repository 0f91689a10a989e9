"""Dry run of every (architecture x input-shape) cell on the reference's
production meshes, allocating nothing (port of ``repro.launch.dryrun``).

For each cell the step a deployment would run (``make_train_step`` over
``adamw_init``'s state, ``prefill`` or ``decode_step`` of
``repro_torch.models``) runs once on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and dtypes, no
storage) at the cell's **global** shapes, and the record of what it would
cost goes to ``<out>/<arch>.<shape>.<mesh>.json`` with the reference's
keys. The meshes are the reference's TPU pod shapes, 16 x 16 chips
(``pod16x16``) and 2 x 16 x 16 (``pod2x16x16``), as descriptions
(``launch.mesh.make_production_mesh``): the dry run needs no device, and
the reference's XLA-flag preamble has no counterpart here.

What each key means here, against the reference's XLA numbers:

* ``lower_s``: the seconds to build the fake state and inputs;
  ``compile_s``: the seconds of the counted pass; ``memory_s``: of the
  memory pass.
* ``flops``, ``bytes_accessed``, ``transcendentals``: counted in the one
  pass at global shapes and divided by the mesh's device count, the
  share of a perfectly partitioned program; ``flops_global`` is the
  undivided count. ``flops`` is ``torch.utils.flop_counter``'s count,
  which covers matmul-like ops only (mm, bmm, addmm, convolution,
  attention), where XLA's also counts elementwise work. Bytes accessed
  are, over every aten op that is not a view, the bytes of its tensor
  inputs and outputs (XLA's "bytes accessed" in spirit: no fusion, so
  more). Transcendentals are the elements of the inputs of exp, log,
  tanh, sigmoid, rsqrt, sin, cos, erf and of the ops that compute one of
  them per element (softmax, log-softmax, logsumexp, silu, gelu,
  softplus, and the backward ops of silu and gelu).
* ``memory``: ``argument_bytes`` is, per device, the sum over the state
  and input leaves of bytes / the product of the sizes of the mesh axes
  in the leaf's spec (``dist.sharding``'s ``param_specs``,
  ``batch_specs``, ``cache_specs``): exact from the specs.
  ``output_bytes`` is the same for the outputs (the logits take the
  batch's data axes and the vocabulary on ``model`` where it divides);
  ``alias_bytes`` for the donated arguments (the train state, the decode
  caches: the port updates both in place). ``temp_bytes`` is the peak of
  live fake-tensor bytes beyond the arguments in a second fake pass at
  the **per-device batch** (global batch / batch shards). The port has
  no tensor-parallel step, so in that pass the activations are whole over
  the ``model`` axis, and so are the parameter-shaped temporaries
  (gradients, the optimizer's): the record says so in ``temp_basis``.
  ``code_bytes`` is 0.
* ``collectives``: the port has no SPMD partitioner and no HLO to read.
  The schedule is derived from the same specs by this rule, with the
  reference's five kinds, ``count`` and ``bytes`` per device, bytes of
  the result as in the reference's HLO count:

  - FSDP: each weight whose spec holds data axes is all-gathered over
    them once a forward (at the dtype it is used in: the compute dtype
    for projections and embeddings, float32 for the router), a result of
    its bytes / its ``model`` shards; its float32 gradient is
    reduce-scattered over those axes (a result of its per-device shard)
    and all-reduced over the data axes that do not shard it (a
    replicated leaf's gradient: over all of them).
  - TP: one all-reduce of the activations (local batch x S x d_model at
    the compute dtype) a forward after each sub-layer (mixer, FFN) whose
    output projection (``wo``, ``out_proj``, ``w_down``, ``sh_down``)
    has its input dim on ``model``, and one a backward, for the gradient
    of the sub-layer's input.
  - MoE: when the experts are sharded on ``model``, the dispatch buffer
    (local batch x E x capacity x d_model at the compute dtype) takes an
    all-to-all each way, forward and backward.
  - A train step counts the forward terms, again under remat (the
    recomputed forward gathers and reduces again), and the backward
    terms; prefill and decode the forward terms only.
  - Per-layer terms are counted once a pattern position, their bytes
    times ``n_blocks`` (the reference's ``body_trip``), so ``count``
    reads as the reference's count of ops in a scan body.
    ``depth2_raw_bytes`` is 0. Left out: the small reductions of the loss
    over a vocabulary split on ``model`` and the embedding lookup's.

``launch/compat.py`` is not ported: ``normalize_cost_analysis`` only
collapses jax's drift in the return shape of
``Compiled.cost_analysis()``, and here the counts are a dict from the
start (so is ``SpmvPlan.cost_analysis``). The reference's ``--variant
opt`` (its ``act_dp`` activation-sharding constraints) has no torch
meaning: ``models.forward`` refuses ``act_dp``, so only ``base`` runs.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out results/dryrun_torch [--jobs 4]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import multiprocessing
import time
import weakref
from pathlib import Path
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import REGISTRY, cells_for, get_config
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.dist.sharding import (batch_specs, cache_specs, dp_axes,
                                       param_specs, spec)
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import (cache_spec, cast_params, decode_step,
                                init_params, n_blocks, pattern_specs,
                                prefill)
from repro_torch.models.model import CAST_LEAVES, tree_map
from repro_torch.models.moe import _capacity
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import TrainConfig, make_train_step

__all__ = ["TensorSpec", "input_specs", "lower_cell", "run_cell",
           "collective_stats", "main"]

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
TEMP_BASIS = "per-device batch, model axis unsplit"
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# -------------------------- input specs (deliverable) ----------------------

@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor that is not there: its global shape, dtype and sharding
    spec (a tuple from ``dist.sharding``), the reference's
    ``ShapeDtypeStruct`` with a ``NamedSharding``."""

    shape: tuple
    dtype: torch.dtype
    spec: tuple

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    def shard_bytes(self, mesh) -> int:
        """Bytes a device holds: the tensor over the product of the sizes
        of the mesh axes in its spec."""
        return self.nbytes // _shards(self.spec, mesh)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _shards(sp: tuple, mesh, skip=()) -> int:
    sizes = dict(mesh.shape)
    return math.prod(sizes[a] for e in sp for a in _axes(e)
                     if a not in skip)


def _tensor_specs(shapes, specs):
    """Zip a tree of tensors (anything with ``.shape``/``.dtype``) with a
    tree of specs into a tree of ``TensorSpec``."""
    if isinstance(shapes, dict):
        return {k: _tensor_specs(shapes[k], specs[k]) for k in shapes}
    if isinstance(shapes, (list, tuple)):
        return [_tensor_specs(a, b) for a, b in zip(shapes, specs)]
    return TensorSpec(tuple(int(d) for d in shapes.shape), shapes.dtype,
                      tuple(specs))


def input_specs(cfg: ArchConfig, cell: ShapeCell, mesh) -> dict:
    """``TensorSpec`` stand-ins for every model input of this cell."""
    B, S = cell.global_batch, cell.seq_len
    bs = batch_specs(cfg, mesh, global_batch=B)
    if cell.kind in ("train", "prefill"):
        out = {"tokens": TensorSpec((B, S), torch.int32, bs["tokens"])}
        if cell.kind == "train":
            out["labels"] = TensorSpec((B, S), torch.int32, bs["labels"])
        if cfg.n_prefix:
            out["prefix_embeds"] = TensorSpec((B, cfg.n_prefix, cfg.d_model),
                                              torch.bfloat16,
                                              bs["prefix_embeds"])
        return out
    if cell.kind != "decode":
        raise ValueError(f"unknown cell kind {cell.kind!r}")
    # decode: one new token against an S-long cache (meta tensors: shapes)
    caches = cache_spec(cfg, B, S, device="meta")
    return {"token": TensorSpec((B, 1), torch.int32, bs["tokens"]),
            "pos": TensorSpec((), torch.int32, ()),
            "caches": _tensor_specs(caches, cache_specs(cfg, mesh, caches))}


def _param_structs(cfg: ArchConfig, mesh, param_dtype=None):
    """(tree of ``TensorSpec``, tree of specs) of the parameters: float32
    as the reference's; ``param_dtype`` casts the leaves ``cast_params``
    casts (a serving engine's bf16 weights)."""
    with FakeTensorMode():
        params = init_params(cfg, 0, "cpu")
        if param_dtype is not None:
            params = cast_params(params, param_dtype)
    specs = param_specs(cfg, mesh, params)
    return _tensor_specs(params, specs), specs


# ------------------------------- counting ----------------------------------

_aten = torch.ops.aten
_TRANSCENDENTAL = frozenset({
    _aten.exp, _aten.log, _aten.tanh, _aten.sigmoid, _aten.rsqrt, _aten.sin,
    _aten.cos, _aten.erf, _aten._softmax, _aten._log_softmax,
    _aten.logsumexp, _aten.silu, _aten.gelu, _aten.softplus,
    _aten.silu_backward, _aten.gelu_backward})


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _CostMode(TorchDispatchMode):
    """Bytes of every non-view aten op's tensor inputs and outputs, and
    the elements that transcendental ops take."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            ins = _tensors((args, kwargs))
            self.bytes_accessed += sum(map(_bytes, ins)) + sum(
                map(_bytes, _tensors(out)))
            if func.overloadpacket in _TRANSCENDENTAL and ins:
                self.transcendentals += ins[0].numel()
        return out


class _LiveBytes(TorchDispatchMode):
    """The peak of live storage bytes that ops create (fake storages die
    with their last tensor, as real ones would). Storages made before the
    mode (the arguments) are ``known`` and never counted, so an in-place
    write into a donated cache is not a new allocation."""

    def __init__(self, known):
        super().__init__()
        self.seen = weakref.WeakSet(t.untyped_storage() for t in known)
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            st = t.untyped_storage()
            if st not in self.seen:
                self.seen.add(st)
                n = st.nbytes()
                self.live += n
                weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


# ------------------------------ collectives --------------------------------

def _leaf_items(tree, path=""):
    """(path, leaf) over a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_items(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_items(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def _has_model(sp: tuple, dim: int) -> bool:
    return len(sp) >= -dim and "model" in _axes(sp[dim])


def collective_stats(cfg: ArchConfig, cell: ShapeCell, mesh, params,
                     compute_dtype=torch.bfloat16,
                     remat: bool = True) -> dict:
    """The collectives a partitioned step of this cell would run, per
    device, by the rule in the module docstring (the reference's
    ``collective_stats`` reads them from the partitioned HLO instead).
    ``params`` is the tree of ``TensorSpec`` of ``_param_structs``."""
    stats = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}

    def add(kind, nbytes, times=1, trip=1):
        stats[kind]["count"] += times
        stats[kind]["bytes"] += times * trip * int(nbytes)

    sizes = dict(mesh.shape)
    dp = tuple(a for a in dp_axes(mesh) if sizes[a] > 1)
    tp = sizes.get("model", 1)
    train = cell.kind == "train"
    fwd = (1 + bool(remat)) if train else 1      # forwards a step runs
    cbytes = compute_dtype.itemsize

    # FSDP: gather each data-sharded weight a forward; the gradients
    for path, leaf in _leaf_items(params):
        name = path.split("/")[-1]
        data = {a for e in leaf.spec for a in _axes(e)
                if a != "model" and sizes[a] > 1}
        model_shards = _shards(leaf.spec, mesh) // _shards(
            leaf.spec, mesh, skip=("model",))
        if data:
            width = cbytes if name in CAST_LEAVES else leaf.dtype.itemsize
            add("all-gather", math.prod(leaf.shape) * width // model_shards,
                times=fwd)
        if train:
            grad = math.prod(leaf.shape) * 4 // _shards(leaf.spec, mesh)
            if data:
                add("reduce-scatter", grad)
            if any(a not in data for a in dp):
                add("all-reduce", grad)

    # TP and MoE: per pattern position, bytes times n_blocks
    seq = 1 if cell.kind == "decode" else cell.seq_len + cfg.n_prefix
    b_axes = batch_specs(cfg, mesh, global_batch=cell.global_batch)[
        "tokens"][0]
    local_b = cell.global_batch // math.prod(sizes[a] for a in _axes(b_axes))
    act = local_b * seq * cfg.d_model * cbytes
    trip = n_blocks(cfg)
    passes = fwd + (1 if train else 0)           # forwards + one backward
    for pos, sp in zip(params["blocks"], pattern_specs(cfg)):
        mixer = pos["attn"]["wo"] if sp.kind == "A" else pos["mamba"][
            "out_proj"]
        if tp > 1 and _has_model(mixer.spec, -2):
            add("all-reduce", act, times=passes, trip=trip)
        if sp.ffn is None:
            continue
        ffn = pos["ffn"]
        downs = [ffn[k] for k in ("w_down", "sh_down") if k in ffn]
        if tp > 1 and any(_has_model(d.spec, -2) for d in downs):
            add("all-reduce", act, times=passes, trip=trip)
        if sp.ffn == "moe" and tp > 1 and _has_model(ffn["w_up"].spec, -3):
            e = cfg.moe
            buf = local_b * e.n_experts * _capacity(cfg, seq) * \
                cfg.d_model * cbytes
            add("all-to-all", buf, times=2 * passes, trip=trip)
    stats["total_bytes"] = sum(v["bytes"] for k, v in stats.items()
                               if isinstance(v, dict))
    stats["depth2_raw_bytes"] = 0
    return stats


# ------------------------------- dry run ----------------------------------

def _fake(ts: TensorSpec, batch: Optional[int] = None) -> torch.Tensor:
    """A fake tensor of ``ts`` (inside a FakeTensorMode), its leading dim
    set to ``batch`` when given."""
    shape = ts.shape if batch is None or not ts.shape else \
        (batch,) + tuple(ts.shape[1:])
    return torch.zeros(shape, dtype=ts.dtype)


def _fake_caches(tree, batch):
    """Caches are (n_blocks, batch, ...): set dim 1."""
    def one(ts):
        return torch.zeros((ts.shape[0], batch) + tuple(ts.shape[2:]),
                           dtype=ts.dtype)
    return tree_map(one, tree)


@dataclasses.dataclass
class Lowered:
    """One cell ready to count: its configs, the parameters' and inputs'
    ``TensorSpec`` trees, and the seconds they took to build."""

    cfg: ArchConfig
    cell: ShapeCell
    mesh: Mesh
    tc: TrainConfig
    params: dict
    inputs: dict
    param_dtype: Optional[torch.dtype]
    lower_s: float

    @property
    def batch_shards(self) -> int:
        b_axes = self.inputs["token" if self.cell.kind == "decode"
                             else "tokens"].spec[0]
        return math.prod(dict(self.mesh.shape)[a] for a in _axes(b_axes))

    def _args(self, batch: int):
        """Fake (state, inputs) at ``batch`` rows, inside a
        FakeTensorMode: the state is the parameters, and for a train
        step ``{"params", "opt"}`` with adamw_init's moments."""
        params = init_params(self.cfg, 0, "cpu")
        if self.param_dtype is not None:
            params = cast_params(params, self.param_dtype)
        ins = self.inputs
        if self.cell.kind == "train":
            params = {"params": params, "opt": adamw_init(params)}
        if self.cell.kind == "decode":
            return params, {"token": _fake(ins["token"], batch),
                            "pos": _fake(ins["pos"]),
                            "caches": _fake_caches(ins["caches"], batch)}
        return params, {k: _fake(v, batch) for k, v in ins.items()}

    def _call(self, state, ins):
        """Run the cell's step once on ``_args``; returns its outputs."""
        cfg, tc = self.cfg, self.tc
        dtype = _DTYPES[tc.compute_dtype]
        if self.cell.kind == "train":
            return make_train_step(cfg, tc)(state, ins)
        if self.cell.kind == "prefill":
            return prefill(cfg, state, ins["tokens"],
                           ins.get("prefix_embeds"), dtype,
                           block_kv=tc.block_kv)
        return decode_step(cfg, state, ins["token"], ins["pos"],
                           ins["caches"], dtype)

    def compile(self) -> "Compiled":
        """The counted pass at global shapes, then the memory pass at the
        per-device batch."""
        t0 = time.perf_counter()
        with FakeTensorMode():
            args = self._args(self.cell.global_batch)
            cost, flops = _CostMode(), FlopCounterMode(display=False)
            with flops, cost:
                outputs = self._call(*args)
        compile_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        with FakeTensorMode():
            args = self._args(self.cell.global_batch // self.batch_shards)
            live = _LiveBytes(_tensors(args))
            with live:
                self._call(*args)
        memory_s = time.perf_counter() - t0
        return Compiled(self, compile_s, memory_s,
                        float(flops.get_total_flops()),
                        float(cost.bytes_accessed),
                        float(cost.transcendentals), live.peak,
                        _output_specs(self, outputs))


def _output_specs(low: Lowered, outputs) -> dict:
    """``TensorSpec`` trees of the outputs, split into the donated part
    (aliased to arguments) and the rest."""
    cfg, mesh = low.cfg, low.mesh
    if low.cell.kind == "train":
        state_specs = {"params": low.params, "opt": _opt_specs(low.params)}
        metrics = [TensorSpec((), t.dtype, ()) for t in
                   _tensors(outputs[1])]
        return {"aliased": state_specs, "fresh": metrics}
    logits, caches = outputs
    b_axes = low.inputs["token" if low.cell.kind == "decode"
                        else "tokens"].spec[0]
    tp = dict(mesh.shape).get("model", 1)
    vocab = "model" if tp > 1 and logits.shape[-1] % tp == 0 else None
    lg = TensorSpec(tuple(logits.shape), logits.dtype,
                    spec(_axes(b_axes), None, vocab))
    if low.cell.kind == "decode":
        return {"aliased": low.inputs["caches"], "fresh": [lg]}
    return {"aliased": [], "fresh": [lg, _tensor_specs(
        caches, cache_specs(cfg, mesh, caches))]}


def _opt_specs(params) -> dict:
    """adamw_init's state: m and v float32 like each parameter, a
    replicated int32 count."""
    f32 = lambda t: dataclasses.replace(t, dtype=torch.float32)  # noqa: E731
    return {"m": tree_map(f32, params), "v": tree_map(f32, params),
            "count": TensorSpec((), torch.int32, ())}


def _tree_bytes(tree, mesh) -> int:
    return sum(leaf.shard_bytes(mesh) for _, leaf in _leaf_items(tree))


@dataclasses.dataclass
class Compiled:
    lowered: Lowered
    compile_s: float
    memory_s: float
    flops_global: float
    bytes_accessed_global: float
    transcendentals_global: float
    temp_bytes: int
    outputs: dict

    def cost_analysis(self) -> dict:
        """Per device (global / the mesh's device count), with the
        undivided FLOPs beside."""
        n = self.lowered.mesh.size
        return {"flops": self.flops_global / n,
                "bytes accessed": self.bytes_accessed_global / n,
                "transcendentals": self.transcendentals_global / n,
                "flops_global": self.flops_global}

    def memory_analysis(self) -> dict:
        low = self.lowered
        mesh = low.mesh
        args = {"params": low.params, "inputs": low.inputs}
        if low.cell.kind == "train":
            args["opt"] = _opt_specs(low.params)
        return {"argument_bytes": _tree_bytes(args, mesh),
                "output_bytes": _tree_bytes(self.outputs, mesh),
                "temp_bytes": int(self.temp_bytes),
                "alias_bytes": _tree_bytes(self.outputs["aliased"], mesh),
                "code_bytes": 0}

    def collectives(self) -> dict:
        low = self.lowered
        return collective_stats(low.cfg, low.cell, low.mesh, low.params,
                                   _DTYPES[low.tc.compute_dtype],
                                   remat=low.tc.remat)


def lower_cell(cfg: ArchConfig, cell: ShapeCell, mesh,
               train_cfg: Optional[TrainConfig] = None,
               param_dtype: Optional[torch.dtype] = None) -> Lowered:
    """Build the cell's parameter and input specs (no tensor is
    allocated); ``.compile()`` on the result runs the counted passes.
    ``param_dtype`` casts the weights as a serving engine holds them
    (default: float32, the reference's)."""
    tc = train_cfg or TrainConfig(
        block_kv=2048 if cell.seq_len > 8192 else None)
    t0 = time.perf_counter()
    params, _ = _param_structs(cfg, mesh, param_dtype)
    ins = input_specs(cfg, cell, mesh)
    return Lowered(cfg, cell, mesh, tc, params, ins, param_dtype,
                   time.perf_counter() - t0)


def run_cell(cfg: ArchConfig, cell: ShapeCell, multi_pod: bool,
             out_dir: Path) -> dict:
    """Dry-run one cell on a production mesh and write its record (a
    record already written is read back instead)."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    out_path = Path(out_dir) / f"{cfg.name}.{cell.name}.{mesh_name}.json"
    if out_path.exists():
        return json.loads(out_path.read_text())
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": cfg.name, "shape": cell.name, "mesh": mesh_name,
           "kind": cell.kind, "chips": mesh.size, "variant": "base"}
    try:
        lowered = lower_cell(cfg, cell, mesh)
        compiled = lowered.compile()
        ca = compiled.cost_analysis()
        rec.update({
            "ok": True,
            "lower_s": round(lowered.lower_s, 2),
            "compile_s": round(compiled.compile_s, 2),
            "memory_s": round(compiled.memory_s, 2),
            "flops": ca["flops"],
            "flops_global": ca["flops_global"],
            "bytes_accessed": ca["bytes accessed"],
            "transcendentals": ca["transcendentals"],
            "memory": compiled.memory_analysis(),
            "temp_basis": TEMP_BASIS,
            "collectives": compiled.collectives(),
        })
    except Exception as e:  # a failure here is a bug in the system
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}"})
    rec["wall_s"] = round(time.perf_counter() - t0, 2)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def _run_one(arch: str, cell: ShapeCell, multi_pod: bool,
             out_dir: str) -> dict:
    torch.set_num_threads(1)
    return run_cell(get_config(arch), cell, multi_pod, Path(out_dir))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--variant", default="base", choices=["base"],
                    help="the reference's 'opt' (act_dp) has no torch "
                    "meaning")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells dry-run at once, one process each")
    args = ap.parse_args(argv)

    archs = list(REGISTRY) if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = [(arch, cell, mp) for arch in archs
             for cell in cells_for(get_config(arch))
             if args.shape == "all" or cell.name in args.shape.split(",")
             for mp in meshes]
    t0 = time.perf_counter()
    if args.jobs > 1:
        pool = concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn"))
        futures = [pool.submit(_run_one, a, c, mp, args.out)
                   for a, c, mp in cells]
        results = (f.result() for f in futures)
    else:
        pool = None
        results = (_run_one(a, c, mp, args.out) for a, c, mp in cells)
    n_ok = n_fail = 0
    try:
        for (arch, cell, mp), rec in zip(cells, results):
            ok = bool(rec.get("ok"))
            n_ok += ok
            n_fail += not ok
            coll = rec.get("collectives", {}).get("total_bytes", 0)
            print(f"[{'OK ' if ok else 'FAIL'}] {arch:24s} {cell.name:12s} "
                  f"{'multi' if mp else 'single':6s} "
                  f"flops={rec.get('flops', 0):.3e} coll={coll:.3e} "
                  f"wall={rec.get('wall_s')}s"
                  + ("" if ok else f"  {rec.get('error', '')[:120]}"),
                  flush=True)
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed in "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
