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
  memory pass (0 in an ``opt`` record, whose one pass counts both).
* ``flops``, ``bytes_accessed``, ``transcendentals``: counted in the one
  pass at global shapes and divided by the mesh's device count, the
  share of a perfectly partitioned program (``cost_basis``:
  ``COST_BASIS``); ``flops_global`` is the undivided count. ``flops`` is
  ``torch.utils.flop_counter``'s count, which covers matmul-like ops
  only (mm, bmm, addmm, convolution, attention), where XLA's also counts
  elementwise work. Bytes accessed are, over every aten op that is not
  a view, the bytes of its tensor inputs and outputs (XLA's "bytes
  accessed" in spirit: no fusion, so more), where an op that reads only
  its inputs' shapes (``new_empty``, ``zeros_like``) counts its outputs
  alone; collectives and ``prim`` ops (a ``.device`` query) count
  nothing. Transcendentals are the
  elements of the inputs of exp, log, tanh, sigmoid, rsqrt, sin, cos,
  erf and of the ops that compute one of them per element (softmax,
  log-softmax, logsumexp, silu, gelu, softplus, and the backward ops of
  silu and gelu).
* ``memory``: ``argument_bytes`` is, per device, the sum over the state
  and input leaves of bytes / the product of the sizes of the mesh axes
  in the leaf's spec (``dist.sharding``'s ``param_specs``,
  ``batch_specs``, ``cache_specs``): exact from the specs.
  ``output_bytes`` is the same for the outputs (the logits take the
  batch's data axes and the vocabulary on ``model`` where it divides);
  ``alias_bytes`` for the donated arguments (the train state, the decode
  caches: the port updates both in place). ``temp_bytes`` is the peak of
  live fake-tensor bytes beyond the arguments in a second fake pass at
  the **per-device batch** (global batch / batch shards). That pass runs
  the one-device step, so in it the activations are whole over the
  ``model`` axis, and so are the parameter-shaped temporaries
  (gradients, the optimizer's): the record says so in ``temp_basis``
  (``TEMP_BASIS``). ``code_bytes`` is 0.
* ``collectives``: the port has no SPMD partitioner and no HLO to read:
  every cell's ``collectives_basis`` is ``"issued"``. The cell's
  sharded call runs once as rank 0 of a fake process group of the
  mesh's size (``torch.testing._internal.distributed.fake_pg``), on fake
  tensors at rank 0's local shapes (each leaf's slice under its spec:
  the parameters by ``param_specs``, the batch's rows, a decode cell's
  caches by ``cache_specs``), and every collective that
  ``dist.collectives`` issues is counted
  (``dist.collectives.count_collectives``) by the reference's kinds:
  ``count`` the collectives issued, ``bytes`` the bytes of their
  results, per device. The call is the one a deployment runs: a train
  cell's ``make_train_step(cfg, tc, grad_specs=specs, mesh=mesh)`` with
  ``tc``'s ``seq_shard`` and ``act_dp``; a prefill or decode cell's
  ``prefill`` / ``decode_step`` with ``layout=`` (the sharded serving
  step, under ``torch.no_grad()``). A collective over a group of one
  process moves nothing and is not counted (XLA removes it). The pass
  refuses to run where a process group is already initialised, and
  destroys its own before it returns (``sharded_pass``).

  ``collective_stats`` keeps the rule the prefill and decode cells were
  counted by before the port had a sharded serving step: derived from
  the specs, bytes of the result as in the reference's HLO count. FSDP:
  each weight whose spec holds data axes is all-gathered over them once
  a forward (at the dtype it is used in: the compute dtype for
  projections and embeddings, float32 for the router), a result of its
  bytes / its ``model`` shards. TP: one all-reduce of the activations
  (local batch x S x d_model at the compute dtype) after each sub-layer
  (mixer, FFN) whose output projection (``wo``, ``out_proj``,
  ``w_down``, ``sh_down``) has its input dim on ``model``. MoE: when the
  experts are sharded on ``model``, the dispatch buffer (local batch x E
  x capacity x d_model at the compute dtype) takes an all-to-all each
  way. Per-layer terms are counted once a pattern position, their bytes
  times ``n_blocks`` (the reference's ``body_trip``). No record uses it
  now: it is a hand count, which the tests hold the issued counts to
  where the two count the same thing.

  ``depth2_raw_bytes`` is 0. Where the reference's ``count`` is of ops
  in the partitioned HLO (a scan body's once), an issued count is of
  every call, once a block.

The ``opt`` variant (``--variant opt``, ``lower_cell(...,
optimized=True)``, records ``<arch>.<shape>.<mesh>.opt.json`` with
``"variant": "opt"``) is the reference's lowering with ``act_dp =
dp_axes(mesh)``, the activations anchored to the data axes, whose XLA
costs and memory are per device of the partitioned program. Here its
counterpart is **rank 0's own sharded call** with ``act_dp`` (the train
step's ``TrainConfig(act_dp=...)``, ``seq_shard`` as the ``TrainConfig``
says; ``prefill`` / ``decode_step`` with ``act_dp=layout.dp``), the call
the collectives are counted on: one pass of it counts the collectives,
``flops``, ``bytes_accessed`` and ``transcendentals`` as rank 0's own
counts (``cost_basis``: ``RANK0_BASIS``) and ``temp_bytes`` as the peak
of live bytes beyond rank 0's local arguments (its gathered leaves,
activations and their saved tensors, gradients, the optimizer's
temporaries; the donated state's in-place updates are not new bytes;
``temp_basis``: ``RANK0_BASIS``). ``argument_bytes + temp_bytes`` then
says whether a cell fits one device of its mesh, the model-split cells
included. ``argument_bytes``, ``output_bytes`` and ``alias_bytes`` stay
exact from the specs, as in ``base``, and an ``opt`` record has no
``flops_global``: what a rank computes is not the global count over the
device count where work is repeated (MoE routing, gathered logits).

``launch/compat.py`` is not ported: ``normalize_cost_analysis`` only
collapses jax's drift in the return shape of
``Compiled.cost_analysis()``, and here the counts are a dict from the
start (so is ``SpmvPlan.cost_analysis``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out results/dryrun_torch [--jobs 4] \\
      [--variant opt]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
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
from repro_torch.dist.collectives import Layout, count_collectives
from repro_torch.dist.sharding import (batch_specs, cache_specs, dp_axes,
                                       mesh_coords, param_specs, spec)
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import (cache_spec, cast_params, decode_step,
                                init_params, n_blocks, pattern_specs,
                                prefill)
from repro_torch.models.model import CAST_LEAVES, padded_vocab, tree_map
from repro_torch.models.moe import _capacity
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import TrainConfig, make_train_step

__all__ = ["TensorSpec", "input_specs", "lower_cell", "run_cell",
           "collective_stats", "issued_collectives", "sharded_pass",
           "main"]

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
TEMP_BASIS = "per-device batch, model axis unsplit"
COST_BASIS = "global count / devices"
RANK0_BASIS = "rank 0's sharded call"
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
# ops that read no more of their tensor inputs than shape, dtype, device
_SHAPE_ONLY = frozenset({
    _aten.new_empty, _aten.new_empty_strided, _aten.new_zeros,
    _aten.new_ones, _aten.new_full, _aten.empty_like, _aten.zeros_like,
    _aten.ones_like, _aten.full_like})


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _CostMode(TorchDispatchMode):
    """Bytes of every non-view aten op's tensor inputs and outputs (only
    the outputs of ops that read their inputs' shapes alone; no
    collective and no ``prim`` op, such as a ``.device`` query), and the
    elements that transcendental ops take."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "aten" and not func.is_view:
            ins = [] if func.overloadpacket in _SHAPE_ONLY else \
                _tensors((args, kwargs))
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


def _no_stats() -> dict:
    return {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}


def _totals(stats: dict) -> dict:
    stats["total_bytes"] = sum(v["bytes"] for k, v in stats.items()
                               if isinstance(v, dict))
    stats["depth2_raw_bytes"] = 0
    return stats


def _rank0_mesh(mesh) -> Mesh:
    """``mesh`` as a mesh of processes seen from rank 0 of a process group
    of its size: rank 0's groups over each axis, over each run of two or
    more data axes (those ``make_local_mesh`` makes) and the whole mesh."""
    import torch.distributed as dist
    axes = mesh.axis_names
    dp = tuple(a for a in axes if a != "model")
    groups = {}
    for sub in [(a,) for a in axes] + [dp[-k:]
                                       for k in range(2, len(dp) + 1)]:
        ranks = [r for r in range(mesh.size)
                 if all(c == 0 for a, c in mesh_coords(mesh, r).items()
                        if a not in sub)]
        groups[sub] = dist.new_group(ranks)
    groups[axes] = dist.group.WORLD
    return Mesh(axes, mesh.sizes, rank=0, device=torch.device("cpu"),
                groups=groups)


@dataclasses.dataclass
class ShardedPass:
    """What rank 0's own sharded call counted in one pass: the
    collectives it issued (per device, by kind), its FLOPs, bytes
    accessed and transcendentals, the peak of live bytes beyond its
    local arguments (None where the pass counted collectives only), its
    (fake) outputs and the pass's seconds."""

    collectives: dict
    flops: Optional[float]
    bytes_accessed: Optional[float]
    transcendentals: Optional[float]
    temp_bytes: Optional[int]
    outputs: tuple
    seconds: float


def sharded_pass(low: "Lowered", costs: bool = True) -> ShardedPass:
    """The cell's sharded call (a train step, a prefill or a decode step)
    run once as rank 0 of a fake process group of its mesh's size, on
    fake tensors at rank 0's local shapes, with every counter open (see
    the module docstring); ``costs=False`` counts the collectives alone
    (a base record's), which takes about half the time."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            "the dry run counts a step's collectives in a fake process "
            "group of its own, and a process group is already initialised "
            "in this process: run the dry run outside it")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    t0 = time.perf_counter()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=low.mesh.size)
    try:
        mesh = _rank0_mesh(low.mesh)
        with FakeTensorMode(), contextlib.ExitStack() as ctx:
            args = low._local_args()
            if low.cell.kind != "train":
                ctx.enter_context(torch.no_grad())
            if costs:
                flops = ctx.enter_context(FlopCounterMode(display=False))
                cost = ctx.enter_context(_CostMode())
                live = ctx.enter_context(_LiveBytes(_tensors(args)))
            issued = ctx.enter_context(count_collectives())
            outputs = low._call(*args, mesh=mesh)
    finally:
        dist.destroy_process_group()
    stats = _no_stats()
    for kind, n, nbytes in issued:
        if n > 1:
            stats[kind]["count"] += 1
            stats[kind]["bytes"] += nbytes
    counts = (float(flops.get_total_flops()), float(cost.bytes_accessed),
              float(cost.transcendentals), live.peak) if costs else \
        (None,) * 4
    return ShardedPass(_totals(stats), *counts, outputs,
                       time.perf_counter() - t0)


def issued_collectives(low: "Lowered") -> dict:
    """The collectives the cell's sharded call issues on one device (rank
    0) of its mesh (``sharded_pass``'s, collectives alone)."""
    return sharded_pass(low, costs=False).collectives


def collective_stats(cfg: ArchConfig, cell: ShapeCell, mesh, params,
                     compute_dtype=torch.bfloat16,
                     remat: bool = True) -> dict:
    """The collectives a partitioned step of this cell would run, per
    device, by the rule in the module docstring (the reference's
    ``collective_stats`` reads them from the partitioned HLO instead): a
    hand count beside the issued one. ``params`` is the tree of
    ``TensorSpec`` of ``_param_structs``."""
    stats = _no_stats()

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
    return _totals(stats)


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
    ``TensorSpec`` trees, and the seconds they took to build.
    ``act_dp``: the ``opt`` variant's data axes, which its serving calls
    take (a train step takes ``tc.act_dp``); None for ``base``."""

    cfg: ArchConfig
    cell: ShapeCell
    mesh: Mesh
    tc: TrainConfig
    params: dict
    inputs: dict
    param_dtype: Optional[torch.dtype]
    lower_s: float
    act_dp: Optional[tuple] = None

    @property
    def optimized(self) -> bool:
        return self.act_dp is not None

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

    def _local_args(self):
        """Fake (state, inputs) at rank 0's local shapes (each leaf's
        slice under its spec: the parameters, the batch's rows, a decode
        cell's caches), inside a FakeTensorMode; a train step's state is
        ``{"params", "opt"}``."""
        sizes = dict(self.mesh.shape)
        local = lambda t: torch.zeros(tuple(  # noqa: E731
            d // math.prod(sizes[a] for a in _axes(e))
            for d, e in zip(t.shape, t.spec)), dtype=t.dtype)
        params = tree_map(local, self.params)
        ins = tree_map(local, self.inputs)
        if self.cell.kind == "train":
            return {"params": params, "opt": adamw_init(params)}, ins
        return params, ins

    def _call(self, state, ins, mesh=None):
        """Run the cell's step once; returns its outputs. Without
        ``mesh``, a base record's passes: the one-device step on
        ``_args``, without ``act_dp`` and ``seq_shard`` (they need a mesh
        of processes), so its costs are the global counts and its
        temporaries hold every leaf and activation whole over ``model``.
        With ``mesh`` (rank 0's, in ``sharded_pass``'s fake group): the
        sharded call on ``_local_args``, with the ``TrainConfig``'s
        ``act_dp`` and ``seq_shard`` and the serving calls' ``act_dp``,
        the pass an ``opt`` record reads its costs from too."""
        cfg = self.cfg
        tc, act_dp, layout, sharded = self.tc, self.act_dp, None, {}
        if mesh is None:
            tc = dataclasses.replace(tc, act_dp=None, seq_shard=False)
            act_dp = None
        else:
            specs = tree_map(lambda t: t.spec, self.params)
            layout = Layout(cfg, mesh, specs)
            sharded = {"grad_specs": specs, "mesh": mesh}
        dtype = _DTYPES[tc.compute_dtype]
        if self.cell.kind == "train":
            return make_train_step(cfg, tc, **sharded)(state, ins)
        if self.cell.kind == "prefill":
            return prefill(cfg, state, ins["tokens"],
                           ins.get("prefix_embeds"), dtype,
                           block_kv=tc.block_kv, act_dp=act_dp,
                           layout=layout)
        return decode_step(cfg, state, ins["token"], ins["pos"],
                           ins["caches"], dtype, act_dp=act_dp,
                           layout=layout)

    def compile(self) -> "Compiled":
        """Base: the counted pass at global shapes, then the memory pass
        at the per-device batch. ``opt``: rank 0's sharded call, once."""
        if self.optimized:
            rank0 = sharded_pass(self)
            return Compiled(self, rank0.seconds, 0.0, None, None, None,
                            rank0.temp_bytes,
                            _output_specs(self, rank0.outputs), rank0)
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
    """``TensorSpec`` trees of the outputs at global shapes, split into
    the donated part (aliased to arguments) and the rest: the train
    step's state and its 0-d metrics (of ``outputs``, the call's, one
    device's or rank 0's), the serving calls' float32 logits of the last
    position over the padded vocabulary and a prefill's caches,
    ``cache_spec``'s leaves of the processed sequence (a sliding
    window's slots at most) in the compute dtype."""
    cfg, mesh, cell = low.cfg, low.mesh, low.cell
    if cell.kind == "train":
        state_specs = {"params": low.params, "opt": _opt_specs(low.params)}
        metrics = [TensorSpec((), t.dtype, ()) for t in
                   _tensors(outputs[1])]
        return {"aliased": state_specs, "fresh": metrics}
    B, V = cell.global_batch, padded_vocab(cfg)
    b_axes = low.inputs["token" if cell.kind == "decode"
                        else "tokens"].spec[0]
    tp = dict(mesh.shape).get("model", 1)
    vocab = "model" if tp > 1 and V % tp == 0 else None
    lg = TensorSpec((B, 1, V), torch.float32,
                    spec(_axes(b_axes), None, vocab))
    if cell.kind == "decode":
        return {"aliased": low.inputs["caches"], "fresh": [lg]}
    caches = cache_spec(cfg, B, cell.seq_len + cfg.n_prefix,
                        _DTYPES[low.tc.compute_dtype], device="meta")
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
    """A counted cell. Base: the global counts (``*_global``) and the
    memory pass's ``temp_bytes``; ``opt``: ``rank0``, the sharded pass,
    which holds them all (the global counts are None)."""

    lowered: Lowered
    compile_s: float
    memory_s: float
    flops_global: Optional[float]
    bytes_accessed_global: Optional[float]
    transcendentals_global: Optional[float]
    temp_bytes: int
    outputs: dict
    rank0: Optional[ShardedPass] = None

    @property
    def cost_basis(self) -> str:
        return COST_BASIS if self.rank0 is None else RANK0_BASIS

    @property
    def temp_basis(self) -> str:
        return TEMP_BASIS if self.rank0 is None else RANK0_BASIS

    def cost_analysis(self) -> dict:
        """Per device: base, global / the mesh's device count, with the
        undivided FLOPs beside; ``opt``, rank 0's own counts."""
        if self.rank0 is not None:
            r = self.rank0
            return {"flops": r.flops, "bytes accessed": r.bytes_accessed,
                    "transcendentals": r.transcendentals}
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

    collectives_basis = "issued"

    def collectives(self) -> dict:
        """Per device, as the cell's sharded call issues them (the module
        docstring): an ``opt`` cell's from its one pass."""
        if self.rank0 is not None:
            return self.rank0.collectives
        return issued_collectives(self.lowered)


def lower_cell(cfg: ArchConfig, cell: ShapeCell, mesh,
               train_cfg: Optional[TrainConfig] = None,
               param_dtype: Optional[torch.dtype] = None,
               optimized: bool = False) -> Lowered:
    """Build the cell's parameter and input specs (no tensor is
    allocated); ``.compile()`` on the result runs the counted passes.
    ``param_dtype`` casts the weights as a serving engine holds them
    (default: float32, the reference's). ``optimized``: the ``opt``
    variant, ``act_dp = dp_axes(mesh)`` in the default ``TrainConfig``
    (a ``train_cfg`` given wins, as in the reference) and in the serving
    calls, counted on rank 0's sharded call (the module docstring)."""
    act_dp = dp_axes(mesh) if optimized else None
    tc = train_cfg or TrainConfig(
        block_kv=2048 if cell.seq_len > 8192 else None, act_dp=act_dp)
    t0 = time.perf_counter()
    params, _ = _param_structs(cfg, mesh, param_dtype)
    ins = input_specs(cfg, cell, mesh)
    return Lowered(cfg, cell, mesh, tc, params, ins, param_dtype,
                   time.perf_counter() - t0, act_dp)


def run_cell(cfg: ArchConfig, cell: ShapeCell, multi_pod: bool,
             out_dir: Path, optimized: bool = False) -> dict:
    """Dry-run one cell on a production mesh and write its record (a
    record already written is read back instead); ``optimized``: the
    ``opt`` variant, tagged ``.opt``."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{cfg.name}.{cell.name}.{mesh_name}" + (".opt" if optimized
                                                    else "")
    out_path = Path(out_dir) / f"{tag}.json"
    if out_path.exists():
        return json.loads(out_path.read_text())
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": cfg.name, "shape": cell.name, "mesh": mesh_name,
           "kind": cell.kind, "chips": mesh.size,
           "variant": "opt" if optimized else "base"}
    try:
        lowered = lower_cell(cfg, cell, mesh, optimized=optimized)
        compiled = lowered.compile()
        ca = compiled.cost_analysis()
        rec.update({
            "ok": True,
            "lower_s": round(lowered.lower_s, 2),
            "compile_s": round(compiled.compile_s, 2),
            "memory_s": round(compiled.memory_s, 2),
            "flops": ca["flops"],
            **({"flops_global": ca["flops_global"]}
               if "flops_global" in ca else {}),
            "bytes_accessed": ca["bytes accessed"],
            "transcendentals": ca["transcendentals"],
            "cost_basis": compiled.cost_basis,
            "memory": compiled.memory_analysis(),
            "temp_basis": compiled.temp_basis,
            "collectives": compiled.collectives(),
            "collectives_basis": compiled.collectives_basis,
        })
    except Exception as e:  # a failure here is a bug in the system
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}"})
    rec["wall_s"] = round(time.perf_counter() - t0, 2)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def _run_one(arch: str, cell: ShapeCell, multi_pod: bool, out_dir: str,
             optimized: bool) -> dict:
    torch.set_num_threads(1)
    return run_cell(get_config(arch), cell, multi_pod, Path(out_dir),
                    optimized)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--variant", default="base", choices=["base", "opt"],
                    help="opt: rank 0's sharded call with act_dp, the "
                    "reference's activation-sharding variant")
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
    opt = args.variant == "opt"
    t0 = time.perf_counter()
    if args.jobs > 1:
        pool = concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn"))
        futures = [pool.submit(_run_one, a, c, mp, args.out, opt)
                   for a, c, mp in cells]
        results = (f.result() for f in futures)
    else:
        pool = None
        results = (_run_one(a, c, mp, args.out, opt) for a, c, mp in cells)
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
