"""Collectives of the sharded train step, as autograd Functions over the
axis groups of a mesh of processes (``launch.mesh.make_local_mesh``
inside a process group), and ``Layout``, which applies them to a state
laid out by ``dist.sharding.param_specs``.

* Gather for use (``Layout.use``): forward all-gathers a leaf's slices
  over the axes named; backward brings the gradient of the whole leaf
  back into the leaf's layout. Over the data axes it is a sum (each data
  position computed on other rows of the batch): a reduce-scatter over
  the axes that split the leaf, an all-reduce over those that replicate
  it. Over ``model`` it is the position's own part: the model positions
  that use a gathered leaf all compute the same thing, so their
  gradients are equal and taking one is exact. A leaf that each model
  position uses in part (``tp_whole``: Mamba's ``in_proj``, whose split
  over ``model`` does not fall on head boundaries, or a per-head vector)
  has a partial gradient on each: it is summed over ``model`` too.
* Megatron's pair for tensor parallelism over ``model``
  (``TensorParallel``): ``enter`` (identity forward, all-reduce
  backward) before the column-parallel products, ``exit`` (all-reduce
  forward, identity backward) after the row-parallel one. ``sum`` is an
  all-reduce both ways, for a sum that each position then uses on its
  own part (the gated norm's sum of squares over its heads' channels),
  and ``vocab_lse`` the log-sum-exp and target logit of logits split
  over the vocabulary.
* ``Layout.dp_sum`` sums the loss's parts over the data axes with
  ``exit``'s pair: every position then holds the global loss, whose
  gradient with respect to its own part is the identity.
* Sequence parallelism (``SequenceParallel``, the step's ``seq_shard``):
  between the sub-layers each model position holds its ``ceil(S' / m)``
  rows of the residual stream (``S'`` the sequence with its prefix, ``m``
  the model size; the last position's rows padded with zeros), and each
  sub-layer gathers the whole sequence before it computes and scatters it
  back after, by one of two pairs. In a split region (``TensorParallel``
  with ``seq``) ``enter`` all-gathers the rows forward and
  reduce-scatters the gradient backward (each position's column-parallel
  products give a partial input gradient), and ``exit`` reduce-scatters
  the row-parallel partial sums forward, in place of the all-reduce, and
  all-gathers the gradient backward. Around a region whose leaves are
  gathered whole over ``model`` (every position computes the same thing)
  ``gather`` all-gathers forward and takes the position's own rows of the
  gradient backward, and ``split`` keeps the position's own rows forward
  and all-gathers the gradient backward: every position then holds the
  whole upstream gradient, the whole-gathered leaves' gradients stay
  equal over ``model``, and taking one stays exact. The pad rows are
  dropped after every gather, so no sub-layer sees them, and take no
  gradient. A leaf that runs on the rows (the norms' scales and biases)
  has a partial gradient on each position: ``Layout`` sums it over
  ``model`` (``tp_whole``).

Gradients are summed in float32 whatever their dtype (a bfloat16
gradient is cast back after the sum), so a bfloat16 leaf's gradient is
rounded once, as on one device. No collective special-cases a group of
one: on one device every collective is still issued, over groups of one
process.

Serving (``models.prefill`` / ``decode_step`` with a layout, under
``torch.no_grad()``) uses the same ``Layout``: its gathers and
Megatron's pair run forward only, and one more collective takes no
gradient: ``TensorParallel.gather`` joins the positions' parts of a
tensor along a dim (the logits' vocabulary columns, the conv state's
channels). ``Layout.conv_part`` says which channels of Mamba's conv
cache a model position holds (``dist.sharding.cache_specs`` cuts them
into contiguous chunks, as ``conv_w`` is cut, which do not fall on the
position's heads) and ``Layout.conv_whole`` gathers them.

``count_collectives`` records, while it is open, the kind, the group
size and the bytes of the result of every collective issued here (the
dry run counts a step's collectives with it).
"""
from __future__ import annotations

import contextlib
import copy
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .sharding import (TP_AXIS, conv_part, dp_axes, map_specs,
                       spec_axes, spec_leaves)

__all__ = ["Layout", "TensorParallel", "SequenceParallel", "gather_leaf",
           "count_collectives", "TP_SPLIT"]

# the leaves a tensor-parallel region splits over ``model`` (by columns:
# wq, wk, wv, w_up, w_gate; by rows: wo, w_down)
TP_SPLIT = frozenset({"wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down"})


def _size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


_COUNTS = []     # the open count_collectives records, innermost last


@contextlib.contextmanager
def count_collectives():
    """A list that receives ``(kind, group size, bytes of the result)``
    for every collective issued while the context is open, ``kind`` the
    reference's name (``all-gather``, ``reduce-scatter``,
    ``all-reduce``)."""
    rec = []
    _COUNTS.append(rec)
    try:
        yield rec
    finally:
        _COUNTS.remove(rec)


def _count(kind: str, n: int, out: torch.Tensor) -> None:
    for rec in _COUNTS:
        rec.append((kind, n, out.numel() * out.element_size()))


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` positions' ``x`` joined along ``dim`` in group order."""
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, xm, group=group)
    _count("all-gather", n, out)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group,
                    n: int) -> torch.Tensor:
    """Part (group rank) of the sum of the ``n`` positions' ``x``, cut
    along ``dim``."""
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
    scatter = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    scatter(out, xm, group=group)
    _count("reduce-scatter", n, out)
    return out.movedim(0, dim)


def _all_reduce(x: torch.Tensor, group,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    if _COUNTS:
        _count("all-reduce", dist.get_world_size(group), y)
    return y


class _GatherForUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, gathers, sums, part, sum_model):
        ctx.mesh, ctx.gathers, ctx.sums, ctx.part = mesh, gathers, sums, part
        ctx.sum_model = sum_model
        if not gathers:
            return x.view_as(x)
        for dim, axes in gathers:
            x = _all_gather(x, dim, mesh.group(axes), _size(mesh, axes))
        # laid out as the whole leaf: a gather along a later dim is a
        # transposed view, and a product reads it with other kernels
        return x.contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, dtype = ctx.mesh, g.dtype
        g = g.float()
        for dim, axes in reversed(ctx.gathers):       # model: own part
            if axes == (TP_AXIS,) and ctx.sum_model:  # ... or summed
                g = _reduce_scatter(g, dim, mesh.group(axes),
                                    mesh.shape[TP_AXIS])
            elif axes == (TP_AXIS,):
                n = g.shape[dim] // mesh.shape[TP_AXIS]
                g = g.narrow(dim, ctx.part * n, n)
        for dim, axes in reversed(ctx.gathers):       # data: summed
            if axes != (TP_AXIS,):
                g = _reduce_scatter(g, dim, mesh.group(axes),
                                    _size(mesh, axes))
        if ctx.sums:
            g = _all_reduce(g, mesh.group(ctx.sums))
        return g.to(dtype), None, None, None, None, None


class _Enter(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Exit(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Sum(torch.autograd.Function):
    """All-reduce forward and backward: a sum of the positions' parts
    that each position then uses on its own part of the work, so its
    gradient there is partial too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _VocabLse(torch.autograd.Function):
    """Logits split over the vocabulary, ``(..., V / tp)`` on each
    position, its columns starting at ``start``: the log-sum-exp over the
    whole vocabulary and the logit of each ``label`` (taken from the
    position that holds it), the same on every position. The row max is
    all-reduced (MAX) and held constant, the sum of exponentials and the
    target logit are summed. Backward, on the position's columns:
    ``g_lse * softmax + g_ll * one_hot(label)``."""

    @staticmethod
    def forward(ctx, logits, labels, start, group):
        n = logits.shape[-1]
        m = _all_reduce(logits.amax(-1), group, dist.ReduceOp.MAX)
        se = _all_reduce(torch.exp(logits - m[..., None]).sum(-1), group)
        lse = m + torch.log(se)
        local = labels - start
        mine = (local >= 0) & (local < n)
        local = torch.where(mine, local, 0)
        ll = torch.gather(logits, -1, local[..., None])[..., 0]
        ll = _all_reduce(torch.where(mine, ll, 0.0), group)
        ctx.save_for_backward(logits, lse, local, mine)
        return lse, ll

    @staticmethod
    def backward(ctx, g_lse, g_ll):
        logits, lse, local, mine = ctx.saved_tensors
        g = torch.exp(logits - lse[..., None]) * g_lse[..., None]
        g.scatter_add_(-1, local[..., None],
                       torch.where(mine, g_ll, 0.0)[..., None])
        return g, None, None, None


class _SeqGather(torch.autograd.Function):
    """All-gather of the positions' rows along dim 1 forward. Backward:
    the reduce-scatter of the gradient (``summed``: each position's
    gradient is partial) or the position's own rows of it (each holds the
    whole gradient)."""

    @staticmethod
    def forward(ctx, x, group, n, rank, summed):
        ctx.group, ctx.n, ctx.rank, ctx.summed = group, n, rank, summed
        return _all_gather(x, 1, group, n)

    @staticmethod
    def backward(ctx, g):
        return _seq_grad(g, ctx, ctx.summed), None, None, None, None


class _SeqGatherTwice(torch.autograd.Function):
    """One all-gather along dim 1, two outputs: the first takes
    ``_SeqGather``'s own-rows backward, the second its reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group, n, rank):
        ctx.group, ctx.n, ctx.rank = group, n, rank
        out = _all_gather(x, 1, group, n)
        return out, out.view_as(out)

    @staticmethod
    def backward(ctx, g_own, g_sum):
        return (_seq_grad(g_own, ctx, False) + _seq_grad(g_sum, ctx, True),
                None, None, None)


def _seq_grad(g: torch.Tensor, ctx, summed: bool) -> torch.Tensor:
    if summed:
        return _reduce_scatter(g, 1, ctx.group, ctx.n)
    rows = g.shape[1] // ctx.n
    return g.narrow(1, ctx.rank * rows, rows).contiguous()


class _SeqScatter(torch.autograd.Function):
    """Reduce-scatter along dim 1 forward, all-gather of the gradient
    backward."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _reduce_scatter(x, 1, group, n)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 1, ctx.group, ctx.n), None, None


class _SeqSplit(torch.autograd.Function):
    """The position's own rows (dim 1) forward, all-gather of the
    gradient backward."""

    @staticmethod
    def forward(ctx, x, group, n, rank):
        ctx.group, ctx.n = group, n
        rows = x.shape[1] // n
        return x.narrow(1, rank * rows, rows).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 1, ctx.group, ctx.n), None, None, None


class SequenceParallel:
    """The residual stream's sequence split over the ``model`` axis of
    ``mesh``: a sequence of ``length`` rows (``S'``, the prefix's
    included), ``rows = ceil(length / size)`` of them on each model
    position, the last position's padded with zeros. ``(B, length, D)``
    and ``(B, rows, D)`` tensors (see the module's docstring for the two
    pairs)."""

    def __init__(self, mesh, length: int):
        self.group = mesh.group(TP_AXIS)
        self.size = mesh.shape[TP_AXIS]
        self.rank = mesh.coords.get(TP_AXIS, 0)
        self.length = length
        self.rows = -(-length // self.size)

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.rows * self.size - x.shape[1]
        return F.pad(x, (0, 0, 0, pad)) if pad else x

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """Whole ``x`` (the same on every position) -> this position's
        rows; the gradient is all-gathered."""
        return _SeqSplit.apply(self._pad(x), self.group, self.size,
                               self.rank)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Each position's partial whole ``x`` -> this position's rows of
        their sum (a reduce-scatter); the gradient is all-gathered."""
        return _SeqScatter.apply(self._pad(x), self.group, self.size)

    def gather(self, x: torch.Tensor, summed: bool = False) -> torch.Tensor:
        """This position's rows -> the whole sequence, the pad rows
        dropped. Backward: the position's own rows of the gradient, or
        with ``summed`` the reduce-scatter of the positions' partial
        gradients."""
        out = _SeqGather.apply(x, self.group, self.size, self.rank, summed)
        return out.narrow(1, 0, self.length)

    def gather_twice(self, x: torch.Tensor) -> tuple:
        """``(gather(x), gather(x, summed=True))`` from one all-gather."""
        own, summed = _SeqGatherTwice.apply(x, self.group, self.size,
                                            self.rank)
        return own.narrow(1, 0, self.length), \
            summed.narrow(1, 0, self.length)


class TensorParallel:
    """Megatron's f/g pair over the ``model`` axis of ``mesh``: a
    column-parallel product takes ``enter(x)``, a row-parallel one's
    partial sums leave through ``exit``. ``rank`` is the position's
    index on ``model``. With ``seq`` (a ``SequenceParallel``, see
    ``over``) ``enter`` gathers the sequence from the position's rows and
    ``exit`` scatters it back."""

    def __init__(self, mesh):
        self.group = mesh.group(TP_AXIS)
        self.size = mesh.shape[TP_AXIS]
        self.rank = mesh.coords.get(TP_AXIS, 0)
        self.seq = None

    def over(self, seq: "SequenceParallel") -> "TensorParallel":
        """This pair with the sequence split by ``seq``."""
        tp = copy.copy(self)
        tp.seq = seq
        return tp

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if self.seq is not None:
            return self.seq.gather(x, summed=True)
        return _Enter.apply(x, self.group)

    def enter_whole(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor that every position holds whole (MoE's gates) enters:
        identity forward, all-reduce backward, with ``seq`` too."""
        return _Enter.apply(x, self.group)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        if self.seq is not None:
            return self.seq.scatter(x)
        return _Exit.apply(x, self.group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over ``model``, its gradient summed too."""
        return _Sum.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The positions' parts of ``x`` joined along ``dim`` in rank
        order, on every position (an all-gather; no gradient: serving)."""
        return _all_gather(x, dim, self.group, self.size)

    def vocab_lse(self, logits: torch.Tensor, labels: torch.Tensor):
        """``(lse, target logit)`` of logits whose last dim is this
        position's part of the vocabulary (part ``rank`` of ``size``
        equal parts); ``labels`` index the whole vocabulary."""
        return _VocabLse.apply(logits, labels,
                               self.rank * logits.shape[-1], self.group)


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf on every position (no autograd): its slices
    all-gathered over every axis ``spec`` names."""
    for dim, e in enumerate(spec):
        axes = spec_axes(e)
        if axes:
            x = _all_gather(x, dim, mesh.group(axes), _size(mesh, axes))
    return x


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _leaves(t)]
    return [tree]


class Layout:
    """A parameter tree laid out over a mesh of processes: ``specs`` (from
    ``param_specs`` on the global shapes) and the mesh's groups.

    Each leaf that the specs split over ``model`` is used split, in a
    tensor-parallel region (``TensorParallel``), where the split keeps
    whole units of work; the flags below say where, per pattern position,
    and are decided by the specs. A model axis of one counts as split,
    with groups of one.

    * ``attn_tp``: attention, when ``n_kv_heads`` divides by the model
      size and the specs split ``wq``/``wk``/``wv`` by columns and ``wo``
      by rows: each position holds ``n_heads / tp`` whole query heads and
      their ``n_kv_heads / tp`` kv heads.
    * ``mlp_tp``: a dense MLP, when the specs split ``w_up``/``w_gate``
      by columns and ``w_down`` by rows (any column split is whole FFN
      columns).
    * ``moe_tp``: MoE, ``"ep"`` when the specs split the experts
      (``_MOE_EP``: ``n_experts`` divides): each position runs its
      ``n_experts / tp`` experts; ``"hidden"`` where the reference falls
      back to splitting the expert hidden dim (``_MOE_HIDDEN_TP``): each
      runs every expert on its ``d_expert / tp`` columns. The router runs
      whole on every position, before the region. The shared experts run
      column/row-parallel in the same region when the specs split them.
    * ``ssm_tp``: Mamba, when the head count divides and the specs split
      ``out_proj`` by rows (which then fall on head boundaries): each
      position runs ``heads / tp`` SSD heads. ``in_proj`` and ``conv_w``
      are split over ``model`` in contiguous columns (rows) that do not
      fall on head boundaries, and B and C are every head's: they are
      gathered whole and used in part (``tp_whole``), as are the
      per-head ``A_log``/``dt_bias``/``D`` and the channel vectors
      ``gate_norm``/``conv_b``; their gradients are summed over
      ``model``.
    * ``vocab_tp`` (once): the embedding's rows and the head's columns,
      when the specs split the padded vocabulary; the loss takes the
      log-sum-exp over the split.
    * ``conv_part`` (serving): ``(lo, hi)``, the channels of Mamba's
      conv cache ``(nb, B, W-1, ch)`` that this position holds where
      ``cache_specs`` cuts them into chunks over ``model``, None where
      it holds all of them (``dist.sharding.conv_part``);
      ``conv_whole`` puts a block's chunks together. The KV and SSM
      caches need no flag:
      ``cache_specs`` splits their heads over ``model`` exactly where
      ``attn_tp`` and ``ssm_tp`` split the weights (``n_kv_heads`` and the
      SSM head count divide), and replicates them where each position
      computes every head.

    With the sequence split (``seq``) the norms' leaves (``ln1``,
    ``ln2``, ``final_norm``) run on the position's rows, and so do
    shared experts that run outside MoE's region: their gradients are
    summed over ``model`` (``tp_whole``).

    Where a split is not possible the position's leaves are gathered
    whole over ``model`` and the model positions compute the same thing:
    a head count that does not divide (2 kv heads on ``model=4``: the
    specs still split ``wq``/``wk``/``wv``'s columns, which GSPMD would
    partition inside a head; a Mamba head count), or an expert count and
    an expert hidden dim that do not (the specs replicate the experts
    then, and the shared experts run outside the region too)."""

    def __init__(self, cfg, mesh, specs):
        if not getattr(mesh, "distributed", False):
            raise ValueError("a Layout needs a mesh of processes "
                             "(make_local_mesh inside a process group)")
        self.cfg, self.mesh, self.specs = cfg, mesh, specs
        self.coords = mesh.coords
        self.dp = dp_axes(mesh)
        self.n_dp = _size(mesh, self.dp)
        self.tp = TensorParallel(mesh)
        self.attn_tp, self.mlp_tp, self.moe_tp, self.ssm_tp = [], [], [], []
        for sp in specs["blocks"]:
            ffn = sp.get("ffn", {})
            self.attn_tp.append("attn" in sp and self._attn_tp(sp["attn"]))
            self.mlp_tp.append(bool(ffn) and "router" not in ffn
                               and self._mlp_tp(ffn))
            self.moe_tp.append(self._moe_tp(ffn) if "router" in ffn
                               else None)
            self.ssm_tp.append("mamba" in sp and self._ssm_tp(sp["mamba"]))
        self.vocab_tp = self._split(specs["embed"], 0) and (
            "lm_head" not in specs or self._split(specs["lm_head"], -1))
        self.conv_part = conv_part(cfg, mesh, self.coords)

    def conv_whole(self, conv: torch.Tensor) -> torch.Tensor:
        """A block's conv cache ``(B, W-1, ·)`` over all its channels:
        this position's chunk (``conv_part``) all-gathered over
        ``model``, or the cache itself where it is whole."""
        if self.conv_part is None:
            return conv
        lo, hi = self.conv_part
        if conv.shape[-1] != hi - lo:
            raise ValueError(f"a conv cache of {conv.shape[-1]} channels "
                             f"where the layout holds {hi - lo}: allocate "
                             "the caches with cache_spec(..., layout=)")
        return self.tp.gather(conv, -1)

    def _split(self, spec, dim: int) -> bool:
        return self.tp.size == 1 or spec[dim] == TP_AXIS

    def _attn_tp(self, sp) -> bool:
        if self.cfg.n_kv_heads % self.tp.size:
            return False
        return all(self._split(sp[k], -1) for k in ("wq", "wk", "wv")) \
            and self._split(sp["wo"], -2)

    def _mlp_tp(self, sp, names=("w_up", "w_gate", "w_down")) -> bool:
        up, down = names[:2], names[2]
        return all(self._split(sp[k], -1) for k in up if k in sp) \
            and self._split(sp[down], -2)

    def _moe_tp(self, sp):
        experts = ("w_up", "w_gate", "w_down")
        if self.cfg.moe.n_experts % self.tp.size == 0 and all(
                self._split(sp[k], -3) for k in experts if k in sp):
            return "ep"
        return "hidden" if self._mlp_tp(sp) else None

    def _ssm_tp(self, sp) -> bool:
        s = self.cfg.ssm
        heads = s.expand * self.cfg.d_model // s.head_dim
        return heads % self.tp.size == 0 and self._split(sp["out_proj"], -2)

    # ------------------------------ use ------------------------------------

    def use(self, x: torch.Tensor, spec, model: bool = True,
            tp_whole: bool = False) -> torch.Tensor:
        """``x``'s slices gathered for use over every data axis ``spec``
        names and, with ``model``, over ``model`` too (see the module's
        docstring for the backward). ``tp_whole``: a leaf that each model
        position uses on its own part of the work inside a
        tensor-parallel region (qk-norm scales on its heads; Mamba's
        ``in_proj``, of which it takes its heads' columns): its gradient
        is summed over ``model`` too, by a reduce-scatter where the spec
        splits it over ``model`` (and ``model`` gathers it)."""
        gathers = tuple((d, spec_axes(e)) for d, e in enumerate(spec)
                        if e is not None and (model or e != TP_AXIS))
        named = spec_axes(spec)
        sums = tuple(a for a in self.mesh.axis_names
                     if a not in named and (a in self.dp or tp_whole))
        return _GatherForUse.apply(x, self.mesh, gathers, sums,
                                   self.coords.get(TP_AXIS, 0),
                                   model and tp_whole)

    def top(self, params: dict, seq: bool = False) -> dict:
        """``params`` with every leaf but the blocks gathered for use (the
        embedding and head over the data axes only with ``vocab_tp``;
        ``final_norm`` summed over ``model`` with ``seq``)."""
        split = ("embed", "lm_head") if self.vocab_tp else ()
        out = {k: map_specs(lambda s, x: self.use(
            x, s, k not in split, seq and k == "final_norm"),
            self.specs[k], v) for k, v in params.items() if k != "blocks"}
        out["blocks"] = params["blocks"]
        return out

    def _how(self, i: int, part: str, name: str, seq: bool) -> tuple:
        """``(model, tp_whole)`` for ``use`` of leaf ``name`` of sub-tree
        ``part`` at pattern position ``i`` (``seq``: the sequence split)."""
        if part in ("ln1", "ln2"):
            return True, seq
        if part == "attn" and self.attn_tp[i]:
            return False, name not in TP_SPLIT
        if part == "ffn" and self.mlp_tp[i]:
            return False, False
        if part == "ffn" and self.moe_tp[i]:
            if name.startswith("sh_") and not self._mlp_tp(
                    self.specs["blocks"][i]["ffn"],
                    ("sh_up", "sh_gate", "sh_down")):
                return True, seq           # outside the region
            return name == "router", False
        if part == "mamba" and self.ssm_tp[i]:
            return name != "out_proj", name != "out_proj"
        return True, False

    def block(self, views: list, seq: bool = False) -> list:
        """One block's views (a dict a pattern position, leading dim
        dropped) with each leaf gathered for use: over the data axes, and
        over ``model`` where the position does not use it split."""
        return [{k: {name: self.use(x, sp[k][name][1:],
                                    *self._how(i, k, name, seq))
                     for name, x in v.items()} for k, v in p.items()}
                for i, (p, sp) in enumerate(zip(views,
                                                self.specs["blocks"]))]

    # ---------------------------- reductions -------------------------------

    def dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data axes (identity backward)."""
        return _Exit.apply(x, self.mesh.group(self.dp))

    def global_norm(self, tree) -> torch.Tensor:
        """The float32 norm of a tree laid out as the parameters: each
        leaf's sum of squares over its slices, a leaf counted once however
        many positions replicate it (only the positions at index 0 on the
        axes its spec does not name add it), summed over the leaves in
        flattening order as ``optimizer.global_norm`` sums them."""
        leaves, specs = _leaves(tree), spec_leaves(self.specs)
        if len(leaves) != len(specs):
            raise ValueError(f"{len(leaves)} leaves for {len(specs)} specs")
        zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        sq = []
        for g, s in zip(leaves, specs):
            named = spec_axes(s)
            mine = all(self.coords[a] == 0 for a in self.mesh.axis_names
                       if a not in named)
            sq.append(torch.sum(g.to(torch.float32) ** 2) if mine else zero)
        sq = _all_reduce(torch.stack(sq), self.mesh.group(
            tuple(self.mesh.axis_names)))
        total = 0
        for v in sq.unbind():
            total = total + v
        return torch.sqrt(total)

    def chunk_amax(self, g: torch.Tensor, spec, chunk: int):
        """For compression: ``(amax, ids)``, the max |.| of every
        ``chunk`` consecutive values of the whole leaf flattened (the
        reference's chunks), all-reduced (max) over the mesh, and each
        local value's chunk index, shaped like ``g``."""
        sizes = dict(self.mesh.shape)
        flat = torch.zeros((), dtype=torch.int64, device=g.device)
        stride = 1
        for d in reversed(range(g.ndim)):
            axes = spec_axes(spec[d])
            i = 0
            for a in axes:
                i = i * sizes[a] + self.coords[a]
            n = g.shape[d]
            ar = (torch.arange(n, device=g.device) + i * n) * stride
            flat = flat + ar.reshape((n,) + (1,) * (g.ndim - 1 - d))
            stride *= n * math.prod(sizes[a] for a in axes)
        ids = (flat // chunk).expand(g.shape)
        amax = torch.zeros(-(-stride // chunk), dtype=torch.float32,
                           device=g.device)
        amax.scatter_reduce_(0, ids.reshape(-1),
                             g.abs().reshape(-1).to(torch.float32), "amax")
        amax = _all_reduce(amax, self.mesh.group(
            tuple(self.mesh.axis_names)), dist.ReduceOp.MAX)
        return amax, ids
