"""Config+mesh-driven sharding rules (MaxText-style logical axis rules;
port of ``repro.dist.sharding``).

A spec is a tuple with one entry a tensor dim: None (replicated), a mesh
axis name, or a tuple of two or more names, where the reference has a
``jax.sharding.PartitionSpec`` of the same entries (``spec`` writes them
as a PartitionSpec canonicalises them: a group of one axis as its name,
an empty group as None). The rules are pure
functions of an ``ArchConfig`` and a mesh's ``.shape`` and
``.axis_names``. On a mesh of processes (``launch.mesh.make_local_mesh``
inside a process group) each process holds, of every state leaf, the
slice that the leaf's spec gives its mesh coordinates (``shard_leaf``):
a dim of entry ``a`` is cut into ``mesh.shape[a]`` equal parts, a dim of
a group ``(a, b)`` into ``size(a) * size(b)`` parts taken row-major over
the group, as jax lays out a ``NamedSharding``. ``unshard_leaf`` puts
the slices back together.

One ``ShardingRules`` object per (ArchConfig, mesh) pair decides, for every
parameter / batch / cache leaf, which mesh axes shard which tensor dims:

* ``model``            — tensor parallelism (TP) for weight output dims and
                         expert parallelism (EP) for divisible expert dims.
* every other axis     — data parallelism; weights use them as FSDP axes.

Fallback ladder (the "divisibility fallbacks" contract of
the reference's sharding tests):

1. a dim only takes an axis group whose total size divides it; otherwise
   the group is shrunk (outermost axis dropped first) and finally dropped,
2. MoE expert dims that don't divide the ``model`` axis fall back to
   tensor-parallel sharding of the expert *hidden* dim instead,
3. tiny global batches degrade toward replication the same way (axes are
   dropped until the batch divides),
4. norm scales / biases and other per-channel vectors replicate.

The mesh only needs ``.shape`` (dict-like name->size) and ``.axis_names``:
unit tests drive these rules with a mock mesh, no devices required.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ArchConfig

__all__ = ["ShardingRules", "dp_axes", "param_specs", "batch_specs",
           "cache_specs", "spec", "spec_axes", "spec_leaves", "map_specs",
           "mesh_coords", "mesh_positions", "shard_slices", "shard_leaf",
           "unshard_leaf", "shard_batch", "shard_serve", "conv_part",
           "expert_range", "head_range", "vocab_range"]

TP_AXIS = "model"

# Parameter leaves that always replicate: per-channel vectors (norm scales,
# biases, SSM per-head constants). Keyed on the last path component.
_REPLICATED_NAMES = frozenset({
    "scale", "bias", "q_norm", "k_norm", "gate_norm",
    "A_log", "dt_bias", "D", "conv_b",
})

# name -> roles of the *trailing* dims (leading stacked-layer dims get None).
# Roles: 'fsdp' = shard over the data axes, 'tp' = shard over 'model',
# None = replicate. MoE tables are selected dynamically in _leaf_spec.
_ROLE_TABLE = {
    "embed": ("tp", "fsdp"),          # (vocab, d_model)
    "lm_head": ("fsdp", "tp"),        # (d_model, vocab)
    "wq": ("fsdp", "tp"),             # column-parallel projections
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),             # row-parallel output projection
    "w_up": ("fsdp", "tp"),           # dense MLP (MoE handled separately)
    "w_gate": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    "sh_up": ("fsdp", "tp"),          # MoE shared experts are dense MLPs
    "sh_gate": ("fsdp", "tp"),
    "sh_down": ("tp", "fsdp"),
    "router": ("fsdp", None),         # (d_model, E): E is tiny, replicate
    "in_proj": ("fsdp", "tp"),        # mamba projections
    "out_proj": ("tp", "fsdp"),
    "conv_w": ("tp", None),           # (conv_ch, width)
}

# MoE expert tensors, by trailing-dim layout. 'ep' = expert parallelism on
# the model axis; the fallback table moves TP onto the expert hidden dim.
_MOE_EP = {
    "w_up": ("ep", "fsdp", None),     # (E, d_model, d_expert)
    "w_gate": ("ep", "fsdp", None),
    "w_down": ("ep", None, "fsdp"),   # (E, d_expert, d_model)
}
_MOE_HIDDEN_TP = {
    "w_up": (None, "fsdp", "tp"),
    "w_gate": (None, "fsdp", "tp"),
    "w_down": (None, "tp", "fsdp"),
}


def spec(*entries) -> tuple:
    """A spec from per-dim entries, canonical as a PartitionSpec's: a
    one-axis group becomes its name and an empty group None."""
    def one(e):
        if isinstance(e, (list, tuple)):
            return None if not e else (e[0] if len(e) == 1 else tuple(e))
        return e
    return tuple(one(e) for e in entries)


def dp_axes(mesh) -> tuple[str, ...]:
    """All data-parallel mesh axes, outermost first (everything but TP)."""
    return tuple(a for a in mesh.axis_names if a != TP_AXIS)


def _shrink_to_divisible(axes: tuple[str, ...], sizes: dict,
                         dim: int) -> tuple[str, ...]:
    """Largest suffix of ``axes`` whose total size divides ``dim``."""
    axes = tuple(axes)
    while axes and dim % int(np.prod([sizes[a] for a in axes])) != 0:
        axes = axes[1:]               # drop the outermost (e.g. 'pod') first
    return axes


class ShardingRules:
    """Resolved sharding rules for one (config, mesh) pair."""

    def __init__(self, cfg: ArchConfig, mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.axis_sizes = dict(mesh.shape)
        self.tp_axis = TP_AXIS if TP_AXIS in mesh.axis_names else None
        self.fsdp_axes = dp_axes(mesh)

    @property
    def tp_size(self) -> int:
        return self.axis_sizes.get(self.tp_axis, 1) if self.tp_axis else 1

    def _entry(self, role, dim: int):
        """Map one (role, dim) to a spec entry, or None."""
        if role == "fsdp" and self.fsdp_axes:
            axes = _shrink_to_divisible(self.fsdp_axes, self.axis_sizes, dim)
            return axes if axes else None
        if role in ("tp", "ep") and self.tp_axis and self.tp_size > 1 \
                and dim % self.tp_size == 0:
            return self.tp_axis
        return None

    def resolve(self, roles, shape) -> tuple:
        """Apply trailing-dim roles; leading (stacked-layer) dims replicate."""
        lead = max(0, len(shape) - len(roles))
        entries = [None] * lead
        used = set()
        for dim, role in zip(shape[lead:], roles):
            e = self._entry(role, dim)
            # one mesh axis may shard at most one dim of a tensor
            flat = e if isinstance(e, tuple) else (e,)
            if e is not None and not used.intersection(flat):
                entries.append(e)
                used.update(flat)
            else:
                entries.append(None)
        return spec(*entries)


def _leaf_spec(rules: ShardingRules, path: str, shape) -> tuple:
    """The spec of one parameter leaf.

    ``path`` is the '/'-joined pytree path ('blocks/0/attn/wq'); ``shape``
    is a dim tuple or anything with a ``.shape`` attribute.
    """
    if hasattr(shape, "shape"):
        shape = shape.shape
    shape = tuple(int(d) for d in shape)
    name = path.split("/")[-1]

    if name in _REPLICATED_NAMES:
        return (None,) * len(shape)

    is_moe = ("ffn" in path.split("/") and name in _MOE_EP
              and rules.cfg.moe is not None
              and len(shape) >= len(_MOE_EP[name]))
    if is_moe:
        lead = len(shape) - len(_MOE_EP[name])
        n_experts = shape[lead]
        if rules.tp_axis and rules.tp_size > 1 \
                and n_experts % rules.tp_size == 0:
            return rules.resolve(_MOE_EP[name], shape)
        # non-divisible expert count: hidden-dim TP instead of EP
        return rules.resolve(_MOE_HIDDEN_TP[name], shape)

    roles = _ROLE_TABLE.get(name)
    if roles is None or len(shape) < len(roles):
        return (None,) * len(shape)
    return rules.resolve(roles, shape)


def _map_with_path(fn, tree, path=""):
    """``fn(path, leaf)`` over a tree of dicts and lists, ``path`` the
    '/'-joined keys and indices ('blocks/0/attn/wq')."""
    join = lambda k: f"{path}/{k}" if path else str(k)  # noqa: E731
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, join(i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(cfg: ArchConfig, mesh, params):
    """A spec tree matching a parameter tree (leaves: anything with a
    ``.shape``)."""
    rules = ShardingRules(cfg, mesh)
    return _map_with_path(
        lambda p, leaf: _leaf_spec(rules, p, leaf.shape), params)


def _batch_axes(mesh, global_batch=None) -> tuple[str, ...]:
    axes = dp_axes(mesh)
    if global_batch is not None:
        axes = _shrink_to_divisible(axes, dict(mesh.shape), int(global_batch))
    return axes


def batch_specs(cfg: ArchConfig, mesh, global_batch=None) -> dict:
    """Specs for the input batch. Tiny batches drop dp axes (outermost
    first) until the batch divides — degrading to full replication."""
    dp = _batch_axes(mesh, global_batch)
    specs = {"tokens": spec(dp, None), "labels": spec(dp, None)}
    if cfg.n_prefix:
        specs["prefix_embeds"] = spec(dp, None, None)
    return specs


# decode-cache leaves, keyed by name: which trailing dim takes the TP axis.
# Layouts (leading (n_blocks, B) handled positionally):
#   k/v:  (nb, B, S, KV, hd)  -> KV heads on 'model'
#   conv: (nb, B, W-1, ch)    -> conv channels on 'model'
#   ssm:  (nb, B, H, P, N)    -> state heads on 'model'
_CACHE_TP_DIM = {"k": 3, "v": 3, "conv": 3, "ssm": 2}


def cache_specs(cfg: ArchConfig, mesh, caches):
    """Specs for a decode-cache tree (see ``models.model.cache_spec``)."""
    rules = ShardingRules(cfg, mesh)
    dp = dp_axes(mesh)

    def spec_one(path, leaf):
        shape = tuple(int(d) for d in leaf.shape)
        name = path.split("/")[-1]
        entries = [None] * len(shape)
        if len(shape) >= 2:
            axes = _shrink_to_divisible(dp, rules.axis_sizes, shape[1])
            entries[1] = axes if axes else None   # batch dim
        td = _CACHE_TP_DIM.get(name)
        if td is not None and td < len(shape):
            entries[td] = rules._entry("tp", shape[td])
        return spec(*entries)

    return _map_with_path(spec_one, caches)


def conv_part(cfg: ArchConfig, mesh, coords: dict):
    """``(lo, hi)``: the channels of Mamba's conv cache ``(nb, B, W-1,
    ch)`` that the position at ``coords`` holds, where ``cache_specs``
    cuts them into contiguous chunks over ``model`` (as ``conv_w`` is
    cut); None where it holds every channel (no split, or no Mamba)."""
    if cfg.ssm is None:
        return None
    from repro_torch.models.ssm import _dims
    shape = (1, 1, 1, _dims(cfg)[4])
    sp = cache_specs(cfg, mesh, {"conv": np.broadcast_to(np.int8(0),
                                                         shape)})["conv"]
    if sp[3] is None:
        return None
    sl = shard_slices(shape, sp, mesh, coords)[3]
    return sl.start, sl.stop


# ------------------------- slices of a sharded leaf -------------------------

def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry (or of a whole spec), in order."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(a for e in entry for a in spec_axes(e))


def spec_leaves(specs) -> list:
    """The specs of a spec tree in the order ``optimizer.tree_leaves``
    gives the leaves of the tree it describes (dict keys sorted; a spec
    is a tuple, a list is a container)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


def map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k], *(t[k] for t in trees))
                for k in specs}
    if isinstance(specs, list):
        return [map_specs(fn, s, *(t[i] for t in trees))
                for i, s in enumerate(specs)]
    return fn(specs, *trees)


def mesh_coords(mesh, rank: int) -> dict:
    """{axis: index} of position ``rank``, row-major over the axes."""
    out = {}
    for name in reversed(tuple(mesh.axis_names)):
        size = int(mesh.shape[name])
        out[name] = rank % size
        rank //= size
    return {a: out[a] for a in mesh.axis_names}


def mesh_positions(mesh) -> list[dict]:
    """The coordinates of every position, in rank order."""
    n = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    return [mesh_coords(mesh, r) for r in range(n)]


def shard_slices(shape, spec_, mesh, coords: dict) -> tuple:
    """One ``slice`` a dim: the part of a leaf of global ``shape`` that
    the position at ``coords`` holds under ``spec_``."""
    sizes = dict(mesh.shape)
    out = []
    for d, (dim, entry) in enumerate(zip(shape, spec_)):
        axes = spec_axes(entry)
        n = int(np.prod([sizes[a] for a in axes]))
        if dim % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {axes} ({n} parts)")
        i = 0
        for a in axes:
            i = i * sizes[a] + coords[a]
        step = dim // n
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def shard_leaf(full, spec_, mesh, coords: dict):
    """The slice of ``full`` (a tensor or a numpy array) at ``coords``, a
    contiguous array of its own where it is not the whole leaf."""
    part = full[shard_slices(full.shape, spec_, mesh, coords)]
    if isinstance(full, np.ndarray):
        return np.ascontiguousarray(part)
    return part.contiguous()


def unshard_leaf(shards: dict, spec_, mesh):
    """The whole leaf from ``{coordinates: slice}``, the coordinates a
    tuple in the mesh's axis order, every position present; positions
    that hold the same slice (a replicated axis) must agree."""
    sizes = dict(mesh.shape)
    first = next(iter(shards.values()))
    shape = tuple(int(s) * int(np.prod([sizes[a] for a in spec_axes(e)]))
                  for s, e in zip(first.shape, spec_))
    is_np = isinstance(first, np.ndarray)
    if is_np:
        full = np.empty(shape, first.dtype)
    else:
        import torch
        full = torch.empty(shape, dtype=first.dtype, device=first.device)
    seen = {}
    for pos in mesh_positions(mesh):
        part = shards[tuple(pos[a] for a in mesh.axis_names)]
        sl = shard_slices(shape, spec_, mesh, pos)
        key = tuple((s.start, s.stop) for s in sl)
        if key in seen:
            same = (np.array_equal(seen[key], part) if is_np
                    else bool((seen[key] == part).all()))
            if not same:
                raise ValueError(f"the replicas of slice {key} differ")
            continue
        seen[key] = part
        full[sl] = part
    return full


def shard_batch(batch: dict, cfg: ArchConfig, mesh, coords: dict) -> dict:
    """The rows of a global batch that the position at ``coords`` trains
    on (``batch_specs``: the batch dim over the data axes, the same rows
    for every position of the ``model`` axis). Raises when the batch does
    not split over every data axis: a replicated batch would count its
    tokens once a replica in the data-parallel sums."""
    gb = int(np.shape(batch["tokens"])[0])
    specs = batch_specs(cfg, mesh, gb)
    if spec_axes(specs["tokens"][0]) != dp_axes(mesh):
        n = int(np.prod([mesh.shape[a] for a in dp_axes(mesh)]))
        raise ValueError(f"a global batch of {gb} rows does not split "
                         f"over the data axes' {n} positions")
    return {k: v[shard_slices(np.shape(v), specs[k], mesh, coords)]
            for k, v in batch.items()}


def shard_serve(inputs: dict, cfg: ArchConfig, mesh, coords: dict) -> dict:
    """A serving call's global inputs -> those of the position at
    ``coords``: the rows (``batch_specs``' split of the batch, the rule
    ``cache_specs`` applies to the caches' batch dim) of ``tokens`` /
    ``token`` (and ``prefix_embeds``) and of a per-row ``pos``; a scalar
    ``pos`` as it is; ``rows`` (global row indices) those in the
    position's range, as its own indices. A batch that does not split
    over every data axis is replicated over the others: serving sums
    nothing over the batch."""
    key = "tokens" if "tokens" in inputs else "token"
    gb = int(np.shape(inputs[key])[0])
    sl = shard_slices((gb,), batch_specs(cfg, mesh, gb)["tokens"][:1], mesh,
                      coords)[0]
    out = {}
    for k, v in inputs.items():
        if k == "rows" and v is not None:
            v = v[(v >= sl.start) & (v < sl.stop)] - sl.start
        elif k not in ("pos", "rows") or np.ndim(v) == 1:
            v = v[sl]
        out[k] = v
    return out


# --------------------- a model position's part of a layer --------------------

def _model_part(n: int, mesh, coords: dict) -> tuple[int, int]:
    """``[start, stop)`` of ``n`` items that the position at ``coords``
    holds when they split over ``model`` (``ShardingRules._entry``'s
    rule: the model axis has more than one position and divides ``n``),
    else all ``n``: a model axis of one holds them all."""
    tp = int(dict(mesh.shape).get(TP_AXIS, 1))
    if tp == 1 or n % tp:
        return 0, n
    i = int(coords.get(TP_AXIS, 0))
    return i * (n // tp), (i + 1) * (n // tp)


def expert_range(cfg: ArchConfig, mesh, coords: dict) -> tuple[int, int]:
    """The MoE experts the position at ``coords`` runs: its
    ``n_experts / model`` under expert parallelism (``_MOE_EP``), all of
    them where the count does not divide and the reference falls back to
    splitting the expert hidden dim (``_MOE_HIDDEN_TP``)."""
    return _model_part(cfg.moe.n_experts, mesh, coords)


def head_range(cfg: ArchConfig, mesh, coords: dict) -> tuple[int, int]:
    """The Mamba SSD heads the position at ``coords`` runs: its
    ``heads / model`` (``out_proj``'s rows over ``model`` then fall on
    head boundaries), all of them where the head count does not divide."""
    s = cfg.ssm
    return _model_part(s.expand * cfg.d_model // s.head_dim, mesh, coords)


def vocab_range(cfg: ArchConfig, mesh, coords: dict) -> tuple[int, int]:
    """The rows of the padded vocabulary (the embedding's rows, the
    head's columns) that the position at ``coords`` holds: its
    ``V_pad / model``, all of them where that does not divide."""
    from repro_torch.models.model import padded_vocab
    return _model_part(padded_vocab(cfg), mesh, coords)
