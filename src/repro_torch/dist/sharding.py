"""Config+mesh-driven sharding rules (MaxText-style logical axis rules;
port of ``repro.dist.sharding``).

A spec is a tuple with one entry a tensor dim: None (replicated), a mesh
axis name, or a tuple of two or more names, where the reference has a
``jax.sharding.PartitionSpec`` of the same entries (``spec`` writes them
as a PartitionSpec canonicalises them: a group of one axis as its name,
an empty group as None). The rules are pure
functions of an ``ArchConfig`` and a mesh's ``.shape`` and
``.axis_names``; on one card nothing is sharded, and the specs describe
the layout a mesh of many devices would give the state.

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
           "cache_specs", "spec"]

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
