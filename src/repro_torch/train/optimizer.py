"""AdamW with a warmup-cosine schedule and a global-norm clip (port of
``repro.train.optimizer``).

The update is the reference's formula written out op for op in float32
(``count`` int32, the bias corrections computed in float32), not
``torch.optim.AdamW``, which decays the weights in another order. The
state keeps the reference's tree, ``{"m", "v", "count"}``, with ``m`` and
``v`` shaped like the parameter tree.

Unlike the reference, which returns new arrays, ``adamw_update`` writes
the parameters, ``m`` and ``v`` in place (a 2.5 B-parameter state is
40 GB in float32, and fresh copies of it would not fit one card beside
it); each element is computed by the same operations in the same order,
so the values are the reference's either way.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_schedule",
           "tree_leaves", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), as a
    float32 scalar tensor on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists in the reference's
    flattening order (``jax.tree.leaves``: dict keys sorted)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def _map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(u[k] for u in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return [_map(fn, *(u[i] for u in trees)) for i in range(len(t))]
    return fn(*trees)


def adamw_init(params) -> dict:
    """Zero ``m`` and ``v`` (float32, like each parameter) and count 0."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    leaf = tree_leaves(params)[0]
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=leaf.device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in flattening order, of each
    leaf's float32 sum of squares."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(leaf.to(torch.float32) ** 2)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, params, state):
    """One AdamW step: returns ``(params, state, {"lr", "grad_norm"})``.
    ``params``, ``state["m"]`` and ``state["v"]`` are updated in place and
    returned; ``grads`` is read only. Every leaf is float32."""
    count = state["count"] + 1
    lr = lr_schedule(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    countf = count.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, countf)
    b2c = 1.0 - torch.pow(cfg.b2, countf)

    def upd(g, p, m, v):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))   # (c * g) * g
        step = m / b1c
        step.div_((v / b2c).sqrt_().add_(cfg.eps))
        step.add_(cfg.weight_decay * p)
        p.sub_(step.mul_(lr))

    _map(upd, grads, params, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "count": count}, \
        {"lr": lr, "grad_norm": gnorm}
