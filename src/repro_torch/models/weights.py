"""Weights and caches carried between numpy trees and the port's tensors.

A parameter tree is nested dicts with a ``blocks`` list, as the
reference's ``init_params`` returns it (its leaves as numpy arrays, e.g.
``jax.tree.map(np.asarray, params)``); caches are a list of dicts, one a
pattern position. These helpers move such trees to tensors on a device and
back, so both packages can compute on the same weights. A bfloat16 leaf
(numpy's ``bfloat16`` from ``ml_dtypes``) keeps its bits going in; coming
out it is widened to float32, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from .model import cast_params, tree_map

__all__ = ["params_from_numpy", "params_to_numpy", "caches_from_numpy",
           "caches_to_numpy", "to_tensor", "to_numpy"]


def to_tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:           # e.g. np.asarray of a jax array
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_numpy(tree, device, dtype=None) -> dict:
    """The reference's parameter tree (numpy leaves) as the port's tensors
    on ``device``; with ``dtype``, the leaves the reference casts at each
    use are cast once to it (``model.cast_params``)."""
    params = tree_map(lambda a: to_tensor(a, device), tree)
    return cast_params(params, dtype) if dtype is not None else params


def params_to_numpy(params) -> dict:
    return tree_map(to_numpy, params)


def caches_from_numpy(caches, device) -> list[dict]:
    return tree_map(lambda a: to_tensor(a, device), caches)


def caches_to_numpy(caches) -> list[dict]:
    return tree_map(to_numpy, caches)
