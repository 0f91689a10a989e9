"""Meshes of the training driver (port of ``repro.launch.mesh``).

``make_local_mesh`` lays a (data, model) or (pod, data, model) mesh over
the visible devices and raises when they are too few;
``make_production_mesh`` describes the reference's production meshes
(16 x 16 chips, or 2 pods of them) without devices, for the sharding
rules (``dist.sharding``), which read only ``.shape`` and
``.axis_names``. ``make_data_mesh`` is the sharded SpMV's 1-D mesh
(``dist.mesh``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.dist.mesh import make_data_mesh  # noqa: F401  (re-export)

__all__ = ["Mesh", "make_production_mesh", "make_local_mesh",
           "make_data_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of ``sizes``; ``devices`` (row-major over the axes) or
    None for a description. ``shape`` is ``{name: size}``, as a jax
    mesh's is."""

    axis_names: tuple
    sizes: tuple
    devices: Optional[tuple] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError("one size an axis")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 chips (data, model). Multi-pod: 2 pods of
    256 = 512 chips (pod, data, model); the pod axis is pure DP. A
    description: no device is named."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1, pod: int | None = None,
                    device=None) -> Mesh:
    """A (data, model) mesh, or (pod, data, model) with ``pod``, one
    device a position: the visible GPUs by default (raises without one,
    or when ``pod * data * model`` exceeds them); ``device="cpu"`` puts a
    mesh of one position on the CPU."""
    axes, sizes = (("pod", "data", "model"), (pod, data, model)) \
        if pod is not None else (("data", "model"), (data, model))
    if any(s < 1 for s in sizes):
        raise ValueError(f"mesh sizes must be >= 1, got {sizes}")
    n = math.prod(sizes)
    if device is not None and torch.device(device).type == "cpu":
        if n > 1:
            raise ValueError(f"a mesh of {n} positions needs {n} GPUs; the "
                             "CPU is one device")
        return Mesh(axes, sizes, (torch.device("cpu"),))
    if not torch.cuda.is_available():
        raise RuntimeError("a local mesh lies over the visible GPUs and "
                           "none is available; ask for device='cpu'")
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"a mesh of {n} positions needs {n} GPUs and "
                         f"{have} are visible")
    return Mesh(axes, sizes, tuple(torch.device("cuda", i)
                                   for i in range(n)))
