"""Meshes of the training driver (port of ``repro.launch.mesh``).

``make_local_mesh`` lays a (data, model) or (pod, data, model) mesh over
an initialised process group, one process a position (a torch
``DeviceMesh`` with the reference's axis names, and a process group for
each axis, each run of data axes and the whole mesh; NCCL on the GPU,
gloo on the CPU); outside a group it lays a mesh over the visible
devices and raises when they are too few, and on the CPU it gives a mesh
of one position only;
``make_production_mesh`` describes the reference's production meshes
(16 x 16 chips, or 2 pods of them) without devices, for the sharding
rules (``dist.sharding``), which read only ``.shape`` and
``.axis_names``. ``make_data_mesh`` is the sharded SpMV's 1-D mesh
(``dist.mesh``).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch

from repro_torch.dist.mesh import make_data_mesh  # noqa: F401  (re-export)
from repro_torch.dist.sharding import TP_AXIS, mesh_coords

__all__ = ["Mesh", "make_production_mesh", "make_local_mesh",
           "make_data_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of ``sizes``; ``devices`` (row-major over the axes) or
    None for a description. ``shape`` is ``{name: size}``, as a jax
    mesh's is.

    A mesh of processes (``distributed``) also has this process's
    ``rank`` and ``device``, its ``device_mesh`` and the process groups
    of ``group(axes)``."""

    axis_names: tuple
    sizes: tuple
    devices: Optional[tuple] = None
    rank: Optional[int] = None
    device: Optional[torch.device] = None
    device_mesh: object = dataclasses.field(default=None, compare=False,
                                            repr=False)
    groups: Optional[dict] = dataclasses.field(default=None, compare=False,
                                               repr=False)

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

    @property
    def distributed(self) -> bool:
        return self.groups is not None

    @property
    def coords(self) -> dict:
        """{axis: index} of this process's position."""
        return mesh_coords(self, self.rank)

    def group(self, axes):
        """The process group of this process's positions along ``axes``
        (an axis name or a tuple of them, in the mesh's order), its ranks
        row-major over those axes."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        try:
            return self.groups[axes]
        except KeyError:
            raise KeyError(f"no process group over {axes} on a mesh of "
                           f"{self.axis_names}") from None


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 chips (data, model). Multi-pod: 2 pods of
    256 = 512 chips (pod, data, model); the pod axis is pure DP. A
    description: no device is named."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1, pod: int | None = None,
                    device=None) -> Mesh:
    """A (data, model) mesh, or (pod, data, model) with ``pod``.

    Inside an initialised process group of ``pod * data * model``
    processes: a mesh of processes, rank r at position r (row-major),
    computing on ``cuda:LOCAL_RANK`` (``device`` None, the GPU) or on the
    CPU (``device="cpu"``). Outside one: one device a position, the
    visible GPUs by default (raises without one, or when the positions
    exceed them); ``device="cpu"`` puts a mesh of one position on the
    CPU and refuses more."""
    axes, sizes = (("pod", "data", "model"), (pod, data, model)) \
        if pod is not None else (("data", "model"), (data, model))
    if any(s < 1 for s in sizes):
        raise ValueError(f"mesh sizes must be >= 1, got {sizes}")
    n = math.prod(sizes)
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return _process_mesh(axes, sizes, device)
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


def _process_mesh(axes: tuple, sizes: tuple, device) -> Mesh:
    """The mesh over the initialised process group (see
    ``make_local_mesh``). Every process creates the same groups in the
    same order: one an axis (the ``DeviceMesh``'s), one a run of two or
    more data axes (the suffixes that ``dist.sharding``'s divisibility
    fallback may give a dim), and the whole mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n, world = math.prod(sizes), dist.get_world_size()
    if world != n:
        raise ValueError(f"a mesh of {n} positions {dict(zip(axes, sizes))} "
                         f"in a process group of {world}: one process a "
                         "position")
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh of processes computes on the GPUs by "
                               "default and none is available; ask for "
                               "device='cpu'")
        dev = torch.device(device) if device is not None else \
            torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dm = init_device_mesh(dev.type, sizes, mesh_dim_names=axes)
    groups = {(a,): dm.get_group(a) for a in axes}
    shape = dict(zip(axes, sizes))
    dp = tuple(a for a in axes if a != TP_AXIS)
    for k in range(2, len(dp) + 1):
        groups[dp[-k:]] = _coset_group(axes, shape, dp[-k:])
    groups[axes] = dist.group.WORLD
    return Mesh(axes, sizes, rank=dist.get_rank(), device=dev,
                device_mesh=dm, groups=groups)


def _coset_group(axes: tuple, shape: dict, sub: tuple):
    """This process's group along the axes ``sub``: every process makes
    the groups of all cosets, ranks ascending (row-major over ``sub``)."""
    import torch.distributed as dist
    probe = Mesh(axes, tuple(shape[a] for a in axes))
    cosets = {}
    for r in range(probe.size):
        c = mesh_coords(probe, r)
        cosets.setdefault(tuple(c[a] for a in axes if a not in sub),
                          []).append(r)
    mine, _ = dist.new_subgroups_by_enumeration(list(cosets.values()))
    return mine
