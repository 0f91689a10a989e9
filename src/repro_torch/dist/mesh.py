"""The device mesh of the sharded plans.

The counterpart of ``jax.make_mesh((n,), ("data",))`` and
``repro.launch.mesh.make_data_mesh``: a 1-D ``("data",)`` axis whose
shards each name one explicit ``torch.device``. The reference runs one
program over its mesh (single controller); the port does the same in one
process, placing each shard's operands and kernel launches on that
shard's device. Several shards may share one device, which is how a
machine with one GPU runs a sharded plan (and how the tests run one on
the CPU), as the reference's ``--xla_force_host_platform_device_count``
fakes several devices on one host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["DataMesh", "make_data_mesh"]


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """``devices[i]`` runs shard i. ``shape`` is ``{"data": n}``, as a
    jax mesh's ``shape`` is."""

    devices: tuple
    axis_names: tuple = ("data",)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len(self.axis_names) != 1:
            raise ValueError("a DataMesh has exactly one axis")

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def shared_device(self) -> Optional[torch.device]:
        """The one device every shard runs on, or None when the shards
        sit on several devices."""
        first = self.devices[0]
        return first if all(d == first for d in self.devices) else None


def _cuda_device(index: Optional[int]) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA mesh needs a GPU and none is available; build a CPU "
            "mesh explicitly with make_data_mesh(n, device='cpu')")
    return torch.device("cuda", torch.cuda.current_device()
                        if index is None else index)


def make_data_mesh(data: Optional[int] = None, device=None) -> DataMesh:
    """A 1-D ``("data",)`` mesh of ``data`` shards.

    By default one shard on each visible GPU (``data`` defaults to their
    count, and may not exceed it). With ``device`` (``"cuda:0"``,
    ``"cpu"``, a ``torch.device``) all ``data`` shards (default 1) run on
    that one device. Raises when there is no GPU, unless the caller names
    ``device="cpu"``."""
    if data is not None and data < 1:
        raise ValueError(f"data must be >= 1, got {data}")
    if device is None:
        _cuda_device(None)
        n_gpu = torch.cuda.device_count()
        data = n_gpu if data is None else data
        if data > n_gpu:
            raise ValueError(
                f"{data} shards need {data} GPUs and {n_gpu} are visible; "
                "to place several shards on one card, name it: "
                "make_data_mesh(n, device='cuda:0')")
        return DataMesh(tuple(torch.device("cuda", i) for i in range(data)))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = _cuda_device(dev.index)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported mesh device {dev} (cuda | cpu)")
    return DataMesh((dev,) * (data or 1))
