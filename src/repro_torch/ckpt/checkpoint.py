"""Checkpoints with async save and restore onto another device (port of
``repro.ckpt.checkpoint``).

The on-disk layout is the reference's, so a checkpoint written by either
package restores in the other: ``<dir>/step_<N:08d>/`` holds one
``leaf_<i:05d>.npy`` per tree leaf and ``meta.json`` (``{"step",
"leaves": {flat key path: file}}``, key paths '/'-joined, e.g.
``params/blocks/0/attn/wq``), and a ``COMMITTED`` marker; a save is
written under ``.tmp_step_<N:08d>`` and renamed, so a crash mid-write
never leaves a half checkpoint as the restore point (the contract
``ft/manager.py``'s restarts rely on). Leaves are float32 / int32
tensors (a bfloat16 leaf raises: numpy has no such type), flattened with
dict keys sorted, as the reference flattens the trees jax hands it.

``save`` copies the state to host memory before it returns (the train
step then updates the state in place) and writes on a background thread,
one save in flight at a time. ``restore(step, template, device=)`` is the
elastic restore: the saved arrays placed on any device.

On a mesh of processes (``mesh=``, with the state's spec tree passed to
``save`` and ``restore``) a checkpoint is still the reference's layout
of whole leaves: ``save`` all-gathers each leaf, rank 0 copies it to the
host and writes, and the other ranks go on (``wait`` waits for rank 0's
write on every rank). ``restore`` reads, on each rank, only the slice
its coordinates hold (memory-mapped), so a checkpoint restores onto any
mesh, one device or the reference's ``CheckpointManager``, and theirs
onto any mesh. ``latest_step`` is rank 0's answer on every rank, so that
a restart restores every rank from the same step.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.collectives import gather_leaf
from repro_torch.dist.sharding import shard_leaf

__all__ = ["CheckpointManager"]


def _flatten(tree, prefix="", seqs=(list, tuple)):
    """(key path, leaf) in flattening order; ``seqs``: the sequence types
    that are containers (a spec tree's tuples are leaves)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}" if prefix
                                else str(k), seqs)
    elif isinstance(tree, seqs):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}", seqs)
    else:
        yield prefix, tree


def _unflatten_like(template, flat: dict, leaf_fn, prefix=""):
    """``template``'s tree with leaf ``leaf_fn(flat[path], template
    leaf)`` at each key path."""
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, leaf_fn,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_unflatten_like(v, flat, leaf_fn, f"{prefix}/{i}")
                for i, v in enumerate(template)]
    return leaf_fn(flat[prefix], template)


def _host(key: str, leaf) -> np.ndarray:
    """A host copy of one leaf (never a view of a tensor the next step
    writes)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint leaf {key!r} is bfloat16; keep "
                            "state leaves float32 or int32")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, mesh=None):
        self.dir = Path(directory)
        self.mesh = mesh if getattr(mesh, "distributed", False) else None
        self.writer = self.mesh is None or self.mesh.rank == 0
        if self.writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def _specs(self, specs) -> dict:
        if specs is None:
            raise ValueError("a checkpoint of a sharded state needs the "
                             "state's spec tree (specs=)")
        return dict(_flatten(specs, seqs=list))

    # ------------------------------ save ---------------------------------

    def save(self, step: int, state, blocking: bool = False,
             specs=None) -> None:
        # snapshot to host memory synchronously, write async
        if self.mesh is None:
            host = {k: _host(k, v) for k, v in _flatten(state)}
        else:
            sp = self._specs(specs)
            host = {}
            for k, v in _flatten(state):
                full = gather_leaf(v, sp[k], self.mesh)
                if self.writer:
                    host[k] = _host(k, full)
                del full
        if self.writer:
            if self._thread is not None:
                self._thread.join()  # one in-flight save at a time
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None:
            dist.barrier(group=self.mesh.group(tuple(self.mesh.axis_names)))

    def _write(self, step: int, host: dict) -> None:
        path = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        index = {}
        for i, (key, arr) in enumerate(host.items()):
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, arr)
            index[key] = fname
        (tmp / "meta.json").write_text(json.dumps(
            {"step": step, "leaves": index}))
        (tmp / "COMMITTED").touch()
        if path.exists():
            shutil.rmtree(path)
        tmp.rename(path)
        self._gc()

    def _gc(self):
        done = sorted(p for p in self.dir.glob("step_*")
                      if (p / "COMMITTED").exists())
        for p in done[: -self.keep]:
            shutil.rmtree(p)

    # ----------------------------- restore --------------------------------

    def latest_step(self) -> Optional[int]:
        step = -1
        if self.writer:
            done = sorted(p for p in self.dir.glob("step_*")
                          if (p / "COMMITTED").exists())
            step = int(done[-1].name.split("_")[1]) if done else -1
        if self.mesh is not None:                # rank 0's, on every rank
            t = torch.tensor([step], dtype=torch.int64,
                             device=self.mesh.device)
            dist.broadcast(t, src=0, group=self.mesh.group(
                tuple(self.mesh.axis_names)))
            step = int(t.item())
        return None if step < 0 else step

    def restore(self, step: int, template, device=None, specs=None):
        """The checkpoint of ``step`` as a tree shaped like ``template``,
        its leaves tensors on ``device`` (default: each template leaf's
        device, the CPU where a leaf has none). On a mesh of processes
        each leaf is this rank's slice under ``specs``, read from the
        whole leaf on disk."""
        path = self.dir / f"step_{step:08d}"
        if self.mesh is not None:
            self.wait()                          # rank 0's write is done
            sp = self._specs(specs)
            coords = self.mesh.coords
        meta = json.loads((path / "meta.json").read_text())
        flat = {}
        for k, fn in meta["leaves"].items():
            if self.mesh is None:
                flat[k] = np.load(path / fn)
            else:
                flat[k] = np.array(shard_leaf(np.load(
                    path / fn, mmap_mode="r"), sp[k], self.mesh, coords))

        def place(arr, like):
            dev = device if device is not None else getattr(
                like, "device", "cpu")
            return torch.from_numpy(arr).to(dev)

        return _unflatten_like(template, flat, place)
