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
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

__all__ = ["CheckpointManager"]


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}" if prefix
                                else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
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
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------ save ---------------------------------

    def save(self, step: int, state, blocking: bool = False) -> None:
        # snapshot to host memory synchronously, write async
        host = {k: _host(k, v) for k, v in _flatten(state)}
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
        done = sorted(p for p in self.dir.glob("step_*")
                      if (p / "COMMITTED").exists())
        if not done:
            return None
        return int(done[-1].name.split("_")[1])

    def restore(self, step: int, template, device=None):
        """The checkpoint of ``step`` as a tree shaped like ``template``,
        its leaves tensors on ``device`` (default: each template leaf's
        device, the CPU where a leaf has none)."""
        path = self.dir / f"step_{step:08d}"
        meta = json.loads((path / "meta.json").read_text())
        flat = {k: np.load(path / fn) for k, fn in meta["leaves"].items()}

        def place(arr, like):
            dev = device if device is not None else getattr(
                like, "device", "cpu")
            return torch.from_numpy(arr).to(dev)

        return _unflatten_like(template, flat, place)
