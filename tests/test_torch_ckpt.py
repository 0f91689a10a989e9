"""repro_torch.ckpt: tests/test_train_ft.py's checkpoint cases on the
port, and checkpoints carried across the two packages.

Both packages write the same layout (``step_%08d/leaf_%05d.npy``,
``meta.json`` with the flat key paths, ``COMMITTED``), so a checkpoint the
reference's ``CheckpointManager`` wrote restores in the port with
bit-identical leaves, and the reverse. Exact comparisons throughout.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as RefManager

from repro_torch.ckpt import CheckpointManager


def test_ckpt_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"count": torch.tensor(4, dtype=torch.int32)}}
    mgr.save(3, state, blocking=True)
    assert mgr.latest_step() == 3
    got = mgr.restore(3, state)
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    assert int(got["opt"]["count"]) == 4
    assert got["opt"]["count"].dtype == torch.int32


def test_ckpt_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, state, blocking=True)
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    assert not list(tmp_path.glob(".tmp_*"))


def test_ckpt_elastic_restore_onto_another_device(tmp_path):
    """Elastic: the saved arrays placed on the device asked for, whatever
    the template's (the meta device holds no data)."""
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": torch.arange(8.0)}
    mgr.save(0, state, blocking=True)
    template = {"w": torch.empty(8, device="meta")}
    got = mgr.restore(0, template, device="cpu")
    assert got["w"].device == torch.device("cpu")
    assert torch.equal(got["w"], state["w"])
    assert mgr.restore(0, state)["w"].device == state["w"].device


def test_save_snapshots_before_returning(tmp_path):
    """The step updates the state in place after a save returns: what is
    written is the state at save time."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.ones(1000)
    mgr.save(1, {"w": w})
    w.mul_(3)
    mgr.wait()
    assert torch.equal(mgr.restore(1, {"w": w})["w"], torch.ones(1000))


def test_bfloat16_leaf_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(0, {"w": torch.ones(3, dtype=torch.bfloat16)})


def _state_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"embed": rng.standard_normal((5, 4)).astype(np.float32),
                       "blocks": [{"attn": {"wq": rng.standard_normal(
                           (2, 4, 4)).astype(np.float32)}}]},
            "opt": {"count": np.int32(7),
                    "m": {"embed": rng.standard_normal((5, 4)).astype(
                        np.float32)}}}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_reference_checkpoint_restores_in_port(tmp_path):
    st = _state_np()
    RefManager(str(tmp_path)).save(
        5, jax.tree.map(jnp.asarray, st), blocking=True)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 5
    template = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), st)
    got = mgr.restore(5, template)
    for (k, a), (k2, b) in zip(_flat(st), _flat(got)):
        assert k == k2
        b = b.numpy()
        assert b.dtype == np.asarray(a).dtype and b.shape == np.shape(a)
        assert np.array_equal(b, a), k


def test_port_checkpoint_restores_in_reference(tmp_path):
    st = _state_np(1)
    tstate = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), st)
    CheckpointManager(str(tmp_path)).save(9, tstate, blocking=True)
    meta = json.loads((tmp_path / "step_00000009" / "meta.json").read_text())
    assert meta["step"] == 9
    assert sorted(meta["leaves"]) == sorted(k for k, _ in _flat(st))
    assert (tmp_path / "step_00000009" / "COMMITTED").exists()
    ref = RefManager(str(tmp_path))
    assert ref.latest_step() == 9
    got = ref.restore(9, jax.eval_shape(
        lambda: jax.tree.map(jnp.asarray, st)))
    for (k, a), (_, b) in zip(_flat(st), _flat(got)):
        b = np.asarray(b)
        assert b.dtype == np.asarray(a).dtype and np.array_equal(b, a), k
