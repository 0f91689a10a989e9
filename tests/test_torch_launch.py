"""repro_torch.launch.train: the reference's two driver tests
(tests/test_train_ft.py's end-to-end restart loop) held on the port with
``device="cpu"``, plus what the port adds: a run interrupted by
``fail_at_step`` ends with the parameters of an uninterrupted run, bit
for bit (the pipeline is keyed by step, checkpoints are exact and the
CPU's arithmetic repeats), and the driver refuses what it cannot do."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.train import DriverConfig, TrainDriver, main
from repro_torch.train.optimizer import tree_leaves

ROOT = Path(__file__).resolve().parents[1]


def _dc(tmp_path, **kw):
    base = dict(arch="granite-3-2b", reduced=True, steps=8, batch=2,
                seq=32, ckpt_dir=str(tmp_path), ckpt_every=3,
                log_every=100, device="cpu")
    base.update(kw)
    return DriverConfig(**base)


def test_train_driver_failure_restart(tmp_path):
    out = TrainDriver(_dc(tmp_path, fail_at_step=5)).run()
    assert out["restarts"] == 1
    assert out["n_steps_run"] >= 8          # replayed steps after restore
    assert np.isfinite(out["final_loss"])


def test_train_driver_compression_runs(tmp_path):
    drv = TrainDriver(_dc(tmp_path, steps=3, ckpt_every=0,
                          compression=True))
    out = drv.run()
    assert np.isfinite(out["final_loss"])
    assert "err" in drv.state
    for part in ("params", "err"):
        assert all(t.dtype == torch.float32
                   for t in tree_leaves(drv.state[part]))


def test_interrupted_run_ends_bit_identical(tmp_path):
    a = TrainDriver(_dc(tmp_path / "a", fail_at_step=7))
    out_a = a.run()
    b = TrainDriver(_dc(tmp_path / "b"))
    out_b = b.run()
    assert out_a["restarts"] == 1 and out_b["restarts"] == 0
    # the restart replays from the last committed checkpoint (step 6, or
    # step 3 while step 6's save is still in flight, as in the reference)
    assert out_a["n_steps_run"] in (8, 11) and out_b["n_steps_run"] == 8
    assert out_a["final_loss"] == out_b["final_loss"]
    for x, y in zip(tree_leaves(a.state), tree_leaves(b.state)):
        assert torch.equal(x, y)


def test_restart_without_checkpoint_rebuilds(tmp_path):
    out = TrainDriver(_dc(tmp_path, steps=4, ckpt_every=0,
                          fail_at_step=2)).run()
    assert out["restarts"] == 1 and out["n_steps_run"] == 6


def test_a_finished_run_resumes_from_its_checkpoint(tmp_path):
    TrainDriver(_dc(tmp_path, steps=4)).run()
    out = TrainDriver(_dc(tmp_path, steps=6)).run()
    assert out["n_steps_run"] == 2          # steps 4 and 5


def test_default_device_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainDriver(_dc(tmp_path, device=None))


def test_a_mesh_beyond_one_device_is_refused(tmp_path):
    with pytest.raises(ValueError):
        TrainDriver(_dc(tmp_path, data_mesh=2))
    with pytest.raises(ValueError):
        TrainDriver(_dc(tmp_path, model_mesh=2))


def test_main_trains_on_the_cpu(tmp_path, capsys):
    main(["--arch", "granite-3-2b", "--steps", "2", "--batch", "2",
          "--seq", "16", "--ckpt_dir", str(tmp_path), "--device", "cpu",
          "--log_every", "1"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "'restarts': 0" in out


def test_module_help_in_fresh_process():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--help"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    for flag in ("--arch", "--fail_at_step", "--compression", "--device"):
        assert flag in proc.stdout
