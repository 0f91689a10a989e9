"""The port stands alone: ``repro_torch``, its examples
(``examples/torch_*.py``) and ``chip_smoke.py`` import neither jax nor
the reference package ``repro``, and a fresh process compiles and serves
a request on the ``torch`` backend, or dry-runs a cell, without loading
either."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and _forbidden(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"


def test_compile_in_fresh_process_never_loads_jax():
    code = """
import sys
import numpy as np
import repro_torch
from repro_torch.core.matrices import powerlaw_matrix
m = powerlaw_matrix(200, 180, 5.0, 1.2, seed=0)
plan = repro_torch.compile(m, repro_torch.Target(backend="torch"),
                           budget=repro_torch.SearchConfig(
                               max_seconds=10, max_structures=1,
                               coarse_samples=1, timing_repeats=1))
x = np.random.default_rng(0).standard_normal(m.n_cols).astype(np.float32)
y = plan(x).numpy()
o = m.spmv_dense_oracle(x)
assert np.abs(y - o).max() <= 1e-4 * np.abs(o).max()
import repro_torch.ft
from repro_torch.serve import MatvecRequest, PlanExecutor, SpmvEngine
eng = SpmvEngine(PlanExecutor(plan, m), ft=repro_torch.ft.FaultToleranceManager())
req = MatvecRequest(0, x)
assert eng.run([req])["failed"] == 0 and req.status == "ok"
assert np.abs(req.y - o).max() <= 1e-4 * np.abs(o).max()
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print("ok")
"""
    env_path = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_cli_in_fresh_process_never_loads_jax(tmp_path):
    """``python -m repro_torch.cli --demo --backend torch --no-search``
    compiles, saves, reloads, verifies and benches without loading jax or
    the reference."""
    code = """
import runpy, sys
sys.argv = ["repro_torch.cli", "--demo", "--backend", "torch",
            "--no-search", "--repeats", "2", "--out", sys.argv[1]]
try:
    runpy.run_module("repro_torch.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "demo.plan.npz")],
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "verified: round trip bit-exact" in out.stdout
    assert out.stdout.strip().endswith("ok")
    assert (tmp_path / "demo.plan.npz").is_file()


def test_training_path_in_fresh_process_never_loads_jax(tmp_path):
    """The training modules (data, optimizer, compression, step,
    sharding, meshes, checkpoints, the driver) import, train two steps on
    the CPU, and ``python -m repro_torch.launch.train --help`` runs,
    without loading jax or the reference."""
    code = """
import runpy, sys
import repro_torch.ckpt, repro_torch.data, repro_torch.dist.sharding
import repro_torch.launch.mesh, repro_torch.train
from repro_torch.launch.train import DriverConfig, TrainDriver
out = TrainDriver(DriverConfig(steps=2, batch=2, seq=16, ckpt_every=1,
                               ckpt_dir=sys.argv[1], device="cpu",
                               compression=True)).run()
assert out["n_steps_run"] == 2, out
sys.argv = ["repro_torch.launch.train", "--help"]
try:
    runpy.run_module("repro_torch.launch.train", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--fail_at_step" in out.stdout
    assert out.stdout.strip().endswith("ok")


def test_dryrun_in_fresh_process_never_loads_jax(tmp_path):
    """``python -m repro_torch.launch.dryrun`` dry-runs a cell of a full
    configuration on a production mesh without loading jax or the
    reference."""
    code = """
import runpy, sys
sys.argv = ["repro_torch.launch.dryrun", "--arch", "mamba2-1.3b",
            "--shape", "long_500k", "--mesh", "single", "--out", sys.argv[1]]
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "1 ok, 0 failed" in out.stdout
    assert out.stdout.strip().endswith("ok")
    assert (tmp_path / "mamba2-1.3b.long_500k.pod16x16.json").is_file()
