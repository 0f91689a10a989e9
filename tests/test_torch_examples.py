"""The port's five examples (``examples/torch_*.py``) run to the end on the
CPU at their shortest budgets, each within its own correctness check;
and ``ROW_REVERSE``, registered in both packages from the two
custom-operator examples, gives bit-identical Designer output and packed
arrays on the same matrix and graph."""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

# example -> (its shortest-budget arguments, the check it must pass)
RUNS = {
    "torch_quickstart": (["--seconds", "1"],
                         lambda c: c["oracle_rel_err"] <= c["tol"]
                         and c["bit_identical_load"]),
    "torch_custom_operator": (["--seconds", "1"],
                              lambda c: c["oracle_rel_err"] <= c["tol"]
                              and c["bit_identical_load"]
                              and c["structures_with_op"] > 0),
    "torch_serve_requests": ([],
                             lambda c: c["requests_served"] == c["requests"]
                             and c["sparse_linear_rel_err"] <= c["tol"]
                             and c["matvec_rel_err"] <= c["tol"]
                             and c["matvecs_ok"] == c["matvecs"]
                             and c["hot_swaps"] == 1),
    "torch_spmv_search_report": (["--seconds", "0.5"],
                                 lambda c: c["matrices"] == 9
                                 and c["oracle_rel_err"] <= c["tol"]),
    "torch_train_lm": (["--tiny", "--steps", "12"],
                       lambda c: c["steps"] == 12 and c["loss_decreased"]),
}


def _line(out: str, tag: str):
    lines = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
    assert lines, f"no {tag!r} line in:\n{out[-2000:]}"
    return json.loads(lines[-1][len(tag) + 1:])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_cpu(name, tmp_path):
    args, passes = RUNS[name]
    if name == "torch_train_lm":
        args = args + ["--ckpt", str(tmp_path / "ckpt")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2",
               TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py"),
                          *args, "--device", "cpu"], capture_output=True,
                         text=True, timeout=240, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    check = _line(out.stdout, "check")
    assert passes(check), check
    if name != "torch_train_lm":
        # the CPU runs the plain versions: nothing launches
        assert not any(_line(out.stdout, "launches").values())
        assert _line(out.stdout, "dispatch")


def test_example_refuses_without_a_gpu_unless_asked():
    """The default device is the GPU: without one the example raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable,
                          str(EXAMPLES / "torch_custom_operator.py")],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode != 0
    assert "check " not in out.stdout


def _spec(banded: bool, graph_ops, fuse: bool):
    from repro_torch.core.graph import OperatorGraph, run_graph
    from repro_torch.core.kernel_builder import plan_format
    from repro_torch.core.matrices import banded_matrix, powerlaw_matrix
    from repro_torch.core.operators import OpSpec
    m = (banded_matrix(300, 3, seed=3) if banded
         else powerlaw_matrix(300, 300, 6.0, 1.2, seed=3))
    g = OperatorGraph.chain(*(OpSpec.make(n, **p) for n, p in graph_ops))
    return plan_format(run_graph(m, g), fuse_combine=fuse, device="cpu")[1]


ROW_TILES = [("COMPRESS", {}), ("TILE_ROW_BLOCK", {"rows": 32}),
             ("LANE_ROW_BLOCK", {})]
SCATTER = ROW_TILES + [("LANE_TOTAL_RED", {"combine": "scatter"})]
SEG = [("COMPRESS", {}), ("LANE_NNZ_BLOCK", {"chunk": 64})]


# (banded: one width, rows in order; power-law: width buckets whose rows
# the combine scatters)
@pytest.mark.parametrize("banded, ops, fuse, want", [
    (False, SCATTER, False, (["K1", "rowmap_combine"],
                             ["K7", "rowmap_combine"])),
    (True, ROW_TILES + [("LANE_TOTAL_RED", {"combine": "grid_acc"})], False,
     (["K2"], ["K8"])),
    (True, SCATTER, True, (["K5"], ["K9"])),
    (False, SEG + [("SEG_SCAN_RED", {})], False,
     (["K3", "rowmap_combine"], ["K10a", "rowmap_combine"])),
    (False, SEG + [("ONEHOT_MXU_RED", {})], False,
     (["K4", "rowmap_combine"], ["K10b", "rowmap_combine"])),
    (False, SEG + [("SEG_SCAN_RED", {})], True, (["K6"], ["K11"])),
])
def test_spec_kernels_names_the_dispatched_kernels(banded, ops, fuse, want):
    """The kernels an example's ``dispatch`` line names, from its plan's
    spec, as ``run_spec_step`` dispatches them on the cuda backend."""
    from repro_torch.core.kernel_builder import spec_kernels
    spec = _spec(banded, ops, fuse)
    assert (spec_kernels(spec), spec_kernels(spec, batched=True)) == want


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def row_reverse_both():
    """Both examples imported (each registers ROW_REVERSE in its
    package's registry); unregistered afterwards so that no other test
    sees the operator in its design space."""
    from repro.design.registry import unregister_operator as ref_unregister
    from repro_torch.design.registry import unregister_operator
    ref = _load(EXAMPLES / "custom_operator.py", "_ref_custom_operator")
    port = _load(EXAMPLES / "torch_custom_operator.py",
                 "_torch_custom_operator")
    try:
        yield ref, port
    finally:
        ref_unregister("ROW_REVERSE")
        unregister_operator("ROW_REVERSE")


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_row_reverse_identical_in_both_packages(row_reverse_both):
    import repro
    from repro.core import kernel_builder as ref_kb
    from repro.core.graph import run_graph as ref_run_graph
    from repro.core.matrices import powerlaw_matrix
    from repro_torch.core import kernel_builder as kb
    from repro_torch.core.graph import run_graph
    from repro_torch.core.matrices import SparseMatrix

    m = powerlaw_matrix(384, 384, 6.0, 1.2, seed=5)     # the examples' matrix
    g_ref = repro.OperatorGraph.chain(
        repro.OpSpec.make("COMPRESS"), repro.OpSpec.make("ROW_REVERSE"),
        repro.OpSpec.make("TILE_ROW_BLOCK", rows=32),
        repro.OpSpec.make("LANE_ROW_BLOCK"),
        repro.OpSpec.make("LANE_TOTAL_RED", combine="scatter"))
    g = row_reverse_both[1].graph_with_row_reverse()
    assert g.label() == g_ref.label()
    meta_ref = ref_run_graph(m, g_ref)
    meta = run_graph(SparseMatrix(m.n_rows, m.n_cols, m.rows, m.cols,
                                  m.vals), g)
    assert meta.history == meta_ref.history
    assert len(meta.blocks) == len(meta_ref.blocks)
    for b, b_ref in zip(meta.blocks, meta_ref.blocks):
        for f in ("row_ids", "rows", "cols", "vals"):
            a, r = getattr(b, f), getattr(b_ref, f)
            assert a.dtype == r.dtype and np.array_equal(a, r), f
    fmt_r, spec_r = ref_kb.plan_format(meta_ref)
    fmt_p, spec_p = kb.plan_format(meta, device="cpu")
    assert json.dumps(spec_p) == json.dumps(spec_r)
    assert sorted(fmt_p) == sorted(fmt_r)
    for k in fmt_r:
        a, r = _bits(fmt_p[k]), _bits(fmt_r[k])
        assert a.dtype == r.dtype and a.shape == r.shape, k
        assert np.array_equal(a, r), k
