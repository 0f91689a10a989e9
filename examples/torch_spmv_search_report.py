"""AlphaSparse as a library generator on PyTorch/CUDA (``repro_torch``,
the port of ``spmv_search_report.py``): search several matrices and emit
a per-matrix design report (the paper's §VII-G analysis on your own
data), each plan held to the float64 oracle. Runs on the GPU by default;
``--device cpu`` runs the kernels' plain PyTorch versions.

  PYTHONPATH=src python examples/torch_spmv_search_report.py \\
      [--seconds 15] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

import repro_torch
from repro_torch.core.kernel_builder import spec_kernels
from repro_torch.core.matrices import make_suite
from repro_torch.kernels.ops import launch_counts

TOL = 1e-3               # relative to max |oracle| (fp32 storage)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=15.0,
                    help="search budget per matrix")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    target = repro_torch.Target(
        backend="cuda" if args.device == "cuda" else "torch")
    suite = make_suite("small")
    cfg = repro_torch.SearchConfig(max_seconds=args.seconds,
                                   max_structures=8, coarse_samples=4)
    print(f"{'matrix':16s} {'nnz':>7s} {'row_var':>9s} {'GFLOPS':>7s} "
          f"{'designed':>9s} {'branched':>9s} {'rel_err':>8s}  graph")
    worst = 0.0
    dispatch = set()
    for i, (name, m) in enumerate(suite.items()):
        plan = repro_torch.compile(m, target, budget=cfg)
        res = plan.search_result
        dispatch.update(spec_kernels(plan.spec))
        x = np.random.default_rng(i).standard_normal(m.n_cols).astype(
            np.float32)
        oracle = m.spmv_dense_oracle(x)
        err = float(np.abs(plan(x).cpu().numpy() - oracle).max()
                    / (np.abs(oracle).max() + 1e-30))
        worst = max(worst, err)
        print(f"{name:16s} {m.nnz:7d} {m.row_variance():9.1f} "
              f"{res.gflops:7.3f} {str(res.is_machine_designed()):>9s} "
              f"{str(res.best_graph.has_branches()):>9s} {err:8.1e}  "
              f"{res.best_graph.label()}", flush=True)
    print("check " + json.dumps({"matrices": len(suite),
                                 "oracle_rel_err": worst, "tol": TOL}))
    print("launches " + json.dumps(launch_counts()))
    print("dispatch " + json.dumps(sorted(dispatch)))
    if worst > TOL:
        print("FAIL: a plan does not match the oracle")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
