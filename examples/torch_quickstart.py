"""Quickstart on PyTorch/CUDA: AlphaSparse end to end — matrix in,
machine-designed SpMV out (``repro_torch``, the port of ``quickstart.py``).

Feeds a Matrix Market file (or a generated matrix) to
``repro_torch.compile``, gets back an ``SpmvPlan`` (a machine-designed
format and its hand-written CUDA kernels, serializable), compares it with
the Perfect Format Selector over the artificial-format baselines, and
round-trips it through disk bit-exactly. Runs on the GPU by default;
``--device cpu`` runs the kernels' plain PyTorch versions.

  PYTHONPATH=src python examples/torch_quickstart.py [--mtx m.mtx] \\
      [--seconds 30] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

import repro_torch
from repro_torch.core.kernel_builder import spec_kernels
from repro_torch.core.matrices import powerlaw_matrix, read_matrix_market
from repro_torch.kernels.ops import launch_counts
from repro_torch.sparse import PerfectFormatSelector


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mtx", default=None, help="MatrixMarket file (optional)")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    backend = "cuda" if args.device == "cuda" else "torch"

    if args.mtx:
        m = read_matrix_market(args.mtx)
        print(f"loaded {args.mtx}: {m.n_rows}x{m.n_cols}, nnz={m.nnz}")
    else:
        m = powerlaw_matrix(3000, 3000, 8.0, 1.0, seed=1)
        print(f"generated scale-free matrix: {m.n_rows}x{m.n_cols}, "
              f"nnz={m.nnz}, row_variance={m.row_variance():.0f} "
              f"({'irregular' if m.is_irregular() else 'regular'})")

    print(f"\n-- repro_torch.compile on {args.device} (AlphaSparse search "
          "over Operator Graphs) --")
    plan = repro_torch.compile(m, repro_torch.Target(backend=backend),
                               budget=args.seconds)
    res = plan.search_result
    print(f"searched {res.n_evaluations} designs in {res.wall_seconds:.1f}s "
          f"(pruned: {', '.join(res.pruned_ops) or 'nothing'})")
    print(f"best machine-designed plan: {plan.graph.label()}")
    print(f"  {plan.search_gflops:.3f} GFLOPS   "
          f"machine-designed={res.is_machine_designed()}   "
          f"branched={plan.graph.has_branches()}")
    if res.cost_model_mad is not None:
        print(f"  cost-model mean abs deviation: {res.cost_model_mad:.1%}")

    print("\n-- plan round trip (save -> load -> run) --")
    x = np.random.default_rng(0).standard_normal(m.n_cols).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "matrix.plan.npz")
        plan.save(path)
        loaded = repro_torch.SpmvPlan.load(path)
        y = plan(x)
        same = torch.equal(y, loaded(x))
        print(f"saved {os.path.getsize(path)} bytes; loaded plan is "
              f"bit-identical: {same}")
    if not same:
        print("FAIL: loaded plan is not bit-identical")
        return 1

    print("\n-- Perfect Format Selector (traditional auto-tuning) --")
    sel = PerfectFormatSelector(device=args.device).select(m)
    for name, t in sorted(sel.all_seconds.items(), key=lambda kv: kv[1]):
        mark = " <- PFS pick" if name == sel.best_name else ""
        print(f"  {name:14s} {2 * m.nnz / t / 1e9:8.3f} GFLOPS{mark}")
    print(f"\nAlphaSparse speedup over PFS: "
          f"{sel.best_seconds / res.best_seconds:.2f}x")

    # correctness against the float64 oracle (the tests gate on this line)
    oracle = m.spmv_dense_oracle(x)
    err = float(np.abs(y.cpu().numpy() - oracle).max())
    scale = float(np.abs(oracle).max()) + 1e-30
    print(f"max abs error vs dense float64 oracle: {err:.2e}")
    print("check " + json.dumps({"oracle_rel_err": err / scale,
                                 "tol": 1e-3, "bit_identical_load": same}))
    print("launches " + json.dumps(launch_counts()))
    print("dispatch " + json.dumps(spec_kernels(plan.spec)))
    if err > 1e-3 * scale:
        print("FAIL: plan output does not match the oracle")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
