"""Extending AlphaSparse out of tree on PyTorch/CUDA: a custom operator,
end to end (``repro_torch``, the port of ``custom_operator.py``).

The Operator Graph is an *open* design space; ``repro_torch.design`` is
where it opens up. This example registers a new converting operator —
``ROW_REVERSE``, a row-reversal permute — without touching anything
under ``src/repro_torch``, then:

1. designs a plan with an explicit graph that uses it
   (``repro_torch.compile(..., graph=...)``): the operator's packed
   arrays go through the hand-written kernels on the card,
2. verifies the plan against the float64 dense oracle,
3. round-trips it through ``save``/``load`` bit-exactly,
4. shows the operator woven into the enumerated ``DesignSpace``,
5. runs a small ``--strategy grid`` search in which the custom operator
   competes with the built-ins.

Runs on the GPU by default; ``--device cpu`` runs the kernels' plain
PyTorch versions.

  PYTHONPATH=src python examples/torch_custom_operator.py [--seconds 5] \\
      [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

import repro_torch
import repro_torch.design
from repro_torch.core.kernel_builder import spec_kernels
from repro_torch.kernels.ops import launch_counts


# ----------------------- the out-of-tree operator ---------------------------
#
# An operator declares its stage + structural traits as class attributes
# and implements the Designer contract (applicable / apply). ROW_REVERSE
# permutes rows into reverse order — a stand-in for the reordering
# operators (RCM, graph partitioning, ...) a real extension would add.

@repro_torch.design.register_operator("ROW_REVERSE")
class RowReverse(repro_torch.design.Operator):
    """Reverse the (current) row order of a single-block matrix."""

    stage = repro_torch.design.STAGE_CONVERTING

    @staticmethod
    def applicable(meta):
        return meta.compressed and len(meta.blocks) == 1

    @staticmethod
    def apply(meta, spec):
        b = meta.blocks[0]
        n = b.n_block_rows
        new_rows = (n - 1 - b.rows).astype(np.int32)
        order = np.lexsort((b.cols, new_rows))     # keep nnz (row, col) sorted
        block = dataclasses.replace(
            b, row_ids=np.ascontiguousarray(b.row_ids[::-1]),
            rows=new_rows[order], cols=b.cols[order], vals=b.vals[order])
        return meta.with_blocks([block], spec.label())


def graph_with_row_reverse():
    """The explicit graph of step 1."""
    OpSpec = repro_torch.OpSpec
    return repro_torch.OperatorGraph.chain(
        OpSpec.make("COMPRESS"), OpSpec.make("ROW_REVERSE"),
        OpSpec.make("TILE_ROW_BLOCK", rows=32),
        OpSpec.make("LANE_ROW_BLOCK"),
        OpSpec.make("LANE_TOTAL_RED", combine="scatter"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=5.0,
                    help="budget for the demo grid search")
    ap.add_argument("--out", default=None,
                    help="where to save the plan (default: a temporary "
                    "directory)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    target = repro_torch.Target(
        backend="cuda" if args.device == "cuda" else "torch")
    t0 = time.time()

    from repro_torch.core.matrices import powerlaw_matrix
    m = powerlaw_matrix(384, 384, 6.0, 1.2, seed=5)
    print(f"matrix: {m.n_rows}x{m.n_cols} nnz={m.nnz}")

    # 1. an explicit graph using the custom operator
    graph = graph_with_row_reverse()
    plan = repro_torch.compile(m, target, graph=graph)
    print(f"compiled custom-operator graph: {plan.graph.label()}")

    # 2. correct vs the float64 dense oracle
    x = np.random.default_rng(0).standard_normal(m.n_cols).astype(np.float32)
    oracle = m.spmv_dense_oracle(x)
    y = plan(x)
    err = float(np.abs(y.cpu().numpy() - oracle).max()
                / (np.abs(oracle).max() + 1e-30))
    print(f"oracle rel error: {err:.2e}")
    if err > 1e-4:
        print("FAIL: custom-operator plan is wrong")
        return 1

    # 3. save -> load -> bit-exact (graph JSON carries the op by name; the
    # loaded plan rebuilds from the kernel spec, no registry replay needed)
    with tempfile.TemporaryDirectory() as d:
        out = args.out or os.path.join(d, "custom_op.plan.npz")
        plan.save(out)
        loaded = repro_torch.SpmvPlan.load(out)
        same = torch.equal(loaded(x), y)
    if not same:
        print("FAIL: loaded plan not bit-identical")
        return 1
    assert loaded.graph.op_names() == graph.op_names()
    print(f"round trip bit-exact -> {out}")

    # 4. the registered operator is woven into the enumerated design space
    space = repro_torch.DesignSpace(m, repro_torch.SearchConfig(
        backend=target.backend))
    with_op = [s for s in space.structures()
               if "ROW_REVERSE" in s.converting]
    print(f"design space: {len(with_op)} structures use ROW_REVERSE "
          f"(of {len(space.structures())})")
    if not with_op:
        print("FAIL: custom operator missing from the design space")
        return 1

    # 5. a small grid search in which the custom operator competes
    budget = repro_torch.SearchConfig(max_seconds=args.seconds,
                                      max_structures=4, coarse_samples=2,
                                      fine_eval_budget=2, timing_repeats=1,
                                      seed=0)
    searched = repro_torch.compile(m, target, budget=budget,
                                   strategy="grid")
    res = searched.search_result
    print(f"grid search: {res.n_evaluations} candidates -> "
          f"{searched.graph.label()} ({res.gflops:.3f} GFLOPS)")

    print("check " + json.dumps({"oracle_rel_err": err, "tol": 1e-4,
                                 "bit_identical_load": same,
                                 "structures_with_op": len(with_op)}))
    print("launches " + json.dumps(launch_counts()))
    print("dispatch " + json.dumps(sorted(set(spec_kernels(plan.spec))
                                          | set(spec_kernels(searched.spec)))))
    print(f"done in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
