"""Batched serving on PyTorch/CUDA (``repro_torch``, the port of
``serve_requests.py``): continuous-batching decode over a reduced model,
and the AlphaSparse SparseLinear integration (pruned-weight decode
through the hand-written multi-RHS kernels), then the matvec plane with a
hot swap between waves. Runs on the GPU by default; ``--device cpu``
runs the kernels' plain PyTorch versions.

  PYTHONPATH=src python examples/torch_serve_requests.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

import repro_torch
from repro_torch.configs import get_config
from repro_torch.core.kernel_builder import spec_kernels
from repro_torch.kernels.ops import launch_counts
from repro_torch.serve import (MatvecRequest, PlanExecutor, Request,
                               ServeConfig, ServingEngine, SparseLinear,
                               SpmvEngine, prune_magnitude)

TOL = 1e-4               # relative to max |dense| (fp32 storage)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    backend = "cuda" if args.device == "cuda" else "torch"

    cfg = get_config("qwen3-8b").reduced()
    print(f"serving reduced {cfg.name} "
          f"({cfg.n_params() / 1e6:.1f}M params at this scale) on "
          f"{args.device}")
    eng = ServingEngine(cfg, ServeConfig(max_batch=4, max_seq=128,
                                         max_new_tokens=24),
                        device=args.device)
    rng = np.random.default_rng(0)
    # ragged prompt lengths: later requests join mid-flight (continuous
    # batching) and decode at their own per-slot positions
    reqs = [Request(i, rng.integers(0, cfg.vocab, size=5 + i % 4))
            for i in range(8)]
    out = eng.run(reqs)
    served = sum(r.done and not r.failed and len(r.out_tokens) == 24
                 for r in reqs)
    print(f"served {out['requests']} requests, {out['tokens']} tokens in "
          f"{out['wall_s']:.2f}s ({out['tok_per_s']:.1f} tok/s, "
          f"{out['decode_steps']} decode steps, "
          f"latency p50={out['latency_p50_s'] * 1e3:.0f}ms "
          f"p99={out['latency_p99_s'] * 1e3:.0f}ms)")

    print("\n-- AlphaSparse sparse-weight decode (paper technique in "
          "the serving path) --")
    d = cfg.d_model
    w = np.asarray(rng.standard_normal((4 * d, d)), np.float32)
    m = prune_magnitude(w, 0.08)
    # batch_size=4: the plan serves the engine's decode batch on the
    # fused multi-RHS path
    plan = repro_torch.compile(
        m, repro_torch.Target(backend=backend, batch_size=4),
        budget=repro_torch.SearchConfig(max_seconds=5, max_structures=2,
                                        coarse_samples=2, timing_repeats=1))
    sl = SparseLinear.from_plan(plan, m)
    x = rng.standard_normal((4, d)).astype(np.float32)  # batch of hiddens
    y = sl(x).cpu().numpy()
    dense_w = sl.matrix.to_dense().astype(np.float64)
    dense = x.astype(np.float64) @ dense_w.T
    err = float(np.abs(y - dense).max() / (np.abs(dense).max() + 1e-9))
    print(f"SparseLinear {w.shape} at density={sl.density:.2%}: "
          f"batched decode matvec rel-err {err:.2e}")
    print(f"format: {sl.graph.label()}")

    print("\n-- matvec plane: bucketed batching + zero-downtime hot-swap --")
    ex = PlanExecutor(plan, m)
    ex.warmup()
    seng = SpmvEngine(ex)
    wave1 = [MatvecRequest(i, rng.standard_normal(d).astype(np.float32))
             for i in range(13)]
    stats = seng.run(wave1)
    ex.swap_plan(plan)   # atomic; a PlanStore watch drives this in prod
    wave2 = [MatvecRequest(100 + i, rng.standard_normal(d).astype(np.float32))
             for i in range(5)]
    stats2 = seng.run(wave2)
    mv_err = max(float(np.abs(np.asarray(r.y) - dense_w @ r.x).max()
                       / (np.abs(dense_w @ r.x).max() + 1e-9))
                 for r in wave1 + wave2)
    ok = sum(r.status == "ok" for r in wave1 + wave2)
    print(f"buckets {ex.buckets}: {stats['requests']}+{stats2['requests']} "
          f"matvecs, p50={stats['latency_p50_s'] * 1e3:.2f}ms, "
          f"{ex.swap_count} hot-swap between waves, max rel-err "
          f"{mv_err:.2e}")

    print("check " + json.dumps({
        "requests_served": served, "requests": len(reqs),
        "sparse_linear_rel_err": err, "matvec_rel_err": mv_err, "tol": TOL,
        "matvecs_ok": ok, "matvecs": len(wave1) + len(wave2),
        "hot_swaps": ex.swap_count}))
    print("launches " + json.dumps(launch_counts()))
    print("dispatch " + json.dumps(spec_kernels(plan.spec, batched=True)))
    good = (served == len(reqs) and err <= TOL and mv_err <= TOL
            and ok == len(wave1) + len(wave2) and ex.swap_count == 1)
    if not good:
        print("FAIL: a request failed, an answer is off, or no hot swap")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
