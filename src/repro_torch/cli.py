"""``python -m repro_torch.cli``: compile a matrix to a saved ``SpmvPlan``
and bench it (port of ``repro.cli``, with the reference's flags)::

    python -m repro_torch.cli --mtx m.mtx --out m.plan.npz --seconds 60
    python -m repro_torch.cli --demo --no-search --batch 8 --out demo.plan.npz
    python -m repro_torch.cli --demo --backend torch --out demo.plan.npz

``--backend cuda`` (the default) runs the CUDA kernels on the GPU;
``--backend torch`` runs their plain PyTorch versions on the CPU.

Fleet workflows::

    python -m repro_torch.cli --sweep smoke --store plans/  # journaled sweep
    python -m repro_torch.cli --train-from-store --store plans/  # fit model
    python -m repro_torch.cli --demo --out d.plan.npz --store plans/ \\
                              --strategy portfolio --deadline 2  # fast path

Compiles the matrix (AlphaSparse search, or the heuristic design with
``--no-search``), saves the plan, reloads it, verifies the loaded plan is
bit-identical to the live one and correct against the float64 dense
oracle, then reports GFLOPS of the loaded plan, timed between two
synchronisations of the device.
"""
from __future__ import annotations

import argparse
import sys
import time


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cli",
        description="Compile a sparse matrix to a saved SpmvPlan artifact")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--mtx", help="MatrixMarket input file")
    src.add_argument("--demo", action="store_true",
                     help="use a generated scale-free demo matrix")
    ap.add_argument("--out", help="output .plan.npz path")
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"],
                    help="cuda: the CUDA kernels on the GPU; torch: their "
                         "plain PyTorch versions on the CPU")
    ap.add_argument("--batch", type=int, default=1,
                    help="right-hand sides the plan is tuned for")
    ap.add_argument("--seconds", type=float, default=30.0,
                    help="search budget in seconds")
    ap.add_argument("--deadline", type=float, default=None,
                    help="hard wall-clock cap for the whole compile "
                         "(repro_torch.compile deadline_s)")
    ap.add_argument("--no-search", action="store_true",
                    help="skip the search; use the heuristic design")
    ap.add_argument("--strategy", default="anneal",
                    help="search policy walking the design space: a name "
                         "registered with "
                         "repro_torch.design.register_strategy (shipped: "
                         "anneal | grid | cost_model | learned | portfolio)")
    ap.add_argument("--store", metavar="DIR", default=None,
                    help="PlanStore directory: exact hits are reloaded, "
                         "near matches warm-start the search, new plans "
                         "(and their stats sidecars) are saved")
    ap.add_argument("--train-from-store", action="store_true",
                    help="train the corpus model from the --store "
                         "directory's sidecars + sweep records, save it "
                         "next to the store, and exit (no compile)")
    ap.add_argument("--sweep", metavar="SCALE", default=None,
                    choices=["smoke", "small", "medium"],
                    help="sweep the synthetic corpus at SCALE into the "
                         "--store directory (journaled, resumable) and "
                         "exit (no compile)")
    ap.add_argument("--resume", action="store_true",
                    help="with --sweep: skip entries already journaled "
                         "in sweep_records.jsonl (crash-safe resume)")
    ap.add_argument("--isolate", default=None, choices=["process"],
                    help="with --sweep: run each compile in its own "
                         "subprocess so a crashing candidate kills one "
                         "entry, not the sweep")
    ap.add_argument("--retries", type=int, default=0,
                    help="with --sweep: retry a failed entry up to N "
                         "times with exponential backoff")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timing repeats for the benchmark")
    return ap


def _same_plan(a, b) -> bool:
    """Same spec, and every format array of the same dtype, shape and
    bytes."""
    import torch
    if a.spec_json != b.spec_json or sorted(a.fmt) != sorted(b.fmt):
        return False
    return all(
        u.dtype == v.dtype and u.shape == v.shape
        and torch.equal(u.cpu().view(torch.uint8), v.cpu().view(torch.uint8))
        for u, v in ((a.fmt[k], b.fmt[k]) for k in a.fmt))


def _train_from_store(store_dir: str) -> int:
    from repro_torch.corpus.model import default_model_path, train_from_store

    try:
        model = train_from_store(store_dir)
    except ValueError as e:
        print(f"FAIL: {e}")
        return 1
    path = model.save(default_model_path(store_dir))
    print(f"trained corpus model: {len(model.labels)} structure labels, "
          f"{len(model.exemplar_labels)} exemplars, "
          f"{model.n_train} sweep rows"
          + (f", log-MAE {model.mad:.3f}" if model.mad is not None
             else " (nearest-exemplar mode)"))
    print(f"saved -> {path} (fingerprint {model.fingerprint()})")
    return 0


def _run_corpus_sweep(args) -> int:
    import repro_torch
    from repro_torch.corpus.datasets import synthetic_corpus
    from repro_torch.corpus.sweep import run_sweep

    store = repro_torch.PlanStore(args.store)
    entries = synthetic_corpus(args.sweep)
    budget = repro_torch.SearchConfig(max_seconds=args.seconds,
                                      timing_repeats=1)
    recs = run_sweep(entries, store, budget=budget,
                     target=repro_torch.Target(backend=args.backend),
                     strategy=args.strategy, deadline_s=args.deadline,
                     resume=args.resume, isolate=args.isolate,
                     retries=args.retries, progress=print)
    failed = sum(1 for r in recs if r.error)
    skipped = len(entries) - len(recs)
    print(f"sweep[{args.sweep}]: {len(recs)} swept "
          f"({failed} errors), {skipped} skipped"
          + (" (resume)" if args.resume and skipped else ""))
    return 1 if (recs and failed == len(recs)) else 0


def main(argv=None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)

    if args.train_from_store:
        if not args.store:
            parser.error("--train-from-store requires --store DIR")
        return _train_from_store(args.store)
    if args.sweep:
        if not args.store:
            parser.error("--sweep requires --store DIR")
        return _run_corpus_sweep(args)
    if not (args.mtx or args.demo):
        parser.error("one of --mtx / --demo is required (or "
                     "--train-from-store)")
    if not args.out:
        parser.error("--out is required when compiling")

    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core.matrices import powerlaw_matrix, read_matrix_market

    if args.demo:
        m = powerlaw_matrix(2000, 2000, 8.0, 1.0, seed=1)
        print(f"demo matrix: {m.n_rows}x{m.n_cols} nnz={m.nnz} "
              f"row_variance={m.row_variance():.0f}")
    else:
        m = read_matrix_market(args.mtx)
        print(f"loaded {args.mtx}: {m.n_rows}x{m.n_cols} nnz={m.nnz}")

    store = repro_torch.PlanStore(args.store) if args.store else None
    target = repro_torch.Target(backend=args.backend, batch_size=args.batch)
    t0 = time.time()
    if args.no_search:
        from repro_torch.dist.spmv import default_shard_graph
        plan = repro_torch.compile(m, target, graph=default_shard_graph(m),
                                   store=store)
        print(f"compiled (heuristic design) in {time.time() - t0:.1f}s")
    else:
        plan = repro_torch.compile(m, target, budget=args.seconds,
                                   strategy=args.strategy, store=store,
                                   deadline_s=args.deadline)
        res = plan.search_result
        if res is None:   # exact PlanStore hit: loaded, not searched
            print(f"plan store hit in {time.time() - t0:.1f}s "
                  f"-> {plan.graph.label()}")
        else:
            print(f"searched {res.n_evaluations} designs in "
                  f"{res.wall_seconds:.1f}s ({res.strategy_name} strategy) "
                  f"-> {plan.graph.label()}")
    if store is not None:
        print(f"plan store {args.store}: {store.hits} hits, "
              f"{store.misses} misses")

    plan.save(args.out)
    loaded = repro_torch.SpmvPlan.load(args.out)
    print(f"saved -> {args.out}; reloaded")

    # verify: the loaded plan's spec and format arrays are bit-identical
    # to the live plan's, its output is the live plan's bit for bit (the
    # plans' combines add in a fixed order), and both answer within the
    # oracle tolerance
    if not _same_plan(plan, loaded):
        print("FAIL: loaded plan is not bit-identical to the live plan")
        return 1
    rng = np.random.default_rng(0)
    b = max(args.batch, 1)
    x_np = rng.standard_normal((m.n_cols,) if b == 1
                               else (m.n_cols, b)).astype(np.float32)
    x = torch.from_numpy(x_np).to(loaded.device)
    y_live = plan(x)
    y_load = loaded(x)
    if not torch.equal(y_live, y_load):
        print("FAIL: loaded plan's output is not bit-identical to the live "
              "plan's")
        return 1
    oracle = (m.spmv_dense_oracle(x_np) if b == 1
              else m.spmm_dense_oracle(x_np))
    scale = np.abs(oracle).max() + 1e-30
    err = np.abs(y_live.cpu().numpy() - oracle).max() / scale
    if err > 1e-4:
        print(f"FAIL: rel error vs float64 oracle {err:.2e} > 1e-4")
        return 1
    print(f"verified: round trip bit-exact, oracle rel error {err:.2e}")

    # benchmark the loaded plan: each call between two synchronisations,
    # so the time is the device's work and not only its launch
    sync = (torch.cuda.synchronize if loaded.device.type == "cuda"
            else (lambda: None))
    loaded(x)
    sync()
    best = float("inf")
    for _ in range(max(args.repeats, 1)):
        t = time.perf_counter()
        loaded(x)
        sync()
        best = min(best, time.perf_counter() - t)
    gflops = 2.0 * m.nnz * b / best / 1e9
    print(f"benchmark: {best * 1e6:.1f} us/call, {gflops:.3f} GFLOPS "
          f"(B={b}, {args.backend})")
    print(loaded.describe())
    return 0


if __name__ == "__main__":
    sys.exit(main())
