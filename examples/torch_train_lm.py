"""End-to-end training driver on PyTorch/CUDA (``repro_torch``, the port of
``train_lm.py``): train a ~100M-parameter granite-family model for a few
hundred steps on the synthetic pipeline, with checkpointing and fault
tolerance active. Runs on the GPU by default; ``--device cpu`` trains on
the CPU.

Full run (~100M params, a few hundred steps):
  PYTHONPATH=src python examples/torch_train_lm.py --steps 300

CI-scale run:
  PYTHONPATH=src python examples/torch_train_lm.py --steps 40 --tiny \\
      --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile

from repro_torch.configs import REGISTRY, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.train import DriverConfig, TrainDriver


def model_100m() -> ArchConfig:
    """A ~100M-param member of the granite family (same code path as the
    full 2B config — only the dims differ)."""
    base = get_config("granite-3-2b")
    return dataclasses.replace(
        base, name="granite-100m", n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab=32768)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config for CI (seconds, not hours)")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = model_100m()
    if args.tiny:
        cfg = cfg.reduced()
        args.batch, args.seq = 4, 128
    # register the custom config so the driver can find it
    REGISTRY[cfg.name] = cfg

    n = cfg.n_params() / 1e6
    print(f"training {cfg.name} on {args.device}: {n:.0f}M params, "
          f"{args.steps} steps x ({args.batch} x {args.seq}) tokens")
    dc = DriverConfig(arch=cfg.name, reduced=False, steps=args.steps,
                      batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt,
                      ckpt_every=50, log_every=10, compute_dtype="float32",
                      device=args.device)
    out = TrainDriver(dc).run()
    print(f"\nloss: {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
          f"over {out['n_steps_run']} steps "
          f"(restarts: {out['restarts']})")
    decreased = bool(math.isfinite(out["final_loss"])
                     and out["final_loss"] < out["first_loss"])
    print("check " + json.dumps({"first_loss": out["first_loss"],
                                 "final_loss": out["final_loss"],
                                 "steps": out["n_steps_run"],
                                 "loss_decreased": decreased}))
    if not decreased:
        print("FAIL: loss must decrease")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
