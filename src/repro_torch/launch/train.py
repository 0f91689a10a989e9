"""Training driver: model state + data pipeline + checkpoint/restart loop
with fault-tolerance hooks (port of ``repro.launch.train``).

Runs real steps on one device: the current GPU by default (raises
without one), or the CPU with ``device="cpu"``. ``--arch <id>
--reduced`` trains the CI-scale variant.

The outer loop is restart-idempotent: on (simulated or real) failure it
restores the latest committed checkpoint and replays from there; the data
pipeline is keyed by step so no batch is skipped or repeated.

A (data, model) mesh larger than one device is refused: the sharding
rules (``dist.sharding``) give the specs such a mesh would use, but
sharded training is not ported.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --reduced --steps 50 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
from repro_torch.dist.sharding import batch_specs, param_specs
from repro_torch.ft.manager import FaultToleranceManager, NodeFailure
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import init_params, resolve_device
from repro_torch.train.compression import CompressionConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import TrainConfig, init_state, make_train_step

__all__ = ["DriverConfig", "TrainDriver", "main"]


@dataclasses.dataclass
class DriverConfig:
    arch: str = "granite-3-2b"
    reduced: bool = True
    steps: int = 50
    batch: int = 8
    seq: int = 128
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 20
    data_mesh: int = 1
    model_mesh: int = 1
    seed: int = 0
    compute_dtype: str = "float32"
    grad_accum: int = 1
    compression: bool = False
    log_every: int = 10
    fail_at_step: int = -1        # test hook: inject a failure once
    device: str | None = None     # None: the current GPU; "cpu" for tests


class TrainDriver:
    def __init__(self, dc: DriverConfig):
        self.dc = dc
        cfg = get_config(dc.arch)
        self.cfg = cfg.reduced() if dc.reduced else cfg
        self.device = resolve_device(dc.device)
        self.mesh = make_local_mesh(data=dc.data_mesh, model=dc.model_mesh,
                                    device=self.device)
        if self.mesh.size > 1:
            raise NotImplementedError(
                f"a {dc.data_mesh}x{dc.model_mesh} mesh: sharded training "
                "is not ported; train on one device (data_mesh = "
                "model_mesh = 1)")
        self.tc = TrainConfig(
            opt=AdamWConfig(total_steps=dc.steps,
                            warmup_steps=max(dc.steps // 20, 1)),
            compute_dtype=dc.compute_dtype, grad_accum=dc.grad_accum,
            compression=CompressionConfig(enabled=dc.compression))
        self.ckpt = CheckpointManager(dc.ckpt_dir)
        self.ft = FaultToleranceManager()
        self.ft.register("host0")
        self.data = SyntheticTokenPipeline(
            DataConfig(vocab=self.cfg.vocab, seq_len=dc.seq,
                       global_batch=dc.batch, seed=dc.seed))
        self._failed_once = False
        self.metrics_log: list[dict] = []

    # ------------------------------------------------------------------
    def _build_state(self):
        params = init_params(self.cfg, self.dc.seed, self.device)
        state = init_state(self.cfg, self.tc, params)
        # the layout a mesh would give the state (one device: replicated)
        pspecs = param_specs(self.cfg, self.mesh, params)
        self.state_specs = {"params": pspecs,
                            "opt": {"m": pspecs, "v": pspecs, "count": ()}}
        if self.tc.compression.enabled:
            self.state_specs["err"] = pspecs
        self.batch_specs = batch_specs(self.cfg, self.mesh, self.dc.batch)
        return state

    # ------------------------------------------------------------------
    def run(self) -> dict:
        dc = self.dc
        state = self._build_state()
        fn = make_train_step(self.cfg, self.tc)
        start = self.ckpt.latest_step()
        if start is not None:
            state = self.ckpt.restore(start, state, device=self.device)
            start += 1
        else:
            start = 0
        step = start
        while step < dc.steps:
            try:
                batch = self.data.batch_at(step)
                if dc.fail_at_step == step and not self._failed_once:
                    self._failed_once = True
                    raise NodeFailure(f"injected failure at step {step}")
                t0 = time.perf_counter()
                state, metrics = fn(state, batch)
                loss = float(metrics["loss"])     # waits for the device
                dt = time.perf_counter() - t0
                self.ft.heartbeat("host0", step, dt)
                rep = self.ft.check_straggler("host0", dt)
                if rep is not None:
                    print(f"[ft] straggler: {rep}")
                self.metrics_log.append(
                    {"step": step, "loss": loss, "time": dt})
                if step % dc.log_every == 0:
                    print(f"step {step:5d} loss {loss:.4f} "
                          f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms",
                          flush=True)
                if dc.ckpt_every and step and step % dc.ckpt_every == 0:
                    self.ckpt.save(step, state)
                step += 1
            except NodeFailure as e:
                print(f"[ft] {e}; restart from last checkpoint")
                self.ft.record_restart()
                latest = self.ckpt.latest_step()
                if latest is None:
                    state = self._build_state()
                    step = 0
                else:
                    self.ckpt.wait()
                    state = self.ckpt.restore(latest, state,
                                              device=self.device)
                    step = latest + 1
        self.ckpt.save(dc.steps - 1, state, blocking=True)
        self.state = state
        return {"final_loss": self.metrics_log[-1]["loss"]
                if self.metrics_log else None,
                "first_loss": self.metrics_log[0]["loss"]
                if self.metrics_log else None,
                "n_steps_run": len(self.metrics_log),
                "restarts": self.ft.restarts}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train one of the assigned architectures on one device "
                    "(the synthetic token pipeline, random initial weights).")
    for f in dataclasses.fields(DriverConfig):
        if f.type in ("bool", bool):
            ap.add_argument(f"--{f.name}", action="store_true",
                            default=f.default)
        elif f.default is None:
            ap.add_argument(f"--{f.name}", type=str, default=None)
        else:
            ap.add_argument(f"--{f.name}", type=type(f.default),
                            default=f.default)
    args = ap.parse_args(argv)
    dc = DriverConfig(**vars(args))
    out = TrainDriver(dc).run()
    print(out)


if __name__ == "__main__":
    main()
