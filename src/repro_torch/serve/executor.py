"""Executors: device-side dispatch for the serving plane (port of
``repro.serve.executor``).

The engines (``serve.engine``) own scheduling; executors own dispatch:

* :class:`ModelExecutor`: a ``CausalLM`` on a device, batched slot caches
  and the per-slot decode step for token serving.
* :class:`PlanExecutor`: a compiled ``SpmvPlan`` behind
  ``SparseLinear.from_plan``, pad-to-bucket batching derived from the
  plan's searched batch size, and zero-downtime hot-swap (atomic plan
  replacement, optionally driven by a ``PlanStore`` watch). ``execute``
  keeps the reference's numpy-in, numpy-out contract: each padded chunk
  is copied to the plan's device, runs there through the multi-RHS
  kernels, and the result is copied back.
"""
from __future__ import annotations

import threading
import warnings
from typing import Optional

import numpy as np
import torch

from .sparse_linear import SparseLinear

__all__ = ["ModelExecutor", "PlanExecutor", "SwapRejected",
           "decode_buckets"]


class ModelExecutor:
    """Per-slot decode dispatch over batched slot caches.

    ``decode(tokens, positions, live)`` runs one decode step where every
    batch row advances at *its own* cache position (``positions`` is a
    (B,) vector) and only ``live`` rows commit cache writes: attention K/V
    and SSM conv/ssm state alike, which is what makes mid-flight prefill
    of one slot safe while its neighbours are mid-decode. The reference
    selects over the whole cache (``where``) after the step; the port
    writes the live rows in place, at their slot, and leaves the others
    untouched, so the caches hold the reference's values after every step.

    The model lives on ``device`` (default the GPU; raises without one).
    ``params`` is a tree of tensors (``models.weights.params_from_numpy``
    of the reference's) or None for ``init_params(cfg, seed, device)``;
    the leaves the reference casts to ``dtype`` at each use are cast once
    here, the float32 ones stay float32.
    """

    def __init__(self, cfg, max_batch: int, max_seq: int,
                 dtype=torch.float32, params: Optional[dict] = None,
                 seed: int = 0, device=None):
        from repro_torch.models import CausalLM
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.dtype = dtype
        self.model = CausalLM(cfg, params, seed=seed, device=device,
                              dtype=dtype)
        self.device = self.model.device
        self.params = self.model.params
        self.caches = self.model.cache_spec(max_batch, max_seq)

    def inputs(self, tokens, positions, live):
        """Host (B, 1) tokens, (B,) positions and (B,) live mask as device
        tensors in one copy: (token, pos, rows); rows is None when every
        row is live."""
        live = np.asarray(live, bool)
        b = live.size
        rows = np.flatnonzero(live)
        packed = np.concatenate([np.asarray(tokens).reshape(b),
                                 np.asarray(positions).reshape(b),
                                 rows]).astype(np.int64)
        dev = torch.from_numpy(packed).to(self.device)
        return (dev[:b].reshape(b, 1), dev[b:2 * b],
                None if rows.size == b else dev[2 * b:])

    def step(self, token: torch.Tensor, pos: torch.Tensor,
             rows: Optional[torch.Tensor]) -> torch.Tensor:
        """One decode step on device tensors; returns the device logits
        (B, 1, vocab_padded) float32 without waiting for the card."""
        with torch.inference_mode():
            logits, _ = self.model.decode_step(token, pos, self.caches, rows)
        return logits

    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               live: np.ndarray) -> np.ndarray:
        """One per-slot decode step; returns host logits (B, 1, vocab)."""
        with torch.inference_mode():
            logits = self.step(*self.inputs(tokens, positions, live))
            return logits.cpu().numpy()

    def reset(self) -> None:
        """Drop all cache state (every slot becomes reusable)."""
        for c in self.caches:
            for t in c.values():
                t.zero_()


class SwapRejected(RuntimeError):
    """An incoming hot-swap plan failed admission (warm-up error or
    oracle spot-check mismatch); the previous plan was retained and keeps
    serving. ``maybe_reload`` catches this and reports no swap."""


def decode_buckets(plan, max_bucket: Optional[int] = None) -> tuple:
    """Pad-to-bucket sizes from the plan's searched batch size.

    The searched ``target.batch_size`` B is the top bucket (the SpMM width
    the search timed candidates at), with a power-of-two ladder below it
    so small ragged batches don't pay full-B padding. ``max_bucket``
    widens the top when the engine wants to batch past the searched
    width."""
    top = max(int(getattr(getattr(plan, "target", None), "batch_size", 1)
                  or 1), 1)
    if max_bucket is not None:
        top = max(top, int(max_bucket))
    buckets, b = [], 1
    while b < top:
        buckets.append(b)
        b *= 2
    buckets.append(top)
    return tuple(buckets)


def _device_of(program) -> torch.device:
    """The device a program's format tensors live on (the plan's device);
    batches are copied there, never to another device."""
    device = getattr(program, "device", None)
    if device is not None:
        return device
    fmt = getattr(program, "fmt", None)
    if fmt:
        return next(iter(fmt.values())).device
    raise ValueError(f"cannot tell the device of {type(program).__name__}: "
                     "it has neither .device nor format tensors")


class PlanExecutor:
    """Compiled-plan dispatch with bucketed batching and atomic hot-swap.

    Holds the current ``SpmvPlan`` behind a ``SparseLinear``; ``execute``
    pads a ragged (n, n_cols) batch to the nearest bucket and runs the
    plan's multi-RHS path. ``swap_plan`` replaces the plan with a single
    reference assignment: in-flight batches finish on the layer object
    they captured, the next batch sees the new plan, no step is ever
    dropped. ``maybe_reload`` polls an attached ``PlanStore`` watch so
    better plans landing from an offline search hot-swap with zero
    downtime.
    """

    def __init__(self, plan, matrix=None, buckets=None, watch=None):
        self._layer = SparseLinear.from_plan(plan, matrix)
        # the current reference matrix: swap admission judges incoming
        # plans against what is being served today
        self._oracle_matrix = matrix
        self.buckets = tuple(sorted(buckets)) if buckets \
            else decode_buckets(plan)
        self._watch = watch
        self.swap_count = 0
        self.rejected_swaps = 0
        self.update_count = 0
        # background-research watchdog (anything with watchdog_tick() and
        # stats()): pumped from maybe_reload
        self._research_monitor = None
        self.research_alerts = 0
        self._warned_research_dead = False
        self._lock = threading.Lock()

    # -- plan access -------------------------------------------------------
    @property
    def layer(self) -> SparseLinear:
        return self._layer

    @property
    def plan(self):
        return self._layer.program

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (capped at the top bucket)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    # -- hot-swap ----------------------------------------------------------
    def attach_watch(self, watch) -> None:
        self._watch = watch

    def attach_research_monitor(self, monitor) -> None:
        """Attach a background-search watchdog (anything exposing
        ``watchdog_tick()`` and ``stats()``). ``maybe_reload`` pumps it on
        every poll, so a serving loop that only calls ``maybe_reload``
        still detects and restarts a dead re-search thread."""
        self._research_monitor = monitor

    def warmup(self, layer: Optional[SparseLinear] = None) -> None:
        """Run a layer once at every bucket size (zeros input).

        Run on the incoming plan before the atomic swap, so that a
        hot-swap never stalls serving on the kernels' first launch (and
        on the kernel build, when the libraries are not loaded yet), and
        at startup so the first real requests don't pay it either."""
        layer = layer if layer is not None else self._layer
        n_cols = getattr(layer.program, "n_cols", None)
        if n_cols is None:
            return
        device = _device_of(layer.program)
        for b in self.buckets:
            layer(torch.zeros((b, n_cols), dtype=torch.float32,
                              device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # a launch fault shows here

    def set_reference_matrix(self, matrix) -> None:
        """Point swap admission at a new oracle matrix (a re-searched plan
        for a mutated pattern must be judged against the new matrix)."""
        with self._lock:
            self._oracle_matrix = matrix

    def _spot_check(self, new_layer: SparseLinear, matrix=None) -> None:
        """Oracle spot-check of an incoming plan on one random input.

        Compared against the current reference matrix's float64 dense
        oracle when the executor knows one, else against the serving
        layer. The tolerance admits bf16-stored plans (~2^-8 relative
        storage rounding) and rejects wrong programs."""
        n_cols = getattr(new_layer.program, "n_cols", None)
        if n_cols is None:
            return
        x = np.random.default_rng(0).standard_normal(
            (1, n_cols)).astype(np.float32)
        got = self._run(new_layer, x)[0]
        if matrix is None:
            matrix = self._oracle_matrix
        if matrix is not None:
            want = np.asarray(matrix.spmv_dense_oracle(x[0]))
        else:
            want = self._run(self._layer, x)[0]
        scale = np.abs(want).max() + 1e-30
        err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
        if not np.isfinite(got).all() or err > 2e-2 * scale + 1e-5:
            raise SwapRejected(
                f"incoming plan failed its oracle spot-check "
                f"(max abs err {err:.3e}, scale {scale:.3e}); "
                "previous plan retained")

    def swap_plan(self, plan, warm: bool = True, check: bool = True) -> None:
        """Admission-checked atomic replacement.

        The incoming plan is version-checked against the serving plan's
        ``plan_version`` (a stale store entry must never clobber a newer
        live plan), then warmed up (``warm=True``) and oracle
        spot-checked (``check=True``) before the reference assignment;
        any failure raises :class:`SwapRejected` and the old plan keeps
        serving."""
        incoming_v = int(getattr(plan, "plan_version", 0))
        current_v = int(getattr(self.plan, "plan_version", 0))
        if incoming_v < current_v:
            self.rejected_swaps += 1
            raise SwapRejected(
                f"incoming plan version {incoming_v} is stale (serving "
                f"version {current_v}); previous plan retained")
        new_layer = SparseLinear.from_plan(plan, self._oracle_matrix)
        try:
            if warm:
                self.warmup(new_layer)
            if check:
                self._spot_check(new_layer)
        except SwapRejected:
            self.rejected_swaps += 1
            raise
        except Exception as e:
            self.rejected_swaps += 1
            raise SwapRejected(
                f"incoming plan failed its warm-up: {e!r}; "
                "previous plan retained") from e
        with self._lock:
            self._layer = new_layer
            self.swap_count += 1

    def apply_update(self, plan, matrix=None, check: bool = True) -> None:
        """Adopt a patch-in-place updated plan (no warm-up: same format
        shapes as the serving one). ``matrix`` (the mutated
        ``SparseMatrix``) becomes the new admission reference; the
        optional spot-check verifies the patched plan against it."""
        ref = matrix if matrix is not None else self._oracle_matrix
        new_layer = SparseLinear.from_plan(plan, ref)
        if check:
            self._spot_check(new_layer, matrix=ref)
        with self._lock:
            self._layer = new_layer
            self._oracle_matrix = ref
            self.update_count += 1

    def maybe_reload(self) -> bool:
        """Poll the attached watch; swap and report True on a new plan.
        A plan that fails admission is rejected in place (warned, counted
        in ``rejected_swaps``) and the watch moves on.

        Also pumps an attached research monitor's watchdog: a restarted
        background search bumps ``research_alerts``; a struck-out one
        (``research_dead``) is warned about once."""
        mon = self._research_monitor
        if mon is not None:
            if mon.watchdog_tick() is not None:
                self.research_alerts += 1
            if (not self._warned_research_dead
                    and mon.stats().get("research_dead")):
                self._warned_research_dead = True
                warnings.warn(
                    "background re-search struck out and was disabled; "
                    "serving continues on the current plan",
                    RuntimeWarning)
        if self._watch is None:
            return False
        plan = self._watch.poll()
        if plan is None:
            return False
        try:
            self.swap_plan(plan)
        except SwapRejected as e:
            warnings.warn(str(e), RuntimeWarning)
            return False
        return True

    # -- dispatch ----------------------------------------------------------
    @staticmethod
    def _run(layer: SparseLinear, xs: np.ndarray) -> np.ndarray:
        """One padded batch: host -> the plan's device -> host."""
        x = torch.from_numpy(np.ascontiguousarray(xs, np.float32)).to(
            _device_of(layer.program))
        return layer(x).cpu().numpy()

    def execute(self, xs: np.ndarray) -> np.ndarray:
        """xs: (n, n_cols) -> (n, n_rows), padded to bucket geometry.

        Batches wider than the top bucket are chunked; each chunk runs on
        whatever plan is current when it starts (the hot-swap boundary is
        the chunk, never mid-chunk)."""
        xs = np.asarray(xs)
        outs = []
        for lo in range(0, xs.shape[0], self.max_bucket):
            chunk = xs[lo:lo + self.max_bucket]
            layer = self._layer          # capture once per chunk
            n = chunk.shape[0]
            b = self.bucket_for(n)
            if n < b:
                chunk = np.concatenate(
                    [chunk, np.zeros((b - n, chunk.shape[1]), chunk.dtype)])
            outs.append(self._run(layer, chunk)[:n])
        return np.concatenate(outs) if len(outs) > 1 else outs[0]
