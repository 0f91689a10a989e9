"""Serving plane: scheduling engines over dispatch executors (port of
``repro.serve.engine``).

Engines own scheduling (request queues, slot bookkeeping, ragged batch
formation, backpressure, deadlines, retries, health); executors
(``serve.executor``) own dispatch. Two engines share the split:

* :class:`ServingEngine`: token serving for a (reduced or full) model: a
  request queue feeding free cache slots, **per-slot decode positions**
  (slots at different depths decode correctly, so requests join
  mid-flight without corrupting their neighbours), and live-masked cache
  commits, so a joining request's prefill never touches another slot's
  state.
* :class:`SpmvEngine`: a request loop around ``SparseLinear.from_plan``:
  ragged batches of SpMV requests are padded to the plan's bucket
  geometry and dispatched through a
  :class:`~repro_torch.serve.executor.PlanExecutor`, which runs them on
  the plan's device through the multi-RHS kernels. Between steps the
  executor polls its ``PlanStore`` watch, so a better plan landing from
  an offline search hot-swaps with zero downtime (in-flight batches
  finish on the old plan).
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from .executor import ModelExecutor, PlanExecutor

__all__ = ["ServeConfig", "Request", "ServingEngine", "MatvecRequest",
           "SpmvEngine"]


def _percentile(sorted_vals: list, pct: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(pct / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 4
    max_seq: int = 256
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 = greedy
    seed: int = 0
    compute_dtype: str = "float32"    # 'float32' | 'bfloat16'
    # run() termination guards: ``max_steps`` caps decode steps,
    # ``max_wall_s`` caps wall clock; either tripping raises instead of
    # spinning forever
    max_steps: int = 10_000
    max_wall_s: Optional[float] = None


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    failed: bool = False               # prefill/decode raised; see error
    error: Optional[str] = None
    t_submit: Optional[float] = None   # set at enqueue/submit
    t_first: Optional[float] = None    # first decoded token
    t_done: Optional[float] = None

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_submit is None or self.t_done is None:
            return None
        return self.t_done - self.t_submit


class ServingEngine:
    """Continuous-batching token server: scheduling over a ModelExecutor.

    Slot bookkeeping (positions, free list, queue) is host-side state
    owned here; all device work lives in the executor, on ``device``
    (default the GPU; raises without one). Every decode, steady-state
    and prefill alike, runs with the full per-slot position vector and a
    ``live`` mask, so a request that joins mid-flight decodes at *its*
    cache depth and its prefill cannot clobber slots that are further
    along.
    """

    def __init__(self, cfg, sc: ServeConfig, params: Optional[dict] = None,
                 executor: Optional[ModelExecutor] = None, device=None):
        self.cfg = cfg
        self.sc = sc
        dtype = (torch.float32 if sc.compute_dtype == "float32"
                 else torch.bfloat16)
        self.dtype = dtype
        self.executor = executor if executor is not None else ModelExecutor(
            cfg, sc.max_batch, sc.max_seq, dtype=dtype, params=params,
            seed=sc.seed, device=device)
        self.params = self.executor.params
        self.positions = np.zeros(sc.max_batch, np.int32)
        self.free = list(range(sc.max_batch))
        self.active: dict[int, Request] = {}
        self.queue: deque[Request] = deque()

    # ------------------------------------------------------------------
    def _prefill_slot(self, slot: int, prompt: np.ndarray):
        """Sequential prefill into one slot via the decode path. Only this
        slot is live: neighbours' caches (attention K/V and SSM state)
        commit nothing while the joiner catches up."""
        live = np.zeros(self.sc.max_batch, bool)
        live[slot] = True
        logits = None
        for t in prompt:
            tok = np.zeros((self.sc.max_batch, 1), np.int32)
            tok[slot, 0] = t
            logits = self.executor.decode(tok, self.positions, live)
            self.positions[slot] += 1
        return logits

    def enqueue(self, req: Request) -> None:
        """Queue a request; it joins mid-flight at the next step boundary."""
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        self.queue.append(req)

    def submit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot now. False when no slot is
        free; raises ``ValueError`` on an empty prompt. A prefill failure
        rolls the slot back to the free list before propagating."""
        prompt = np.asarray(req.prompt)
        if prompt.size == 0:
            raise ValueError(
                f"request {req.rid}: empty prompt — prompts must contain "
                "at least one token")
        if not self.free:
            return False
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        slot = self.free.pop()
        self.positions[slot] = 0
        req._slot = slot
        self.active[slot] = req
        try:
            self._prefill_slot(slot, prompt)
        except Exception as e:
            # roll the slot back AND mark the request terminally failed:
            # callers holding the request object see what happened even
            # if they swallow the re-raise; its latency fields close out
            del self.active[slot]
            self.positions[slot] = 0
            self.free.append(slot)
            req.failed = True
            req.error = repr(e)
            req.t_done = time.perf_counter()
            raise
        return True

    def step(self) -> None:
        """Admit queued joiners, then one decode over all active slots,
        each at its own position."""
        while self.queue and self.free:
            self.submit(self.queue.popleft())
        if not self.active:
            return
        tok = np.zeros((self.sc.max_batch, 1), np.int32)
        live = np.zeros(self.sc.max_batch, bool)
        for slot, req in self.active.items():
            prev = (req.out_tokens[-1] if req.out_tokens
                    else int(np.asarray(req.prompt)[-1]))
            tok[slot, 0] = prev
            live[slot] = True
        logits = self.executor.decode(tok, self.positions, live)
        now = time.perf_counter()
        done_slots = []
        for slot, req in self.active.items():
            nxt = int(np.argmax(logits[slot, 0, : self.cfg.vocab]))
            req.out_tokens.append(nxt)
            if req.t_first is None:
                req.t_first = now
            self.positions[slot] += 1
            if (len(req.out_tokens) >= self.sc.max_new_tokens
                    or self.positions[slot] >= self.sc.max_seq - 1):
                req.done = True
                req.t_done = now
                done_slots.append(slot)
        for slot in done_slots:
            del self.active[slot]
            self.free.append(slot)

    def run(self, requests: list[Request]) -> dict:
        t0 = time.perf_counter()
        for r in requests:
            self.enqueue(r)
        steps = 0
        while self.queue or self.active:
            self.step()
            steps += 1
            if steps > self.sc.max_steps:
                raise RuntimeError(f"serving did not terminate within "
                                   f"{self.sc.max_steps} steps")
            if self.sc.max_wall_s is not None and \
                    time.perf_counter() - t0 > self.sc.max_wall_s:
                raise RuntimeError(f"serving did not terminate within "
                                   f"{self.sc.max_wall_s}s")
        wall = time.perf_counter() - t0
        total_tokens = sum(len(r.out_tokens) for r in requests)
        lats = sorted(r.latency_s for r in requests
                      if r.latency_s is not None)
        return {"requests": len(requests), "tokens": total_tokens,
                "wall_s": wall, "tok_per_s": total_tokens / max(wall, 1e-9),
                "decode_steps": steps,
                "latency_p50_s": _percentile(lats, 50),
                "latency_p99_s": _percentile(lats, 99),
                "latency_per_request_s": lats}


# ----------------------------- matvec plane ---------------------------------

@dataclasses.dataclass
class MatvecRequest:
    """One SpMV request: x (n_cols,) in, y (n_rows,) out.

    ``status`` is the request's terminal disposition: ``"pending"`` while
    queued/in-flight, then exactly one of ``"ok"`` (y is valid),
    ``"rejected"`` (backpressure — never accepted; retry after
    ``retry_after_s``), ``"timeout"`` (deadline expired in queue), or
    ``"failed"`` (executor error after retries; ``error`` holds it).
    """
    rid: int
    x: np.ndarray
    y: Optional[np.ndarray] = None
    deadline_s: Optional[float] = None   # max seconds from submit to start
    status: str = "pending"
    error: Optional[str] = None
    retry_after_s: Optional[float] = None
    t_submit: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_submit is None or self.t_done is None:
            return None
        return self.t_done - self.t_submit


class SpmvEngine:
    """Request loop around ``SparseLinear.from_plan`` (via PlanExecutor).

    Scheduling: a FIFO queue drained in ragged batches — each step takes
    up to the executor's top bucket, pads to the nearest bucket, and
    dispatches. Hot-swap: ``step()`` polls the executor's PlanStore watch
    *between* batches, so a swap never lands mid-batch and serving never
    pauses (``hot_swaps`` counts them; plans failing admission are
    rejected by the executor and the old plan keeps serving). An asyncio
    surface (``submit_async`` + ``serve_forever``) makes it an async
    request loop; the sync ``run`` is the closed-loop path benchmarks
    drive.

    Degraded-mode serving: ``max_queue`` bounds the queue — requests past
    it are *rejected* with a ``retry_after_s`` hint instead of growing an
    unbounded backlog; per-request deadlines expire stale queue entries
    with an explicit ``"timeout"`` status; a transient executor exception
    is retried with exponential backoff (``max_retries``), and a batch
    whose retries are exhausted gets ``"failed"`` responses — every
    accepted request always reaches a terminal status, nothing is
    silently dropped. ``health`` reports the state machine
    (``healthy -> degraded -> failed``): any executor failure degrades,
    exhausted retries fail, and ``heal_after`` consecutive clean steps
    promote one level back. An optional ``ft.FaultToleranceManager``
    receives per-step heartbeats; its straggler reports mark stuck steps
    (``stuck_steps``) and degrade health.
    """

    def __init__(self, executor: PlanExecutor,
                 max_queue: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.02,
                 heal_after: int = 3, ft=None):
        self.executor = executor
        self.queue: deque[MatvecRequest] = deque()
        self.completed = 0
        self.hot_swaps = 0
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.heal_after = heal_after
        self.ft = ft
        self.health = "healthy"
        self.accepted = 0
        self.rejected = 0
        self.timed_out = 0
        self.failed = 0
        self.stuck_steps = 0
        self.recovery_latencies: list[float] = []
        self._clean_streak = 0
        self._step_idx = 0
        self._last_step_s: Optional[float] = None
        self._rid = 0
        self._running = False

    # -- admission ---------------------------------------------------------
    def _retry_after(self) -> float:
        """Backpressure hint: roughly how long until queue space frees
        up — one bucket-drain per step at the recent step time."""
        per_step = self._last_step_s if self._last_step_s else 0.01
        steps = max(1, len(self.queue) // max(self.executor.max_bucket, 1))
        return steps * per_step

    def enqueue(self, req: MatvecRequest) -> bool:
        """Admit a request. False = rejected by backpressure: the queue
        is at ``max_queue``, ``req.status`` becomes ``"rejected"`` and
        ``req.retry_after_s`` estimates when to retry."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            req.status = "rejected"
            req.retry_after_s = self._retry_after()
            req.error = (f"queue full ({self.max_queue}); "
                         f"retry after {req.retry_after_s:.3f}s")
            self.rejected += 1
            return False
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        if req.deadline_s is None:
            req.deadline_s = self.default_deadline_s
        self.accepted += 1
        self.queue.append(req)
        return True

    def _expire_deadlines(self) -> list[MatvecRequest]:
        """Expire queued requests whose deadline passed; they get an
        explicit timeout response instead of going stale in line."""
        now = time.perf_counter()
        expired = []
        keep = deque()
        for r in self.queue:
            if (r.deadline_s is not None and r.t_submit is not None
                    and now - r.t_submit > r.deadline_s):
                r.status = "timeout"
                r.error = (f"deadline {r.deadline_s}s expired after "
                           f"{now - r.t_submit:.3f}s in queue")
                r.t_done = now
                self.timed_out += 1
                expired.append(r)
            else:
                keep.append(r)
        self.queue = keep
        return expired

    def _note_clean_step(self) -> None:
        self._clean_streak += 1
        if self._clean_streak >= self.heal_after and \
                self.health != "healthy":
            self.health = ("degraded" if self.health == "failed"
                           else "healthy")
            self._clean_streak = 0

    def _degrade(self, to: str) -> None:
        order = ("healthy", "degraded", "failed")
        if order.index(to) > order.index(self.health):
            self.health = to
        self._clean_streak = 0

    def step(self) -> list[MatvecRequest]:
        """One scheduling step: maybe hot-swap, expire stale requests,
        then drain one bucket. Returns every request that reached a
        terminal status this step (completed, timed out, or failed)."""
        t_step = time.perf_counter()
        if self.executor.maybe_reload():
            self.hot_swaps += 1
        terminal = self._expire_deadlines()
        if not self.queue:
            return terminal
        take = min(len(self.queue), self.executor.max_bucket)
        batch = [self.queue.popleft() for _ in range(take)]
        xs = np.stack([r.x for r in batch])
        ys, err = None, None
        t_fail = None
        for attempt in range(self.max_retries + 1):
            try:
                ys = self.executor.execute(xs)
                break
            except Exception as e:
                err = e
                if t_fail is None:
                    t_fail = time.perf_counter()
                self._degrade("degraded")
                if attempt < self.max_retries:
                    time.sleep(self.retry_backoff_s * (2 ** attempt))
        now = time.perf_counter()
        if ys is not None:
            if t_fail is not None:
                # transient failure recovered by retry: how long the
                # batch was stalled is the recovery latency
                self.recovery_latencies.append(now - t_fail)
            for r, y in zip(batch, ys):
                r.y = y
                r.status = "ok"
                r.t_done = now
            self.completed += len(batch)
            if t_fail is None:
                self._note_clean_step()
        else:
            # retries exhausted: explicit failure responses, never a drop
            self._degrade("failed")
            for r in batch:
                r.status = "failed"
                r.error = repr(err)
                r.t_done = now
            self.failed += len(batch)
        terminal.extend(batch)
        self._step_idx += 1
        step_s = time.perf_counter() - t_step
        self._last_step_s = step_s
        if self.ft is not None:
            rep = self.ft.observe_step("spmv-engine", self._step_idx, step_s)
            if rep is not None:
                self.stuck_steps += 1
                self._degrade("degraded")
        return terminal

    def run(self, requests: list[MatvecRequest],
            max_steps: Optional[int] = None) -> dict:
        """Drain a request list to completion; per-request latency stats.

        Every request ends in a terminal status — rejected ones never
        enter the queue, accepted ones complete, time out, or fail with
        an explicit error. ``dropped`` (always 0 unless there is an
        engine bug) counts accepted requests left without a terminal
        status."""
        t0 = time.perf_counter()
        for r in requests:
            self.enqueue(r)
        steps = 0
        while self.queue:
            self.step()
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(f"serving did not terminate within "
                                   f"{max_steps} steps")
        wall = time.perf_counter() - t0
        lats = sorted(r.latency_s for r in requests
                      if r.status == "ok" and r.latency_s is not None)
        dropped = sum(r.status == "pending" for r in requests)
        return {"requests": len(requests), "wall_s": wall,
                "throughput_rps": len(requests) / max(wall, 1e-9),
                "hot_swaps": self.hot_swaps,
                "rejected_swaps": self.executor.rejected_swaps,
                "accepted": self.accepted, "rejected": self.rejected,
                "completed_ok": sum(r.status == "ok" for r in requests),
                "timed_out": self.timed_out, "failed": self.failed,
                "dropped": dropped, "health": self.health,
                "stuck_steps": self.stuck_steps,
                "recovery_latency_max_s": (max(self.recovery_latencies)
                                           if self.recovery_latencies
                                           else 0.0),
                "latency_p50_s": _percentile(lats, 50),
                "latency_p99_s": _percentile(lats, 99)}

    # -- async surface -----------------------------------------------------
    def submit_async(self, x: np.ndarray, rid: Optional[int] = None,
                     deadline_s: Optional[float] = None) -> "asyncio.Future":
        """Enqueue from a running event loop; resolves to y on success.
        A rejected (backpressure), timed-out, or failed request resolves
        to a ``RuntimeError`` carrying the explicit error instead."""
        loop = asyncio.get_running_loop()
        self._rid += 1
        req = MatvecRequest(rid if rid is not None else self._rid,
                            np.asarray(x), deadline_s=deadline_s)
        req._future = loop.create_future()
        if not self.enqueue(req):
            req._future.set_exception(RuntimeError(req.error))
        return req._future

    async def serve_forever(self, idle_sleep_s: float = 1e-3) -> None:
        """Async request loop: drain in bucketed steps, yielding control
        between steps so new submissions join mid-flight. Stop with
        :meth:`shutdown`."""
        self._running = True
        try:
            while self._running:
                for r in self.step():
                    fut = getattr(r, "_future", None)
                    if fut is not None and not fut.done():
                        if r.status == "ok":
                            fut.set_result(r.y)
                        else:
                            fut.set_exception(RuntimeError(
                                r.error or f"request {r.rid} {r.status}"))
                await asyncio.sleep(0 if self.queue else idle_sleep_s)
        finally:
            self._running = False

    def shutdown(self) -> None:
        self._running = False
