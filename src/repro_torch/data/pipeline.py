"""Deterministic, shard-aware synthetic token pipeline (a copy of
``repro.data.pipeline``: numpy only, and ``batch_at`` gives the
reference's bits for any seed, step and shard).

Design goals (large-scale runnability):
  * **restart-idempotent** — batch content is a pure function of
    (seed, step, shard), so a restarted job resumes mid-stream with no
    duplicated or skipped data;
  * **shard-aware** — each data-parallel host generates only its slice;
  * **prefetch** — a background thread keeps ``prefetch`` batches ready so
    host-side generation overlaps device compute.

Tokens follow a Zipf distribution with a deterministic per-sequence
"topic" bias — enough structure that a ~100M model's loss visibly drops
within a few hundred steps.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticTokenPipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    n_topics: int = 64
    prefetch: int = 2


class SyntheticTokenPipeline:
    def __init__(self, cfg: DataConfig, shard_index: int = 0,
                 n_shards: int = 1):
        assert cfg.global_batch % n_shards == 0
        self.cfg = cfg
        self.shard_index = shard_index
        self.n_shards = n_shards
        self.local_batch = cfg.global_batch // n_shards
        # fixed topic->token bias tables (derived from the seed only)
        rng = np.random.default_rng(cfg.seed)
        self._topic_shift = rng.integers(0, cfg.vocab,
                                         cfg.n_topics).astype(np.int64)
        self._queue: "queue.Queue[tuple[int, dict]]" = queue.Queue(
            maxsize=max(cfg.prefetch, 1))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- pure function of (seed, step, shard): the idempotency contract --
    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + self.shard_index)
        shape = (self.local_batch, cfg.seq_len + 1)
        raw = rng.zipf(cfg.zipf_a, size=shape).astype(np.int64)
        topic = rng.integers(0, cfg.n_topics, (self.local_batch, 1))
        toks = (raw + self._topic_shift[topic]) % cfg.vocab
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    # -- prefetching iterator --
    def _worker(self, start_step: int):
        step = start_step
        while not self._stop.is_set():
            batch = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._queue.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def iterate(self, start_step: int = 0) -> Iterator[tuple[int, dict]]:
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker,
                                        args=(start_step,), daemon=True)
        self._thread.start()
        try:
            while True:
                yield self._queue.get()
        finally:
            self.close()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            while not self._queue.empty():
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=2.0)
            self._thread = None
