"""Deterministic synthetic data pipeline (no external datasets in this
container), designed like a production loader:

* **step-addressable**: ``batch_at(step)`` is a pure function of (seed, step,
  host_id) — after a checkpoint restart the stream resumes exactly, and a
  re-shard after an elastic resize changes only the host partitioning, not
  the logical stream;
* **host-sharded**: each host materializes only its slice of the global
  batch (``host_id/num_hosts``);
* **prefetching**: a background thread keeps ``depth`` batches ahead.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    vocab: int = 512
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


class SyntheticLMDataset:
    """Markov-ish synthetic token stream with learnable structure (so loss
    actually decreases in the example drivers)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed random bigram table: next ~ (cur * a + b) % vocab with noise
        self._a = int(rng.integers(3, 97)) | 1
        self._b = int(rng.integers(0, cfg.vocab))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 131 + cfg.host_id)
        b, s, v = cfg.host_batch, cfg.seq_len, cfg.vocab
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        noise = rng.random((b, s)) < 0.1
        rand = rng.integers(0, v, (b, s))
        for t in range(s):
            nxt = (toks[:, t] * self._a + self._b) % v
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class SyntheticImageDataset:
    """Random images + labels for the CNN pipelines."""

    def __init__(self, cfg: DataConfig, hw: int = 64, channels: int = 3,
                 classes: int = 10):
        self.cfg, self.hw, self.channels, self.classes = cfg, hw, channels, classes

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 131 + cfg.host_id)
        x = rng.normal(size=(cfg.host_batch, self.hw, self.hw,
                             self.channels)).astype(np.float32)
        y = rng.integers(0, self.classes, cfg.host_batch).astype(np.int32)
        return {"images": x, "labels": y}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def prefetch(it: Iterator[Any], depth: int = 2) -> Iterator[Any]:
    """Background-thread prefetching iterator."""
    q: queue.Queue = queue.Queue(depth)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        yield item
