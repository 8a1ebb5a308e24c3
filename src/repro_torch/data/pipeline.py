"""Deterministic sharded synthetic token pipeline with prefetch.

The data path is itself expressed as Drops in the training logical graph
(Scatter over shards -> per-shard reader components); this module is the
payload those Application Drops run.  Determinism: batch ``i`` of shard
``s`` is a pure function of (seed, s, i) — re-execution after failure or
speculative duplication yields identical bytes, which is what makes the
engine's lineage recovery and first-wins straggler commits sound.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


def synthetic_batch(seed: int, shard: int, index: int, batch: int,
                    seq_len: int, vocab: int) -> Dict[str, np.ndarray]:
    """Pure function -> {tokens, labels} (labels = next-token shifted)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, shard, index]))
    # run-length stream: each token repeats the previous with p=0.7, else a
    # fresh draw -> entropy ~= 0.3*ln(V) + H(0.7), far below uniform ln(V),
    # so the "copy previous token" rule is learnable in a few hundred steps
    n = seq_len + 1
    base = rng.integers(0, vocab, size=(batch, n), dtype=np.int64)
    fresh = rng.random((batch, n)) >= 0.7
    fresh[:, 0] = True
    src_idx = np.where(fresh, np.arange(n)[None, :], 0)
    src_idx = np.maximum.accumulate(src_idx, axis=1)
    toks = np.take_along_axis(base, src_idx, axis=1).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclass
class PipelineConfig:
    seed: int
    num_shards: int
    shard: int
    batch: int
    seq_len: int
    vocab: int
    prefetch: int = 2


class ShardedTokenPipeline:
    """Background-prefetching iterator over one shard's batches."""

    def __init__(self, cfg: PipelineConfig) -> None:
        self.cfg = cfg
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._index = 0
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        i = 0
        while not self._stop.is_set():
            b = synthetic_batch(self.cfg.seed, self.cfg.shard, i,
                                self.cfg.batch, self.cfg.seq_len,
                                self.cfg.vocab)
            while not self._stop.is_set():
                try:
                    self._q.put((i, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            i += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        i, b = self._q.get()
        self._index = i
        return b

    def close(self) -> None:
        self._stop.set()
