"""Deterministic synthetic token pipeline with host sharding + prefetch.

Copy of ``repro/data/pipeline.py`` (pure numpy): ``SyntheticLM.batch`` is
bitwise the reference's for every (seed, step, host_index, host_count).

The stream is a pure function of (seed, step): restart/elastic-rescale
replay exactly the same global batches regardless of host count — host h of
H loads rows [h*B/H, (h+1)*B/H) of the global batch.  A background thread
prefetches `prefetch` steps ahead (double buffering the host->device copy).

"Synthetic" = mixture of Zipf-distributed unigrams with Markov bigram
structure, enough to give language-model training a non-trivial, seedable
loss surface without external data.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    host_index: int = 0
    host_count: int = 1


class SyntheticLM:
    """Deterministic-by-step synthetic LM batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.host_count == 0
        self.local_batch = cfg.global_batch // cfg.host_count
        rng = np.random.default_rng(cfg.seed)
        # fixed random bigram shift: x_{t+1} ~ zipf perm[x_t]
        self._perm = rng.permutation(cfg.vocab)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) & 0x7FFFFFFF)
        b = cfg.global_batch
        toks = rng.choice(cfg.vocab, size=(b, cfg.seq_len + 1), p=self._p)
        # overlay bigram structure on half the positions
        mask = rng.random((b, cfg.seq_len)) < 0.5
        nxt = self._perm[toks[:, :-1]]
        toks[:, 1:] = np.where(mask, nxt, toks[:, 1:])
        lo = self.cfg.host_index * self.local_batch
        hi = lo + self.local_batch
        return {"tokens": toks[lo:hi, :-1].astype(np.int32),
                "labels": toks[lo:hi, 1:].astype(np.int32)}


class Prefetcher:
    """Background prefetch of the next `depth` steps."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2, put_fn=None):
        self._source = source
        self._put = put_fn or (lambda x: x)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._put(self._source.batch(step))
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
