"""Tokenized data pipeline: shard-aware sources + background prefetch.

Port of ``repro/data/pipeline.py``, which is numpy only: a copy, so the
port imports nothing of the JAX package, and for the same seed, shard and
shapes the batches are the reference's. Batches stay numpy on the host;
the trainer moves each one to its device.

Synthetic source = a deterministic Zipfian token stream (seeded per data
shard so shards are disjoint); memmap source reads packed token files. The
prefetcher keeps ``depth`` batches in flight on a worker thread — the
straggler-mitigation lever at the input layer (a slow storage read never
stalls the step while the queue is non-empty).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


class SyntheticLM:
    """Deterministic Zipf-ish LM stream: batch["tokens"/"labels"] (B,S[,K])."""

    def __init__(self, vocab: int, batch: int, seq: int, *, codebooks: int = 1,
                 shard: int = 0, n_shards: int = 1, seed: int = 0):
        if batch % n_shards:
            raise ValueError("batch must divide by n_shards")
        self.vocab, self.batch, self.seq = vocab, batch // n_shards, seq
        self.codebooks = codebooks
        self.rng = np.random.default_rng(seed * 1009 + shard)
        # Zipf-like marginal so losses behave like text, capped to vocab
        ranks = np.arange(1, min(vocab, 50_000) + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.p = p / p.sum()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            shape = (self.batch, self.seq + 1)
            if self.codebooks > 1:
                shape += (self.codebooks,)
            ids = self.rng.choice(len(self.p), size=shape, p=self.p
                                  ).astype(np.int32)
            yield {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


class MemmapLM:
    """Packed int32 token file -> (B,S) batches, disjoint per shard."""

    def __init__(self, path: str, batch: int, seq: int, *, shard: int = 0,
                 n_shards: int = 1):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.batch = batch // n_shards
        self.seq = seq
        per = len(self.tokens) // n_shards
        self.lo, self.hi = shard * per, (shard + 1) * per
        self.cursor = self.lo

    def __iter__(self):
        span = self.batch * (self.seq + 1)
        while True:
            if self.cursor + span > self.hi:
                self.cursor = self.lo
            chunk = np.asarray(self.tokens[self.cursor:self.cursor + span])
            self.cursor += span
            ids = chunk.reshape(self.batch, self.seq + 1)
            yield {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


class Prefetcher:
    """Background-thread prefetch queue (depth batches in flight)."""

    def __init__(self, source, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def work():
            for item in source:
                if self._stop.is_set():
                    return
                self.q.put(item)

        self.t = threading.Thread(target=work, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
