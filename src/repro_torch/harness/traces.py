"""Seeded fio-style trace generation: a replayable byte-addressed op stream.

Port of ``repro/harness/traces.py``: pure numpy, with the reference's draw
order, so the same seed gives the same op list and the same payloads.

A *trace* is the load half of a harness run: a fixed list of ``TraceOp``
records, fully determined by ``(trace_seed, TraceConfig, geometry)``, that
the runner replays against the public ``VolumeManager`` API. The knobs
mirror the fio axes the paper benchmarks with (§IV) plus the ones it
doesn't:

- **read fraction** (``read_frac``) — fio's ``rwmixread``,
- **seq/rand mix** (``seq_frac``) — each volume keeps a sequential cursor;
  with probability ``seq_frac`` an op continues it, otherwise it jumps to
  a zipf-hot random page,
- **zipf hotness** (``zipf_a``) — page *and* volume popularity follow a
  zipf law (rank weights ``1/rank^a``), with a per-volume page permutation
  so hot sets differ across volumes; ``zipf_a=0`` is uniform,
- **burst arrivals** (``mean_burst``) — ops arrive in geometric-length
  bursts; the runner submits a whole burst asynchronously and flushes at
  the burst boundary (``last_in_burst``), so queue depth varies the way
  open-loop arrival processes make it vary,
- **span sizes** (``max_span_blocks``, ``unaligned_frac``) — multi-block
  byte spans, a fraction of them deliberately NOT block-aligned so the
  in-API read-modify-write path stays under load.

Write payloads are a pure function of ``(trace_seed, op index)``
(``payload_bytes``) so the oracle never stores them twice and a replay is
byte-identical by construction.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass(frozen=True)
class TraceConfig:
    """The fio-style workload axes (module docstring). Geometry — block
    size, page size, page count — is the runner's, passed to
    ``generate_trace`` separately so one config drives many geometries."""

    n_ops: int = 200
    n_volumes: int = 4
    read_frac: float = 0.4
    seq_frac: float = 0.3
    unaligned_frac: float = 0.1
    zipf_a: float = 1.1
    mean_burst: int = 8
    max_span_blocks: int = 4


@dataclass(frozen=True)
class TraceOp:
    """One replayable op. ``vol`` is a trace-local volume index (the runner
    maps it to the ``Volume`` handle it created); ``off``/``nbytes`` are
    byte-addressed; ``last_in_burst`` marks the flush boundary."""

    index: int
    kind: str          # "write" | "read"
    vol: int
    off: int
    nbytes: int
    last_in_burst: bool


def zipf_weights(n: int, a: float) -> np.ndarray:
    """Normalized zipf rank weights ``1/rank^a`` (uniform at ``a=0``)."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** a
    return w / w.sum()


def payload_bytes(trace_seed: int, index: int, nbytes: int) -> bytes:
    """The write payload of op ``index`` — a cheap deterministic pattern
    (mod a prime so every byte stays 0..250, distinguishable from the
    zero-fill holes/discards produce)."""
    base = (trace_seed * 7919 + index * 131) % 251
    return bytes((base + i * 7) % 251 for i in range(nbytes))


def generate_trace(trace_seed: int, cfg: TraceConfig, *, block_bytes: int,
                   page_blocks: int, n_pages: int) -> List[TraceOp]:
    """Generate the replayable op stream for one harness run.

    Deterministic in ``(trace_seed, cfg, geometry)``: the same inputs give
    the same list, which is what makes ``(trace_seed, chaos_seed)`` a full
    run identifier (the replay-determinism gate relies on it)."""
    rng = np.random.default_rng(trace_seed)
    page_bytes = block_bytes * page_blocks
    capacity = n_pages * page_bytes
    vol_w = zipf_weights(cfg.n_volumes, cfg.zipf_a)
    page_w = zipf_weights(n_pages, cfg.zipf_a)
    # per-volume page permutation: volume v's hottest page is perms[v][0]
    perms = [rng.permutation(n_pages) for _ in range(cfg.n_volumes)]
    cursors = [0] * cfg.n_volumes          # sequential byte cursors
    ops: List[TraceOp] = []
    burst_left = int(rng.geometric(1.0 / max(cfg.mean_burst, 1)))
    for i in range(cfg.n_ops):
        vol = int(rng.choice(cfg.n_volumes, p=vol_w))
        kind = "read" if rng.random() < cfg.read_frac else "write"
        nblocks = int(rng.integers(1, cfg.max_span_blocks + 1))
        nbytes = nblocks * block_bytes
        if rng.random() < cfg.seq_frac:
            off = cursors[vol]
        else:
            page = int(perms[vol][int(rng.choice(n_pages, p=page_w))])
            off = page * page_bytes + int(
                rng.integers(0, page_blocks)) * block_bytes
        if rng.random() < cfg.unaligned_frac:
            off += int(rng.integers(1, block_bytes))
            nbytes = max(1, nbytes - int(rng.integers(1, block_bytes)))
        if off + nbytes > capacity:        # wrap instead of clipping spans
            off = 0
        cursors[vol] = (off + nbytes) % max(capacity - nbytes, 1)
        burst_left -= 1
        last = burst_left <= 0 or i == cfg.n_ops - 1
        if last:
            burst_left = int(rng.geometric(1.0 / max(cfg.mean_burst, 1)))
        ops.append(TraceOp(index=i, kind=kind, vol=vol, off=off,
                           nbytes=nbytes, last_in_burst=last))
    return ops
