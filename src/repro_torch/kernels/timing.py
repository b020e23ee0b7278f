"""Device timing of kernel launches on the card: the one yardstick behind
every kernel time that ``chip_smoke.py``, ``kernels.compare`` and
``kernels.flash_attention.phase_costs`` print.

``graph_ms`` times a pass of launches captured once in a CUDA graph, so
host launch gaps do not count; ``queued_ms`` times the same pass launched
eagerly while a spin kernel holds the card, so the launches queue up and
run back to back as an eager caller's do when the card is behind.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


def graph_ms(fn: Callable[[], object], n_items: int,
             passes: int = 20) -> float:
    """Median device time per item of ``fn()`` (one pass over ``n_items``
    launches), captured once in a CUDA graph; ``passes`` timed replays
    after a warm-up."""
    fn()                                         # warm-up outside capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(passes):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n_items)
    del g
    return statistics.median(times)


def queued_ms(fn: Callable[[], object], n_items: int,
              passes: int = 20) -> float:
    """Median device time per item of one eager pass ``fn()``: a spin
    kernel holds the card for three times as long as the host takes to
    queue the pass, so the launches run back to back."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    hold = int(3 * (time.perf_counter() - t) * 2e9)   # cycles at <= 2 GHz
    torch.cuda.synchronize()
    times = []
    for _ in range(passes):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n_items)
    return statistics.median(times)
