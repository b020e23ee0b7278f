"""Plain PyTorch versions of the ``dbs_rw`` kernels.

Port of the rw half of ``repro/kernels/dbs/ref.py``. They mirror the
kernels' row-composition formulation (one composed row per routed lane):
the ``ref`` kernel-registry entry runs them on any device, the kernel
wrappers (rw_kernel.py) run them for tensors on the CPU, and the tests and
``chip_smoke.py`` hold the CUDA kernels against them on the card.
"""
from __future__ import annotations

import torch


def dbs_rw_write_ref(pool, src, dst, lane_of, payload):
    """Row composition, in place: for lane i, ``pool[dst[i]]`` becomes
    ``pool[src[i]]`` with block j replaced by ``payload[lane_of[i, j]]``
    wherever ``lane_of[i, j] >= 0``. Inputs must be pre-routed
    (ops.py ``_route_writes``): live rows are named by exactly one lane, and
    dump-routed lanes compose a no-op (src == dst, lane_of -1), so every
    duplicate index of the scatter writes one value. All rows are composed
    before any is stored. Returns ``pool``."""
    take = lane_of >= 0                                       # (B, page)
    rows = payload[lane_of.clamp(min=0).long()]               # (B, page, D)
    vals = torch.where(take[..., None], rows, pool[src.clamp(min=0).long()])
    pool[dst.clamp(min=0).long()] = vals
    return pool


def dbs_rw_read_ref(pool, ext, block):
    """Hole-masked block gather: ``pool[ext[i], block[i]]`` with clamped
    ids, zeros where the raw ``ext[i] < 0``."""
    e, page = pool.shape[:2]
    got = pool[ext.clamp(0, e - 1).long(), block.clamp(0, page - 1).long()]
    return torch.where((ext >= 0)[:, None], got, 0)
