"""Plain PyTorch versions of the DBS kernels.

Port of ``repro/kernels/dbs/ref.py``. The rw versions mirror the kernels'
row-composition formulation (one composed row per routed lane): the ``ref``
kernel-registry entry runs them on any device. The kernel wrappers
(rw_kernel.py, copy_kernel.py) run these versions for tensors on the CPU,
and the tests and ``chip_smoke.py`` hold the CUDA kernels against them on
the card.
"""
from __future__ import annotations

import torch


def dbs_copy_ref(pool, src, dst, mask):
    """CoW extent copy, in place: ``pool[dst[i]] = pool[src[i]]`` for every
    lane with ``mask[i]`` whose ``src`` and ``dst`` lie in ``[0, E)``; every
    other lane copies nothing (the kernel skips it). Returns ``pool``.

    Live lanes must have distinct ``dst`` and no live ``src`` may be another
    live lane's ``dst`` (``dbs.write_pages`` guarantees both); all source
    rows are gathered before any is stored. The copy is one gather and one
    scatter with no host sync: a lane that copies nothing targets its
    clamped ``dst`` row with the value the highest live lane of that row
    stores there (``dbs.last_live_lane``), or with the row's own contents
    where no live lane does, so every duplicate index of the scatter writes
    one value. (The JAX reference writes a masked lane's own contents, which
    loses a live copy into the same row when the masked lane comes later:
    ROADMAP queue 3.)
    """
    from repro_torch.core.dbs import last_live_lane
    e = pool.shape[0]
    live = (mask.bool() & (src >= 0) & (src < e) & (dst >= 0) & (dst < e))
    row = dst.clamp(0, e - 1).long()
    win = last_live_lane(row, live)
    take = torch.where(win >= 0, src[win.clamp(min=0)].long(), row)
    pool[row] = pool[take.clamp(0, e - 1)]
    return pool


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
