"""The compute phase: storage functions against the device-resident pools.

Port of ``repro/compute/phase.py``. ``VolumeView`` is what a storage
function reads: the hole-masked lanes of one volume, gathered on demand in
page chunks (``chunks``) or as one block (``block``) through the DBS
kernel registry's read, so never-written and unmapped pages read as zeros,
as a read request does. The reference builds the whole ``(P, page_blocks,
*S)`` view of the volume for every lane; at a 1 GiB volume that is 4.3 GB
of float32 lanes before the byte math widens it, so the port gathers only
the addressed pages, ``CHUNK_BYTES`` of lanes at a time.

A view reads ONE replica. Given a one-hot ``sel`` over the shard's
replicas (a device tensor: the first healthy replica under the pump's
health mask), each replica's read is routed like the sharded step's
(``fused.read_routes``): the selected replica's lanes carry the extents,
the others are holes, which the hand-written read kernel skips without a
load, so the gather reads each block once and nothing comes back to the
host.

``apply_compute_ops`` runs one shard's compute lanes of a ring batch in
lane order. Each lane's function id, address and argument are host ints
(the staged lanes, ``RingFrontend._stage``), so the host picks the entry
and the device runs it: no branch table, no switch. The one writing
function a batch may hold (the drain closes the compute window on it)
reports its commit as a (lane, do_write) pair; the ring step commits it
through the data phase's write (core/ring.py).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.compute import registry as sfns

# float32 lanes gathered at a time by ``VolumeView.chunks``: 64 pages of
# the block device's 512 KiB-of-lanes pages; the int64 byte math then
# holds a few such chunks, a small share of one 6.4 GB pool
CHUNK_BYTES = 32 << 20


class VolumeView:
    """Hole-masked lanes of volume ``vol`` on one shard's replicas.

    ``tables``: each replica's (V, P) extent map; ``pools``: each replica's
    (E+1, page_blocks, *S) pool; ``kern``: the ``DBSKernel`` whose ``read``
    gathers; ``sel``: None (read replica 0) or an (R,) one-hot bool tensor
    naming the replica to read. ``vol`` is a host int in range."""

    def __init__(self, tables: Sequence[torch.Tensor],
                 pools: Sequence[torch.Tensor], vol: int, kern,
                 sel: Optional[torch.Tensor] = None):
        self.tables, self.pools = list(tables), list(pools)
        self.vol = vol
        self.kern = kern
        self.sel = sel
        pool = self.pools[0]
        self.device = pool.device
        self.n_pages = self.tables[0].shape[1]
        self.page_blocks = pool.shape[1]
        self.payload_shape = tuple(pool.shape[2:])
        page_bytes = pool[0].numel() * pool.element_size()
        self.chunk_pages = max(1, CHUNK_BYTES // page_bytes)

    def _ext(self, lo: int, hi: int) -> torch.Tensor:
        """The selected replica's extents of pages [lo, hi)."""
        rows = [t[self.vol, lo:hi] for t in self.tables]
        if self.sel is None:
            return rows[0]
        out = rows[0]
        for r in range(1, len(rows)):
            out = torch.where(self.sel[r], rows[r], out)
        return out

    def _gather(self, ext: torch.Tensor, blocks: torch.Tensor
                ) -> torch.Tensor:
        """One block a lane (holes zero) from the selected replica."""
        if self.sel is None:
            return self.kern.read(self.pools[0], ext, blocks)
        out = None
        for r, pool in enumerate(self.pools):
            vals = self.kern.read(pool, torch.where(self.sel[r], ext, -1),
                                  blocks)
            out = vals if out is None else torch.where(self.sel[r], vals,
                                                       out)
        return out

    def chunks(self, lo: int, hi: int
               ) -> Iterator[Tuple[int, torch.Tensor]]:
        """``(first page, (n, page_blocks, *S) lanes)`` over pages [lo, hi)
        clipped to the volume, ``chunk_pages`` pages at a time."""
        lo, hi = max(lo, 0), min(hi, self.n_pages)
        pb = self.page_blocks
        for p0 in range(lo, hi, self.chunk_pages):
            p1 = min(p0 + self.chunk_pages, hi)
            n = p1 - p0
            ext = self._ext(p0, p1).repeat_interleave(pb)
            blocks = torch.arange(pb, dtype=torch.int32,
                                  device=self.device).repeat(n)
            yield p0, self._gather(ext, blocks).view(
                (n, pb) + self.payload_shape)

    def block(self, page: int, block: int) -> torch.Tensor:
        """One block's (*S) lanes, the address clamped to the volume (as
        the reference clamps; callers validate addresses)."""
        page = min(max(page, 0), self.n_pages - 1)
        block = min(max(block, 0), self.page_blocks - 1)
        ext = self._ext(page, page + 1)
        blocks = torch.full((1,), block, dtype=torch.int32,
                            device=self.device)
        return self._gather(ext, blocks)[0]


def first_healthy(healthy: torch.Tensor) -> torch.Tensor:
    """(R,) bool health -> one-hot of the first healthy replica (all False
    when none is). Replicas are bit-identical by the mirrored-write
    invariant, so the first one needs no round robin."""
    h = healthy.to(torch.int32)
    return healthy & (torch.cumsum(h, 0) - 1 == 0)


def apply_compute_ops(tables, pools, sel, lanes: List[Tuple[int, dict]],
                      payload: torch.Tensor, ok: torch.Tensor,
                      value: torch.Tensor, status: torch.Tensor,
                      reads: torch.Tensor, *, kern, n_volumes: int):
    """Run one shard's compute lanes in lane order.

    ``tables``/``pools``: the shard's replicas, after the batch's data
    phase; ``sel``: the one-hot replica to read; ``lanes``: ``(lane,
    fields)`` with the staged host ints ``volume``/``page``/``block``/
    ``fn``/``arg``; ``payload``, ``ok``, ``value``, ``status``, ``reads``:
    the shard's (B, ...) lanes on the device (``value``/``status``/
    ``reads`` are updated in place at the compute lanes). Returns the
    writing lane's ``(lane, do_write)`` (do_write a device bool already
    masked by ``ok``), or None."""
    table = sfns.device_table()
    commit = None
    for i, f in lanes:
        vol = f["volume"]
        if not 0 <= vol < n_volumes:
            continue                       # not live: the lane keeps -1/0
        entry = table[min(max(f["fn"], 0), len(table) - 1)]
        view = VolumeView(tables, pools, vol, kern, sel)
        live = ok[i]
        v, st, out, dw = entry.apply(view, f["page"], f["block"], f["arg"],
                                     payload[i])
        value[i] = torch.where(live, as_device(v, value), value[i])
        status[i] = torch.where(live, as_device(st, status), status[i])
        reads[i] = torch.where(live, as_device(out, reads), reads[i])
        if entry.writes and commit is None:
            commit = (i, as_device(dw, ok) & live)
    return commit


def as_device(x, like: torch.Tensor) -> torch.Tensor:
    """A function's result as a tensor of ``like``'s dtype and device. A
    Python number is filled on the device: copying it there from the host
    would synchronise."""
    if isinstance(x, torch.Tensor):
        return x.to(like.dtype)
    return torch.full((), x, dtype=like.dtype, device=like.device)
