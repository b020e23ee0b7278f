"""The ublk-style public block-device API: byte-addressed async volumes.

Port of ``IOFuture``, ``Volume`` and ``VolumeManager`` from
``repro/core/blockdev.py``. A ``VolumeManager`` owns one registered engine
backend and its pump loop and hands out ``Volume`` handles; callers issue
byte-addressed asynchronous I/O:

    mgr = VolumeManager(backend="ring", n_replicas=3, payload_elems=4096)
    vol = mgr.create()
    fut = vol.pwrite(4096, b"hello")       # async: an IOFuture
    assert vol.read(4096, 5) == b"hello"   # sync convenience wrapper

Byte -> page translation (one ``Volume`` spans ``max_pages`` DBS pages):

    block_bytes = payload_elems          # one engine payload lane = 1 byte
    page_bytes  = page_blocks * block_bytes
    byte off    -> page off // page_bytes, block (off % page_bytes) // block_bytes

Each byte rides one float32 payload lane (0..255 are exact in float32).
Aligned spans fan out to one request per block and complete on the pump's
single host fetch. Unaligned edges take an in-API read-modify-write path.
Per volume, submission order is execution order (a volume's requests ride
one admission queue, and overlapping-block hazards are fenced with a
flush). ``discard`` unmaps fully covered pages and zero-fills partial
edges. Control ops (snapshot/clone/delete/unmap) ride the volume's stream
as in-band requests on ``backend="ring"`` (the default, as in the
reference); elsewhere they flush, then dispatch on the host.
``Volume.compute`` runs a registered storage function (repro_torch/
compute) against the volume's bytes: one in-band request on the ring and
on the host oracle, a flush and one per-call device execution on the other
backends; it resolves to a ``ComputeResult``.

``payload_shape=`` replaces the flat ``(payload_elems,)`` block with any
per-block tensor: the serving engine stores one token's K/V for every
layer in one block and drives raw ``Request``s plus the device views
(``device_extent_map``, ``device_pools``, ``set_device_pools``), not the
byte API, which assumes the flat layout.

The manager runs on ``device`` (default ``cuda``, with no CPU fallback).
``backend="host"`` (with ``null_storage=True``: no pool) is the control
plane of the copy-based serving baseline, which reads ``state`` and calls
``alloc_pages``. ``backend="upstream"`` is the paper's baseline, and
``storage="chained"`` puts its chained stores behind ``loop``/``slots``;
``transport=``/``write_policy=``/``read_policy=`` choose the replica wire
and policies, and ``engine.control("fail"|"rebuild", replica=i)`` fails
and rebuilds a replica. ``backend="sharded", n_shards=S`` serves the
volumes from S stacked engine shards (volume ``vid`` on shard ``vid % S``;
``control("fail"|"rebuild", shard=s, replica=i)`` is per shard), and the
device views then address the flattened pools of all shards; the ring's
storage is such a sharded group too.

``journal=`` (a path or a ``durability.Journal``) turns on the write-ahead
journal: the manager buffers one ``WireMsg`` record per mutating call,
built from host bytes already in hand, and group-commits the buffer (ONE
append and one seal) at every pump boundary, before the engine applies
the batch; ``flush(durable=True)`` then fsyncs it, and
``durability.recover`` rebuilds a manager from it. ``tier=`` (fused only)
bounds the device-resident extents with the spill tier.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.frontend import Request
from repro_torch.core.replication import ShardedReplicaGroup
from repro_torch.core.transport import (MSG_CLONE, MSG_CREATE, MSG_DELETE,
                                        MSG_SNAPSHOT, MSG_UNMAP, MSG_WRITE,
                                        WireMsg)
from repro_torch.kernels.dbs.ops import shard_rows

# control kinds the durability journal records (core -> journal opcode)
_JOURNAL_CTRL = {"snapshot": MSG_SNAPSHOT, "clone": MSG_CLONE,
                 "delete": MSG_DELETE}


def _bytes_to_lanes(data) -> np.ndarray:
    """One byte per float32 payload lane (0..255 — exact in float32)."""
    return np.frombuffer(data, np.uint8).astype(np.float32)


def _lanes_to_bytes(arr) -> bytes:
    return np.asarray(arr).astype(np.uint8).tobytes()


class IOFuture:
    """Completion handle for one byte-addressed I/O call: ``done()`` polls
    the fan-out requests' statuses, ``result()`` drives the manager's pump
    loop until complete and returns the call's value (``bytes`` for reads,
    the byte count for writes and discards), assembled once and cached.
    Raises ``OSError`` if any constituent op completed with a negative
    status."""

    _UNSET = object()

    __slots__ = ("_mgr", "_reqs", "_assemble", "_value", "_cached")

    def __init__(self, mgr: "VolumeManager", reqs: List[Request],
                 assemble: Optional[Callable[[], Any]] = None,
                 value: Any = None):
        self._mgr = mgr
        self._reqs = reqs
        self._assemble = assemble
        self._value = value
        self._cached = IOFuture._UNSET

    def done(self) -> bool:
        return (self._cached is not IOFuture._UNSET
                or all(r.status is not None for r in self._reqs))

    def latency(self) -> int:
        """Max completion latency (pump ticks) across the fan-out."""
        return max((r.latency or 0 for r in self._reqs), default=0)

    def completion_tick(self) -> int:
        """Absolute pump tick the last fan-out op completed on."""
        return max((r.tick + (r.latency or 1) - 1 for r in self._reqs),
                   default=0)

    def result(self) -> Any:
        if self._cached is not IOFuture._UNSET:
            return self._cached
        if not self.done():
            self._mgr.flush()
        if not self.done():
            raise RuntimeError("I/O did not complete after a full drain")
        # negative statuses are I/O errors; positive ones (ST_MISMATCH from
        # compare_and_write / verify_on_read) are results, not exceptions
        bad = [r for r in self._reqs if r.status < 0]
        if bad:
            raise OSError(f"{bad[0].kind} failed with status {bad[0].status} "
                          f"(volume {bad[0].volume}, page {bad[0].page})")
        self._cached = (self._assemble() if self._assemble is not None
                        else self._value)
        return self._cached


@dataclass
class ComputeResult:
    """Outcome of one ``Volume.compute`` call: ``value`` is the function's
    scalar result (checksum, match count, the actual blocksum for
    ``compare_and_write``...), ``status`` its op status (0 = OK,
    ``ST_MISMATCH`` = the compare or verify failed: a result, not an I/O
    error), ``payload`` the output lanes (matching pages for
    ``filter_pages``, the block for ``verify_on_read``)."""
    fn: str
    value: int
    status: int
    payload: np.ndarray = field(repr=False)

    @property
    def ok(self) -> bool:
        return self.status == 0

    def pages(self) -> List[int]:
        """The payload as a page list (``filter_pages``): the non-negative
        lanes, in ascending order."""
        return [int(v) for v in np.asarray(self.payload).reshape(-1)
                if v >= 0]

    def data(self) -> bytes:
        """The payload as block bytes (``verify_on_read``)."""
        return _lanes_to_bytes(self.payload)


class Volume:
    """A byte-addressed block-device handle (one DBS volume)."""

    def __init__(self, mgr: "VolumeManager", vid: int):
        self.mgr = mgr
        self.vid = vid

    def pread(self, off: int, nbytes: int) -> IOFuture:
        return self.mgr.pread(self.vid, off, nbytes)

    def pwrite(self, off: int, data: bytes) -> IOFuture:
        return self.mgr.pwrite(self.vid, off, data)

    def discard(self, off: int, nbytes: int) -> IOFuture:
        return self.mgr.discard(self.vid, off, nbytes)

    def flush(self, durable: bool = False) -> None:
        self.mgr.flush(durable=durable)

    def compute(self, fn: str, off: int = 0, nbytes: Optional[int] = None,
                *, arg: int = 0, data: Optional[bytes] = None) -> IOFuture:
        """Run a registered storage function against this volume's bytes
        (repro_torch/compute). Range-scoped functions take a page-aligned
        ``[off, off+nbytes)`` span (default: to the end of the device),
        block-scoped ones the block at ``off``; ``arg`` is the function's
        scalar parameter, ``data`` the new block of a writing function
        (``compare_and_write``). Returns an ``IOFuture`` resolving to a
        ``ComputeResult``."""
        return self.mgr.compute(self.vid, fn, off, nbytes, arg=arg,
                                data=data)

    def read(self, off: int, nbytes: int) -> bytes:
        return self.pread(off, nbytes).result()

    def write(self, off: int, data: bytes) -> int:
        return self.pwrite(off, data).result()

    def snapshot(self):
        """Freeze the volume head; returns the snapshot id."""
        return self.mgr.snapshot(self.vid)

    def clone(self) -> Optional["Volume"]:
        return self.mgr.clone(self.vid)

    def delete(self) -> None:
        self.mgr.delete(self.vid)

    @property
    def capacity(self) -> int:
        return self.mgr.capacity

    @property
    def block_bytes(self) -> int:
        return self.mgr.block_bytes

    @property
    def page_bytes(self) -> int:
        return self.mgr.page_bytes

    def __repr__(self):
        return (f"Volume(vid={self.vid}, capacity={self.capacity}B, "
                f"backend={self.mgr.backend_name!r})")


class VolumeManager:
    """Owns one registered engine backend and hands out ``Volume`` handles.

    Engine geometry kwargs mirror ``EngineConfig``. All of a volume's
    requests ride one admission queue (request ids are minted so that
    ``req_id % n_queues`` is a function of the volume), which makes
    submission order execution order; overlapping-block write hazards are
    fenced with a flush."""

    def __init__(self, backend: str = "ring", *, n_shards: int = 1,
                 n_replicas: int = 2, payload_elems: int = 64,
                 page_blocks: int = 32, n_extents: int = 1024,
                 max_volumes: int = 16, max_pages: int = 256,
                 n_queues: int = 4, n_slots: int = 256, batch: int = 64,
                 storage: str = "dbs", null_backend: bool = False,
                 null_storage: bool = False, cow: str = "auto",
                 kernel: str = "auto", transport: str = "local",
                 write_policy: str = "all", read_policy: str = "rr",
                 transport_opts: Optional[Dict[str, Any]] = None,
                 payload_shape=None, journal: Any = None, tier: Any = None,
                 device: Any = None):
        self.payload_shape = (tuple(payload_shape)
                              if payload_shape is not None
                              else (payload_elems,))
        self.engine = Engine(EngineConfig(
            comm=backend, n_shards=n_shards, n_replicas=n_replicas,
            payload_shape=self.payload_shape, page_blocks=page_blocks,
            n_extents=n_extents, max_volumes=max_volumes,
            max_pages=max_pages, n_queues=n_queues, n_slots=n_slots,
            batch=batch, storage=storage, null_backend=null_backend,
            null_storage=null_storage, cow=cow, kernel=kernel,
            transport=transport, write_policy=write_policy,
            read_policy=read_policy, transport_opts=transport_opts,
            journal=journal, tier=tier, device=device))
        self.device = self.engine.cfg.device
        # durability journal (repro_torch/durability/journal.py): one
        # WireMsg per mutating public-API op, group-committed (ONE append +
        # seal) at every pump boundary, BEFORE the engine applies the batch
        # (write-ahead)
        self._journal = self.engine.journal
        self._jbuf: List[WireMsg] = []
        self._closed = False
        self.backend_name = backend
        self.block_bytes = payload_elems
        self.page_blocks = page_blocks
        self.page_bytes = page_blocks * payload_elems
        self.capacity = max_pages * self.page_bytes
        self._nq = max(1, n_queues)
        self._ns = max(1, n_shards)
        self._seq = itertools.count()
        # control ops ride the data stream when the backend's submission
        # path takes them (the ring); elsewhere they fence host-side
        self._inband = "snapshot" in self.engine.data_kinds
        # the hot-path submit: the manager only mints valid data kinds, so
        # aligned spans go straight to the backend's frontend (the host
        # backend has none and queues them itself)
        fe = self.engine.frontend
        self._fast_submit = (fe.submit if fe is not None
                             else self.engine.impl.submit)
        self.volumes: Dict[int, Volume] = {}
        # per-volume in-flight absolute-block sets for the hazard fence
        self._pending_w: Dict[int, set] = {}
        self._pending_r: Dict[int, set] = {}
        self._n_pending = 0

    # ------------------------------------------------------------ plumbing
    def _rid(self, vid: int) -> int:
        """Mint a request id that pins this volume's stream to one
        admission queue, so per-volume FIFO survives the round-robin
        drain."""
        return next(self._seq) * self._nq + (vid // self._ns) % self._nq

    def _vid(self, vol) -> int:
        return vol.vid if isinstance(vol, Volume) else int(vol)

    def _check_span(self, off: int, nbytes: int) -> None:
        if off < 0 or nbytes < 0 or off + nbytes > self.capacity:
            raise ValueError(f"byte span [{off}, {off + nbytes}) outside "
                             f"device capacity {self.capacity}")

    def _fence_write(self, vid: int, lo: int, hi: int) -> None:
        """A write overlapping an in-flight read or write of the same block
        must not share its batch window — flush first."""
        pw = self._pending_w.get(vid)
        pr = self._pending_r.get(vid)
        if pw is None and pr is None:
            return
        span = range(lo, hi)
        if ((pw and not pw.isdisjoint(span))
                or (pr and not pr.isdisjoint(span))):
            self.flush()

    def _track(self, table: Dict[int, set], vid: int, lo: int,
               hi: int) -> None:
        self._n_pending += 1
        s = table.get(vid)
        if s is None:
            table[vid] = set(range(lo, hi))
        else:
            s.update(range(lo, hi))

    def _clear_pending(self) -> None:
        self._pending_w.clear()
        self._pending_r.clear()
        self._n_pending = 0

    def submit(self, req: Request) -> None:
        """Raw request-level escape hatch (validated at the backend's
        submission boundary)."""
        self._check_open()
        self.engine.submit(req)

    # ------------------------------------------------------------ journaling
    def _journal_seal(self) -> None:
        """Group commit: append the buffered records + ONE seal as a single
        file write (write-ahead: called before the engine pumps/drains)."""
        if self._journal is not None and self._jbuf:
            self._journal.append_batch(self._jbuf)
            self._jbuf.clear()

    def attach_journal(self, journal) -> None:
        """Adopt a (recovered, tail-truncated) journal: subsequent mutating
        ops append to it (``durability.recovery.recover``'s reattach)."""
        self._journal = journal
        self.engine.journal = journal
        self.engine._journal_owned = True

    def pump(self) -> int:
        if self._jbuf:
            self._journal_seal()
        done = self.engine.pump()
        if self._n_pending and self.engine.depth() == 0:
            # queues empty after a pump => every submitted op completed
            self._clear_pending()
        return done

    def drain(self) -> int:
        return self.flush()

    def flush(self, durable: bool = False) -> int:
        """Complete everything in flight (one host fetch per pump).

        ``durable=True`` is the durability barrier: after the drain the
        journal is fsync'd, so every acked op survives a crash (without it,
        sealed records sit in OS buffers: crash-consistent but only as
        durable as the page cache). With no journal it is the plain flush."""
        self._journal_seal()
        done = self.engine.drain()
        if self._n_pending:
            self._clear_pending()
        if durable and self._journal is not None:
            self._journal.sync()
        return done

    def close(self) -> int:
        """Drain every in-flight I/O and close the manager: further
        submissions raise. Idempotent."""
        if self._closed:
            return 0
        done = self.flush()
        storage = self.engine.backend
        if storage is not None and hasattr(storage, "drain_transports"):
            storage.drain_transports()    # quorum/async stragglers land
        if self._journal is not None:
            self._journal.sync()
            if self.engine._journal_owned:
                self._journal.close()
        self._closed = True
        return done

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "VolumeManager":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise ValueError("I/O on a closed VolumeManager")

    def stats(self) -> Dict[str, Any]:
        out = {"completed": self.engine.completed,
               "queued": self.engine.depth(),
               "backend": self.backend_name}
        table = getattr(self.engine.frontend, "table", None)
        if table is not None:
            from repro_torch.core import slots
            out["slots_active"] = int(slots.n_active(table))
        if self._journal is not None:
            out["journal"] = {"seq": self._journal.seq,
                              "appends": self._journal.appends,
                              "records": self._journal.records}
        tier = getattr(self.engine.impl, "tier", None)
        if tier is not None:
            out["tier"] = tier.to_dict()
        return out

    # ------------------------------------------------------------ lifecycle
    def create(self) -> Volume:
        self._check_open()
        vid = self.engine.create_volume()
        if vid is None or vid < 0:
            raise RuntimeError("volume table full")
        if self._journal is not None:
            self._jbuf.append(WireMsg(op=MSG_CREATE, volume=vid,
                                      meta=(vid, 0)))
        vol = Volume(self, vid)
        self.volumes[vid] = vol
        return vol

    def open(self, vid: int) -> Volume:
        return self.volumes.get(vid) or self.volumes.setdefault(
            vid, Volume(self, vid))

    def _control_sync(self, kind: str, vid: int, **kw):
        """One control op, ordered behind the volume's in-flight stream: an
        in-band request through the volume's own queue on the ring, a flush
        and host-side dispatch elsewhere. Drains to completion either
        way."""
        self._check_open()
        if self._inband and kind in ("snapshot", "clone", "delete"):
            r = Request(req_id=self._rid(vid), kind=kind, volume=vid)
            self.engine.submit(r)
            self.flush()
            res = r.result
        else:
            self.flush()
            res = self.engine.control(kind, volume=vid, **kw)
        op = _JOURNAL_CTRL.get(kind)
        if op is not None and self._journal is not None:
            # the engine's result id rides meta so recovery can ASSERT its
            # replay allocated the same volume/snapshot ids
            rid = -1 if res is None else int(res)
            self._jbuf.append(WireMsg(op=op, volume=vid, meta=(rid, 0)))
        return res

    def snapshot(self, vol) -> Any:
        return self._control_sync("snapshot", self._vid(vol))

    def clone(self, vol) -> Optional[Volume]:
        """Fork a CoW copy; returns the new Volume (None on failure)."""
        new_vid = self._control_sync("clone", self._vid(vol))
        if new_vid is None or new_vid < 0:
            return None
        child = Volume(self, new_vid)
        self.volumes[new_vid] = child
        return child

    def delete(self, vol) -> None:
        vid = self._vid(vol)
        self._control_sync("delete", vid)
        self.volumes.pop(vid, None)

    # ------------------------------------------------------------ byte I/O
    def pread(self, vol, off: int, nbytes: int) -> IOFuture:
        self._check_open()
        vid = self._vid(vol)
        self._check_span(off, nbytes)
        if nbytes == 0:
            return IOFuture(self, [], value=b"")
        bb, pb = self.block_bytes, self.page_blocks
        first, last = off // bb, (off + nbytes - 1) // bb
        reqs = []
        submit = self._fast_submit
        for ab in range(first, last + 1):
            r = Request(req_id=self._rid(vid), kind="read", volume=vid,
                        page=ab // pb, block=ab % pb)
            submit(r)
            reqs.append(r)
        self._track(self._pending_r, vid, first, last + 1)
        head = off - first * bb

        def assemble() -> bytes:
            parts = [np.zeros(bb, np.float32) if r.result is None
                     else np.asarray(r.result, np.float32) for r in reqs]
            return _lanes_to_bytes(np.concatenate(parts))[head:head + nbytes]
        return IOFuture(self, reqs, assemble=assemble)

    def _read_span_sync(self, vid: int, off: int, nbytes: int) -> bytes:
        return self.pread(vid, off, nbytes).result()

    def pwrite(self, vol, off: int, data) -> IOFuture:
        self._check_open()
        vid = self._vid(vol)
        data = bytes(data)
        n = len(data)
        self._check_span(off, n)
        if n == 0:
            return IOFuture(self, [], value=0)
        bb, pb = self.block_bytes, self.page_blocks
        first, last = off // bb, (off + n - 1) // bb
        head = off - first * bb
        tail = (last + 1) * bb - (off + n)
        if head or tail:
            # in-API read-modify-write: fetch the partial edge blocks
            # synchronously (ordered behind every in-flight op), merge the
            # new bytes in, and write whole blocks
            span = bytearray((last - first + 1) * bb)
            if first == last:
                span[:] = self._read_span_sync(vid, first * bb, bb)
            else:
                if head:
                    span[:bb] = self._read_span_sync(vid, first * bb, bb)
                if tail:
                    span[-bb:] = self._read_span_sync(vid, last * bb, bb)
            span[head:head + n] = data
            data = span
        if self._n_pending:
            self._fence_write(vid, first, last + 1)
        submit = self._fast_submit
        view = memoryview(data)
        reqs = []
        for i, ab in enumerate(range(first, last + 1)):
            r = Request(req_id=self._rid(vid), kind="write", volume=vid,
                        page=ab // pb, block=ab % pb,
                        payload=_bytes_to_lanes(view[i * bb:(i + 1) * bb]))
            submit(r)
            reqs.append(r)
        self._track(self._pending_w, vid, first, last + 1)
        if self._journal is not None:
            # ONE record per pwrite: the POST-RMW block-aligned bytes already
            # in hand, so replay applies them directly (no re-merge) and the
            # capture adds no device work
            self._jbuf.append(WireMsg(
                op=MSG_WRITE, volume=vid, pages=[r.page for r in reqs],
                blocks=[r.block for r in reqs], payload=bytes(data)))
        return IOFuture(self, reqs, value=n)

    def _replay_write(self, vid: int, pages, blocks, lanes) -> None:
        """Recovery replay of one journaled ``MSG_WRITE`` record: re-submit
        its block lanes through the normal path, hazard fence included, so
        replay re-serializes exactly the overlapping spans the original run
        fenced (durability/recovery.py)."""
        self._check_open()
        pb = self.page_blocks
        abs_blocks = np.asarray(pages, np.int64) * pb + np.asarray(blocks)
        lo, hi = int(abs_blocks.min()), int(abs_blocks.max()) + 1
        if self._n_pending:
            self._fence_write(vid, lo, hi)
        submit = self._fast_submit
        for p, b, lane in zip(pages, blocks, lanes):
            submit(Request(req_id=self._rid(vid), kind="write", volume=vid,
                           page=int(p), block=int(b),
                           payload=np.asarray(lane, np.float32)))
        self._track(self._pending_w, vid, lo, hi)

    def discard(self, vol, off: int, nbytes: int) -> IOFuture:
        """TRIM ``[off, off+nbytes)``: fully covered pages are unmapped
        (extents freed), partial edges are zero-filled through the write
        path. Reads of the span return zeros afterwards."""
        self._check_open()
        vid = self._vid(vol)
        self._check_span(off, nbytes)
        if nbytes == 0:
            return IOFuture(self, [], value=0)
        pby = self.page_bytes
        end = off + nbytes
        first_full = -(-off // pby)              # ceil
        last_full = end // pby
        reqs: List[Request] = []
        if first_full < last_full:
            reqs.extend(self._unmap_pages(
                vid, list(range(first_full, last_full))))
            edges = [(off, first_full * pby), (last_full * pby, end)]
        else:
            edges = [(off, end)]
        for a, b in edges:
            if b > a:
                reqs.extend(self.pwrite(vid, a, b"\x00" * (b - a))._reqs)
        return IOFuture(self, reqs, value=nbytes)

    def _unmap_pages(self, vid: int, pages: List[int]) -> List[Request]:
        """Unmap fully covered pages (extents freed): in-band UNMAP
        requests on the ring, a flush and host-side dispatch elsewhere.
        Journaled as ONE ``MSG_UNMAP`` record; also recovery's replay entry
        for that record."""
        reqs: List[Request] = []
        if self._inband:
            for p in pages:
                r = Request(req_id=self._rid(vid), kind="unmap", volume=vid,
                            page=p)
                self.engine.submit(r)
                reqs.append(r)
        else:
            self.flush()                     # order: behind in-flight ops
            self.engine.unmap(vid, pages)
        if self._journal is not None and pages:
            self._jbuf.append(WireMsg(op=MSG_UNMAP, volume=vid,
                                      pages=np.asarray(pages, np.int32)))
        return reqs

    # ------------------------------------------------- computational storage
    def compute(self, vol, fn: str, off: int = 0,
                nbytes: Optional[int] = None, *, arg: int = 0,
                data: Optional[bytes] = None) -> IOFuture:
        """A storage function over a volume's bytes (``Volume.compute``).
        On backends whose submission path takes ``kind="compute"`` (the
        ring runs it inside its step; the host oracle runs the sequential
        reference in its FIFO) this is one async request on the volume's
        queue, ordered like any other. Elsewhere it flushes and runs the
        same device computation against the replica pools
        (``compute/exec.py device_compute``)."""
        self._check_open()
        from repro_torch.compute import make_storage_fn, storage_fn_id
        vid = self._vid(vol)
        entry = make_storage_fn(fn)           # unknown names raise here
        bb, pby = self.block_bytes, self.page_bytes
        if entry.scope == "range":
            if nbytes is None:
                nbytes = self.capacity - off
            if off % pby or nbytes % pby or nbytes <= 0:
                raise ValueError(
                    f"range-scoped {fn!r} needs a page-aligned non-empty "
                    f"span (page_bytes={pby}), got [{off}, {off + nbytes})")
            self._check_span(off, nbytes)
            page, block = off // pby, nbytes // pby   # start page, count
        else:                                  # scope == "block"
            if off % bb:
                raise ValueError(f"block-scoped {fn!r} needs a block-aligned "
                                 f"offset (block_bytes={bb}), got {off}")
            if nbytes is None:
                nbytes = bb
            if nbytes != bb:
                raise ValueError(f"block-scoped {fn!r} covers exactly one "
                                 f"block ({bb}B), got nbytes={nbytes}")
            self._check_span(off, nbytes)
            ab = off // bb
            page, block = ab // self.page_blocks, ab % self.page_blocks
        payload = None
        if entry.writes:
            if data is None:
                raise ValueError(f"{fn!r} writes: pass data= (the new "
                                 "block contents)")
            data = bytes(data)
            if len(data) != bb:
                raise ValueError(f"{fn!r} data must be one block "
                                 f"({bb}B), got {len(data)}")
            payload = _bytes_to_lanes(data)
        elif data is not None:
            raise ValueError(f"{fn!r} does not take data=")

        if entry.writes and self._journal is not None:
            # only MUTATING storage functions are journaled (read-only ones
            # don't change state); replay re-executes them in place: their
            # outcome is a pure function of the replayed device state
            from repro_torch.durability.journal import OP_COMPUTE
            self._jbuf.append(WireMsg(
                op=OP_COMPUTE, volume=vid,
                pages=np.asarray([page], np.int32),
                blocks=np.asarray([block], np.int32),
                extents=fn.encode(),
                meta=(int(arg), 1 if entry.scope == "range" else 0),
                payload=data))

        def wrap(value, status, lanes) -> ComputeResult:
            return ComputeResult(fn=fn, value=int(value), status=int(status),
                                 payload=np.asarray(lanes, np.float32))

        if "compute" in self.engine.data_kinds:    # ring + host: in-queue
            r = Request(req_id=self._rid(vid), kind="compute", volume=vid,
                        page=page, block=block, payload=payload, fn=fn,
                        arg=int(arg), fnid=storage_fn_id(fn))
            self._fast_submit(r)

            def assemble() -> ComputeResult:
                value, lanes = (r.result if r.result is not None
                                else (0, np.zeros(self.payload_shape,
                                                  np.float32)))
                return wrap(value, r.status, lanes)
            return IOFuture(self, [r], assemble=assemble)
        # no in-band compute path: fence behind in-flight I/O with a flush,
        # then run the same device computation against the replica pools
        from repro_torch.compute.exec import device_compute
        self.flush()
        value, status, lanes = device_compute(
            self.engine, vid, fn, page, block, int(arg), payload)
        return IOFuture(self, [], value=wrap(value, status, lanes))

    # ------------------------------------- embedder control-plane passthrough
    @property
    def state(self):
        """The backing ``DBSState`` (``backend="host"`` only): the control
        plane the copy-based serving baseline reads block tables from."""
        return self.engine.impl.state

    def alloc_pages(self, vols, pages, mask=None, bits=None):
        """Page allocation/CoW on the host backend's state; returns the DBS
        ``WriteOps`` for an external data plane (the serving baseline's KV
        pools). Host backend only: on the fused engine page allocation is
        the write path (submit zero-payload writes and ``flush()``)."""
        return self.engine.impl.alloc_pages(vols, pages, mask=mask,
                                            bits=bits)

    # --------------------------------------------- device-resident KV views
    # The zero-copy serving path (serving/engine.py) reads these: the extent
    # map a paged-attention kernel indexes through, and the engine payload
    # pools it treats as the KV cache. Nothing here syncs to the host.
    def device_extent_map(self) -> torch.Tensor:
        """ONE (V, P) int32 extent map on the device (holes -1): the host
        backend's own state's, else replica 0's (the replicas run identical
        control sequences, so their maps agree). On the sharded pool each
        shard's map is its first healthy replica's (a failed replica's map
        stops moving; the reference reads replica 0's whatever its health),
        and the per-shard (S, V, P) maps are put into global coordinates:
        shard s's extents move up by ``s*(E+1)`` to index the flattened
        pools of ``device_pools``, and row ``v`` is global volume v
        (``local*S + shard``)."""
        impl = self.engine.impl
        if hasattr(impl, "state"):                      # host backend
            return impl.state.table
        storage = self.engine.backend
        if isinstance(storage, ShardedReplicaGroup):
            first = storage.healthy.argmax(axis=1)      # host mirror
            tbl = torch.stack([storage.states[r].table[s]
                               for s, r in enumerate(first)])  # (S, V, P)
            rows = storage.pools[0].shape[1]            # E+1 a shard
            flat = shard_rows(tbl.reshape(tbl.shape[0], -1), rows)
            return flat.view(tbl.shape).transpose(0, 1).reshape(
                -1, tbl.shape[2])
        if not hasattr(storage, "device_state"):
            raise RuntimeError("this backend holds no extent map")
        states, _pools = storage.device_state()
        return states[0].table

    def device_pools(self) -> Tuple[torch.Tensor, ...]:
        """The live payload pools: the tensors the engine step updates in
        place, not copies, so writes into them are writes into the
        replicas. On the fused engine the healthy replicas' pools, each
        ``(E+1, page_blocks, *payload_shape)``; on the sharded pool every
        replica's, each viewed as ``(S*(E+1), page_blocks, *payload_shape)``
        (the row ids of ``device_extent_map``; health there is per shard)."""
        storage = self.engine.backend
        if isinstance(storage, ShardedReplicaGroup):
            _states, pools, _healthy = storage.device_state()
            return tuple(p.view((-1,) + tuple(p.shape[2:])) for p in pools)
        _states, pools = storage.device_state()
        return tuple(pools)

    def set_device_pools(self, pools) -> None:
        """Store pools (as ``device_pools`` returned them, in its order)
        back into the replicas: the commit half of an external step that
        scattered into them (the serving decode program)."""
        storage = self.engine.backend
        sharded = isinstance(storage, ShardedReplicaGroup)
        states, cur = storage.device_state()[:2]
        for p, c in zip(pools, cur):
            want = ((c.shape[0] * c.shape[1],) + tuple(c.shape[2:])
                    if sharded else tuple(c.shape))
            if tuple(p.shape) != want:
                raise ValueError(f"pool shape {tuple(p.shape)} != {want}")
        if sharded:
            pools = tuple(p.view(c.shape) for p, c in zip(pools, cur))
        storage.set_device_state(states, tuple(pools))

    def __repr__(self):
        return (f"VolumeManager(backend={self.backend_name!r}, "
                f"block_bytes={self.block_bytes}, "
                f"page_bytes={self.page_bytes}, capacity={self.capacity}, "
                f"device={str(self.device)!r})")
