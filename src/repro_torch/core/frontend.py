"""Frontends: multi-queue (ublk-style) and single-loop (TGT-style upstream).

Port of ``Request``, ``UpstreamFrontend`` and ``MultiQueueFrontend`` from
``repro/core/frontend.py``. ``UpstreamFrontend`` is the paper's baseline:
one queue, one loop function taking one request at a time into a dict of
in-flight requests. ``MultiQueueFrontend`` is N admission queues over a
single-shard
``RingFrontend`` (core/ring.py, the one drain protocol). ``drain_batch``
moves the staged numpy lanes to the device as one transfer per leaf into
the ``FusedBatch`` the fused step consumes; admission happens inside the
step, so no slot id is ever read back. ``poll_batch``/``complete`` admit
and retire as device ops of their own and read the slot ids back (the
serving engine's admission). ``ShardedFrontend`` is an S-shard
``RingFrontend`` with a shard-stacked slot table: ``drain_sharded``
stages one (S, B) batch a pump and moves each leaf to the device through
pinned memory without blocking.
"""
from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch

from repro_torch.core import slots
from repro_torch.core.fused import FusedBatch
from repro_torch.core.ring import (KIND_CLASS, OP_WRITE, RingFrontend,
                                   _to_device)


@dataclass
class Request:
    req_id: int
    kind: str                 # read | write | snapshot | clone | unmap |
                              # delete | fail | rebuild | compute | noop
    volume: int = -1
    page: int = 0
    block: int = 0            # block offset within the page
    payload: Any = None
    shard: Optional[int] = None  # explicit shard (fail/rebuild; else by vol)
    result: Any = None        # read payload (host numpy)
    status: Any = None        # completion status (ring.ST_*); 0 = OK
    latency: Any = None       # completion latency in pump ticks
    tick: int = 0             # submission pump tick (stamped by the frontend)
    fn: Optional[str] = None  # storage-function name (kind="compute")
    arg: int = 0              # storage-function immediate argument
    fnid: int = 0             # resolved registry id


class UpstreamFrontend:
    """Single queue + single loop function + dynamic map (paper Fig. 4
    left)."""

    def __init__(self, max_inflight: int = 256):
        self.queue: Deque[Request] = collections.deque()
        self.messages: Dict[int, Request] = {}      # the Messages Map
        self._next_id = itertools.count()
        self.max_inflight = max_inflight
        self.step = 0               # pump tick (latency accounting)

    def submit(self, req: Request) -> None:
        req.tick = self.step        # submission stamped in pump ticks
        self.queue.append(req)

    def poll_one(self) -> Optional[Tuple[int, Request]]:
        """The loop function: take ONE request, give it a unique id and
        store it in the map. Each poll is one pump tick; the request's
        ``latency`` is stamped in ticks."""
        if not self.queue or len(self.messages) >= self.max_inflight:
            return None
        req = self.queue.popleft()
        req.latency = self.step - req.tick + 1
        self.step += 1
        mid = next(self._next_id)
        self.messages[mid] = req
        return mid, req

    def complete(self, mid: int) -> Request:
        return self.messages.pop(mid)

    def __len__(self):
        return len(self.queue)


def _reject_control(req) -> None:
    """Data-only frontends refuse control kinds at SUBMIT time: rejecting
    at drain would have already popped the whole batch — dropping innocent
    data requests alongside the offending one."""
    if KIND_CLASS.get(req.kind) in ("vol", "repl", "compute"):
        raise ValueError("control/compute opcodes require comm='ring' "
                         f"(got kind={req.kind!r} on a data-only frontend)")


def _check_data_only(classes) -> None:
    # defensive: unreachable via submit(), which rejects control kinds
    ctrl = set(classes) - {"read", "write", "noop"}
    if ctrl:
        raise ValueError("control opcodes require comm='ring' "
                         f"(got {sorted(ctrl)} on a legacy drain path)")


class MultiQueueFrontend:
    """N admission queues + the device-resident slot table of the fused
    step. Submission, requeueing and the round-robin drain live in the
    single-shard ``RingFrontend``; ``drain_batch`` converts its staged
    drain into a ``FusedBatch`` on ``device``."""

    def __init__(self, n_queues: int, n_slots: int, batch: int = 64, *,
                 device):
        self.ring = RingFrontend(1, n_queues, n_slots, batch)
        self.table = slots.make_table(n_slots, device)
        self.batch = batch
        self.device = torch.device(device)
        self._by_slot: Dict[int, Request] = {}

    @property
    def step(self) -> int:
        return self.ring.step[0]

    @step.setter
    def step(self, v: int) -> None:
        self.ring.step[0] = v

    def submit(self, req: Request) -> None:
        _reject_control(req)
        self.ring.submit(req)

    def depth(self) -> int:
        return self.ring.depth()

    def drain_batch(self, payload_shape: Tuple[int, ...] = ()
                    ) -> Tuple[List[Request], Optional[FusedBatch]]:
        """Drain up to ``batch`` requests into the fixed-shape tensors the
        fused step consumes: pure host->device traffic, one transfer per
        leaf, so that the step itself never waits on the host."""
        drained, st, classes = self.ring._stage(payload_shape)
        if st is None:
            return [], None
        _check_data_only(classes)
        dev = self.device
        lanes = lambda k: torch.from_numpy(st[k][0]).to(dev)
        batch = FusedBatch(
            want=lanes("want"),
            is_write=torch.from_numpy(st["op"][0] == OP_WRITE).to(dev),
            volume=lanes("volume"), page=lanes("page"),
            block=lanes("block"), payload=lanes("payload"),
            queue=lanes("queue"),
            step=torch.from_numpy(st["step"][0:1]).to(dev).reshape(()),
        )
        return drained[0], batch

    def poll_batch(self) -> Tuple[torch.Tensor, List[Request]]:
        """Drain up to ``batch`` requests round-robin across queues and admit
        them in ONE device op (padded to the batch size, the Messages-Array
        idiom). Returns (slot ids of the drained requests (k,) on the
        device, -1 where no slot was free; the admitted requests, which are
        a prefix of the drained ones). Not-admitted requests go back to the
        front of their queues."""
        reqs = self.ring._drain_shard(0, self.batch)
        dev = self.device
        if not reqs:
            return torch.zeros((0,), dtype=torch.int32, device=dev), []
        n = len(reqs)
        pad = [0] * (self.batch - n)
        lanes = lambda xs: torch.tensor(xs + pad, dtype=torch.int32,
                                        device=dev)
        want = torch.arange(self.batch, device=dev) < n
        self.table, ids, ok = slots.admit(
            self.table, want, lanes([r.volume for r in reqs]),
            lanes([r.req_id % self.ring.n_queues for r in reqs]),
            torch.tensor(self.step, dtype=torch.int32, device=dev))
        ids, ok = ids[:n], ok[:n]
        self.step += 1
        ids_host, ok_host = ids.tolist(), ok.tolist()
        admitted, requeues = [], []
        for i, r in enumerate(reqs):
            if ok_host[i]:
                self._by_slot[ids_host[i]] = r
                admitted.append(r)
            else:                       # no slot: requeue at the front
                requeues.append(r)
        self.ring.requeue_all(requeues)
        return ids, admitted

    def complete(self, slot_ids: torch.Tensor) -> List[Request]:
        """Retire slots; returns the requests that held them."""
        self.table = slots.retire(self.table, slot_ids)
        return [self._by_slot.pop(sid) for sid in slot_ids.tolist()
                if sid >= 0 and sid in self._by_slot]


class ShardedFrontend:
    """S volume-hashed shards feeding ONE stacked admission: an S-shard
    ``RingFrontend`` (queues, drain; volume ids become shard-local,
    ``volume // S``) beside the shard-stacked slot table of the sharded
    step (core/sharded.py)."""

    def __init__(self, n_shards: int, n_queues: int, n_slots: int,
                 batch: int = 64, *, device):
        self.ring = RingFrontend(n_shards, n_queues, n_slots, batch)
        self.device = torch.device(device)
        self.table = slots.make_sharded_table(n_shards, n_slots, self.device)
        self.n_shards = n_shards
        self.batch = batch

    def shard_of(self, volume: int) -> int:
        return volume % self.n_shards

    def submit(self, req: Request) -> None:
        _reject_control(req)
        self.ring.submit(req)

    def requeue(self, req: Request) -> None:
        self.ring.requeue(req)

    def depth(self) -> int:
        return self.ring.depth()

    def drain_sharded(self, payload_shape: Tuple[int, ...] = ()
                      ) -> Tuple[List[List[Request]], Optional[FusedBatch]]:
        """Drain every shard into one stacked (S, B, ...) ``FusedBatch``
        (None when no shard had traffic). Shard s's request i rides lane
        (s, i); an idle shard contributes inert lanes, so the batch's shape
        never depends on which shards are busy."""
        drained, st, classes = self.ring._stage(payload_shape)
        if st is None:
            return [], None
        _check_data_only(classes)
        dev = self.device
        batch = FusedBatch(
            want=_to_device(st["want"], dev),
            is_write=_to_device(st["op"] == OP_WRITE, dev),
            volume=_to_device(st["volume"], dev),
            page=_to_device(st["page"], dev),
            block=_to_device(st["block"], dev),
            payload=_to_device(st["payload"], dev),
            queue=_to_device(st["queue"], dev),
            step=_to_device(st["step"], dev))
        return drained, batch
