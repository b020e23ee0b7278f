"""Controller<->replica transport: the pluggable wire between the two.

Port of ``repro/core/transport.py``:

- **WireMsg** — an opcode-tagged controller->replica message: data
  (WRITE/READ), volume control, and the rebuild stream (WATERMARKS ->
  FETCH_DELTA -> FETCH_PAGES/PUSH_PAGES -> ADOPT_META),
- **Replica** — one replica's endpoint: its ``DBSState``, payload pool and
  per-page revision watermarks, executing every message,
- **StackedReplica** — one replica's endpoint across S engine shards
  (leaves with a leading (S,) axis); a message addresses one shard's slice
  (``WireMsg.shard``), and ``QUERY_REV`` answers with all S revisions,
- **ReplicaTransport** — the delivery contract with per-opcode ``sent``
  counters, ``pages_moved`` (pool rows through the rebuild stream), both
  also per addressed shard (``sent_by_shard``, ``pages_moved_by_shard``),
  and ``latency_ewma``; **LocalTransport** (a ``post`` IS the endpoint call),
  **DeviceTransport** (the same, by the name the in-program engines use)
  and **SimNetTransport** (latency, a bounded window, drop with in-order
  retransmit, reorder injection; seeded with ``np.random.default_rng`` as
  the reference is, so a seed gives the same drops in both packages),
- ``stamp_page_rev`` / ``clone_page_rev`` — the watermark updates the fused
  step and clones make.

On the fused engine the data plane never rides messages: the controller
threads the endpoint tensors through the step, and the transport carries
control and rebuild traffic. The host-dispatch backends (``loop``,
``slots``) send their data as WRITE and READ messages.
"""
from __future__ import annotations

import collections
import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.core import dbs

# ---------------------------------------------------------------------------
# the wire-message opcode table (WireMsg.op)
# ---------------------------------------------------------------------------
MSG_CREATE = 0        # volume control (mirrored by the controller)
MSG_SNAPSHOT = 1
MSG_CLONE = 2
MSG_UNMAP = 3
MSG_DELETE = 4
MSG_WRITE = 5         # data plane: one batched block write
MSG_READ = 6          # data plane: one batched block read
MSG_QUERY_REV = 7     # consistency: the replica's metadata revision
MSG_WATERMARKS = 8    # rebuild: the replica's per-page revision watermarks
MSG_FETCH_DELTA = 9   # rebuild: extents newer than the given watermarks
MSG_FETCH_PAGES = 10  # rebuild: stream a chunk of pool rows out (donor)
MSG_PUSH_PAGES = 11   # rebuild: stream a chunk of pool rows in (target)
MSG_ADOPT_META = 12   # rebuild: adopt the donor's metadata state (commit)

MSG_NAMES = ("CREATE", "SNAPSHOT", "CLONE", "UNMAP", "DELETE", "WRITE",
             "READ", "QUERY_REV", "WATERMARKS", "FETCH_DELTA", "FETCH_PAGES",
             "PUSH_PAGES", "ADOPT_META")


@dataclass
class WireMsg:
    """One opcode-tagged controller->replica message. Field use per opcode
    is that of ``repro.core.transport.WireMsg``; endpoints treat a message
    as read-only (one message object is posted to every replica)."""
    op: int
    volume: Any = None      # scalar or (B,) volume ids
    pages: Any = None       # (B,) int32 page ids
    blocks: Any = None      # (B,) int32 block offsets within the page
    bits: Any = None        # (B,) block bitmaps
    payload: Any = None     # (B, *payload) write lanes / streamed pool rows
    mask: Any = None        # (B,) bool live write lanes
    extents: Any = None     # (k,) int32 rebuild-stream extent ids
    meta: Any = None        # watermarks / metadata state (rebuild stream)
    shard: Optional[int] = None


class MsgFuture:
    """Completion handle for one posted message. ``done`` flips when the
    transport delivers it (at post time in-process); the controller waits
    by ticking the owning transport."""

    __slots__ = ("transport", "msg", "value", "done", "cancelled",
                 "posted_at")

    def __init__(self, transport: "ReplicaTransport", msg: WireMsg):
        self.transport = transport
        self.msg = msg
        self.value: Any = None
        self.done = False
        self.cancelled = False
        self.posted_at = 0

    def result(self) -> Any:
        self.transport.wait(self)
        return self.value


def stamp_page_rev(page_rev: torch.Tensor, vol, pages, ok,
                   rev) -> torch.Tensor:
    """Record ``rev`` as the last-write watermark of the written pages.

    ``page_rev`` is a (V, P) int32 tensor held next to each replica's
    ``DBSState``. Not-ok lanes scatter into a dump column that is sliced
    off: a write-back of the current value would race an ok lane of the
    same page (a read lane, say)."""
    n_p = page_rev.shape[-1]
    drop = torch.where(ok, pages, n_p).long()
    padded = torch.cat([page_rev, page_rev.new_zeros((page_rev.shape[0], 1))],
                       dim=1)
    padded[torch.as_tensor(vol).long().expand(drop.shape), drop] = \
        rev.to(page_rev.dtype).expand(drop.shape)
    return padded[:, :n_p].contiguous()


def clone_page_rev(page_rev: torch.Tensor, src_vol, new_vol) -> torch.Tensor:
    """A clone inherits the SOURCE's watermark row (no-op when the clone
    failed, ``new_vol < 0``)."""
    new_vol = torch.as_tensor(new_vol).long()
    # (1,) indices: a 0-d index tensor is read back to the host
    safe = new_vol.clamp(min=0).reshape(1)
    row = torch.where(new_vol >= 0, page_rev[int(src_vol)], page_rev[safe])
    out = page_rev.clone()
    out[safe] = row
    return out


def _delta_extents(table: torch.Tensor, page_rev: torch.Tensor,
                   target_watermarks: torch.Tensor) -> np.ndarray:
    """Extents the target is missing: every extent backing a page whose
    watermark is newer than the target's. Healthy replicas execute
    identical op sequences, so a page not written since the target's
    watermark maps to an extent the target already holds bit for bit. The
    masked table is computed on the device and comes back in ONE copy."""
    newer = (page_rev > target_watermarks) & (table >= 0)
    exts = torch.where(newer, table, -1).cpu().numpy()
    return np.unique(exts[exts >= 0]).astype(np.int32)


def _clone_state(st: dbs.DBSState) -> dbs.DBSState:
    """A ``DBSState`` whose every tensor is a copy: the port writes some
    metadata tensors in place, so a state shared by two replicas would let
    one replica's next step change the other's."""
    def cp(x):
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: cp(getattr(x, f.name))
                for f in dataclasses.fields(x)})
        return x.clone()
    return cp(st)


# ---------------------------------------------------------------------------
# the replica endpoint (the server side of the boundary)
# ---------------------------------------------------------------------------
@dataclass
class Replica:
    """One replica endpoint: device-resident metadata state, payload pool
    and per-page revision watermarks. ``healthy`` is the controller's mark
    (the endpoint never consults it). With ``null_storage`` writes update
    the metadata and watermarks but leave the pool alone."""

    state: dbs.DBSState
    pool: torch.Tensor           # (E+1, page_blocks, *payload)
    page_rev: torch.Tensor       # (V, P) int32 last-write watermarks
    healthy: bool = True
    null_storage: bool = False

    def execute(self, msg: WireMsg) -> Any:
        op = msg.op
        if op == MSG_WRITE:
            # control-plane write, then the watermark stamp with the
            # revision it made, then the data plane (the ``torch`` entry)
            self.state, ops = dbs.write_pages(self.state, msg.volume,
                                              msg.pages, msg.bits, msg.mask)
            self.page_rev = stamp_page_rev(self.page_rev, msg.volume,
                                           msg.pages, ops.ok,
                                           self.state.revision)
            if not self.null_storage:
                self.pool = dbs.apply_write_ops(self.pool, ops, msg.payload,
                                                msg.blocks)
            return None
        if op == MSG_READ:
            # holes (never-written or unmapped pages) read as zeros: the
            # clamped gather would otherwise return extent 0's payload
            ext = dbs.read_resolve(self.state, msg.volume, msg.pages)
            got = self.pool[ext.clamp(min=0).long(), msg.blocks.long()]
            hole = (ext >= 0).reshape(ext.shape + (1,) * (got.dim() - 1))
            return torch.where(hole, got, 0)
        if op == MSG_CREATE:
            self.state, vid = dbs.create_volume(self.state)
            return vid
        if op == MSG_SNAPSHOT:
            self.state, sid = dbs.snapshot(self.state, msg.volume)
            return sid
        if op == MSG_CLONE:
            self.state, vid = dbs.clone(self.state, msg.volume)
            self.page_rev = clone_page_rev(self.page_rev, msg.volume, vid)
            return vid
        if op == MSG_UNMAP:
            self.state = dbs.unmap(self.state, msg.volume, msg.pages)
            return None
        if op == MSG_DELETE:
            self.state = dbs.delete_volume(self.state, msg.volume)
            return None
        if op == MSG_QUERY_REV:
            return self.state.revision       # device scalar; caller batches
        if op == MSG_WATERMARKS:
            return self.page_rev
        if op == MSG_FETCH_DELTA:
            return (_delta_extents(self.state.table, self.page_rev,
                                   msg.meta),
                    (self.state, self.page_rev))
        if op == MSG_FETCH_PAGES:
            return self.pool.index_select(0, msg.extents)
        if op == MSG_PUSH_PAGES:
            self.pool.index_copy_(0, msg.extents, msg.payload)
            return None
        if op == MSG_ADOPT_META:
            # copies, not the donor's tensors (see ``_clone_state``)
            meta_state, meta_pr = msg.meta
            self.state = _clone_state(meta_state)
            self.page_rev = meta_pr.clone()
            return None
        raise ValueError(f"unknown wire opcode {op}")


# messages that change an endpoint's metadata (state or watermarks)
_META_OPS = frozenset({MSG_WRITE, MSG_CREATE, MSG_SNAPSHOT, MSG_CLONE,
                       MSG_UNMAP, MSG_DELETE, MSG_ADOPT_META})


@dataclass
class StackedReplica:
    """One replica's endpoint across S engine shards: every leaf carries a
    leading (S,) axis, and a message addresses one shard's slice
    (``msg.shard``) — executed by a flat ``Replica`` over that slice, whose
    pool is a view (pool writes land in place) and whose new metadata is
    written back into a fresh stacked copy (no tensor is shared with a
    donor or with an earlier state). ``QUERY_REV`` returns the (S,)
    revisions. The pool's foreground I/O rides the sharded step
    (core/sharded.py); the transport carries control and rebuild traffic."""

    state: dbs.DBSState          # leaves (S, ...)
    pool: torch.Tensor           # (S, E+1, page_blocks, *payload)
    page_rev: torch.Tensor       # (S, V, P) int32 last-write watermarks
    null_storage: bool = False

    def _slice(self, s: int) -> Replica:
        return Replica(state=pytree.tree_map(lambda x: x[s], self.state),
                       pool=self.pool[s], page_rev=self.page_rev[s],
                       null_storage=self.null_storage)

    def _write_back(self, s: int, view: Replica) -> None:
        def put(full, new):
            out = full.clone()
            out[s] = new
            return out
        self.state = pytree.tree_map(put, self.state, view.state)
        self.page_rev = put(self.page_rev, view.page_rev)

    def execute(self, msg: WireMsg) -> Any:
        if msg.op == MSG_QUERY_REV:
            return self.state.revision       # (S,); the caller slices
        if msg.shard is None:
            raise ValueError("stacked endpoints need msg.shard")
        view = self._slice(msg.shard)
        out = view.execute(msg)
        if msg.op in _META_OPS:
            self._write_back(msg.shard, view)
        return out


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------
class ReplicaTransport:
    """The delivery contract between controller and one replica endpoint:
    ``post`` returns a future, ``tick`` advances simulated time (a no-op
    in-process), ``wait``/``drain`` tick until delivery. ``sent`` counts
    posted messages per opcode name, ``pages_moved`` the pool rows through
    the rebuild stream (``sent_by_shard``/``pages_moved_by_shard``: the
    same per ``msg.shard``, None for flat endpoints), and ``latency_ewma``
    is the observed delivery latency in ticks that the latency read policy
    consults."""

    name = "?"
    in_process = True            # delivery is an immediate endpoint call

    # livelock guard for wait/drain: a drop rate near 1 would spin forever
    MAX_WAIT_TICKS = 1_000_000

    def __init__(self, endpoint):
        self.endpoint = endpoint
        self.sent: collections.Counter = collections.Counter()
        self.delivered = 0
        self.retransmits = 0
        self.pages_moved = 0
        self.sent_by_shard: collections.Counter = collections.Counter()
        self.pages_moved_by_shard: collections.Counter = \
            collections.Counter()
        self.latency_ewma = 0.0

    def _account(self, msg: WireMsg) -> None:
        self.sent[MSG_NAMES[msg.op]] += 1
        self.sent_by_shard[msg.shard] += 1
        if msg.op in (MSG_FETCH_PAGES, MSG_PUSH_PAGES):
            self.pages_moved += int(len(msg.extents))
            self.pages_moved_by_shard[msg.shard] += int(len(msg.extents))

    def messages_sent(self) -> int:
        return sum(self.sent.values())

    def post(self, msg: WireMsg) -> MsgFuture:          # pragma: no cover
        raise NotImplementedError

    def call(self, msg: WireMsg) -> Any:
        """Synchronous convenience: post and wait for delivery."""
        return self.post(msg).result()

    def tick(self) -> None:
        """Advance simulated time one step (no-op in-process)."""

    def pending(self) -> int:
        return 0

    def wait(self, fut: MsgFuture) -> None:
        for _ in range(self.MAX_WAIT_TICKS):
            if fut.done:
                return
            self.tick()
        raise RuntimeError(f"{self.name} transport livelocked waiting for "
                           f"{MSG_NAMES[fut.msg.op]} (drop rate too high?)")

    def drain(self) -> None:
        for _ in range(self.MAX_WAIT_TICKS):
            if not self.pending():
                return
            self.tick()
        raise RuntimeError(f"{self.name} transport livelocked draining")

    def cancel_pending(self) -> int:
        """Tear down undelivered messages (the controller cutting the link
        to a replica it declared failed: in-flight ops to it are lost, and
        rebuild resyncs whatever landed)."""
        return 0


class LocalTransport(ReplicaTransport):
    """In-process delivery: ``post`` executes the message on the endpoint
    immediately."""

    name = "local"

    def post(self, msg: WireMsg) -> MsgFuture:
        self._account(msg)
        fut = MsgFuture(self, msg)
        fut.value = self.endpoint.execute(msg)
        fut.done = True
        self.delivered += 1
        return fut


class DeviceTransport(LocalTransport):
    """LocalTransport over a device-resident endpoint: the engines whose
    data plane is one step on the device (fused) thread the endpoint
    tensors through that step, and this transport carries their control
    and rebuild traffic."""

    name = "device"


class SimNetTransport(ReplicaTransport):
    """A simulated network link to one replica.

    - every message is delivered ``latency`` ticks after it was posted,
    - at most ``window`` messages are in flight; a post past the window
      ticks until a slot frees (backpressure),
    - ``drop`` loses a delivery attempt with that probability; the message
      stays at the head and redelivers after another latency period (FIFO
      survives; ``retransmits`` counts the losses),
    - ``reorder`` swaps the two head messages with that probability when
      both are due (fault injection: it breaks FIFO).

    Deterministic under ``seed``: the draws are those of the reference's
    ``np.random.default_rng(seed)``, in the same order.
    """

    name = "simnet"
    in_process = False

    def __init__(self, endpoint, *, latency: int = 2, window: int = 8,
                 drop: float = 0.0, reorder: float = 0.0, seed: int = 0):
        super().__init__(endpoint)
        if latency < 1:
            raise ValueError(f"latency must be >= 1 tick, got {latency}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.latency = latency
        self.window = window
        self.drop = drop
        self.reorder = reorder
        self.rng = np.random.default_rng(seed)
        self.now = 0
        self.queue: collections.deque = collections.deque()  # [fut, due]

    def post(self, msg: WireMsg) -> MsgFuture:
        for _ in range(self.MAX_WAIT_TICKS):
            if len(self.queue) < self.window:
                break
            self.tick()                      # backpressure: window is full
        else:
            raise RuntimeError("simnet window never freed (livelock)")
        self._account(msg)
        fut = MsgFuture(self, msg)
        fut.posted_at = self.now
        self.queue.append([fut, self.now + self.latency])
        return fut

    def tick(self) -> None:
        self.now += 1
        while self.queue and self.queue[0][1] <= self.now:
            if (self.reorder and len(self.queue) > 1
                    and self.queue[1][1] <= self.now
                    and self.rng.random() < self.reorder):
                self.queue[0], self.queue[1] = self.queue[1], self.queue[0]
            entry = self.queue[0]
            if self.drop and self.rng.random() < self.drop:
                # lost on the wire: retransmit after another latency period;
                # later messages wait behind it (in-order delivery)
                self.retransmits += 1
                entry[1] = self.now + self.latency
                break
            self.queue.popleft()
            fut = entry[0]
            fut.value = self.endpoint.execute(fut.msg)
            fut.done = True
            self.delivered += 1
            lat = float(self.now - fut.posted_at)
            self.latency_ewma = (lat if self.delivered == 1 else
                                 0.8 * self.latency_ewma + 0.2 * lat)

    def pending(self) -> int:
        return len(self.queue)

    def cancel_pending(self) -> int:
        n = len(self.queue)
        for fut, _ in self.queue:
            fut.done = True
            fut.cancelled = True
        self.queue.clear()
        return n


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, Callable[..., ReplicaTransport]] = {}


def register_transport(name: str, factory: Optional[Callable] = None, *,
                       override: bool = False):
    """Register ``factory(endpoint, **opts) -> ReplicaTransport`` under
    ``name``; usable directly or as a decorator. Duplicate names raise
    unless ``override=True``."""
    def _put(f):
        if name in _REGISTRY and not override:
            raise ValueError(
                f"duplicate transport {name!r} (registered: "
                f"{', '.join(available_transports())}); pass override=True "
                "to replace")
        _REGISTRY[name] = f
        return f
    if factory is None:
        return _put
    return _put(factory)


def available_transports() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_transport(name: str, endpoint, **opts) -> ReplicaTransport:
    """Instantiate the transport registered under ``name`` for one replica
    endpoint; ``opts`` are its knobs (simnet: latency / window / drop /
    reorder / seed)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown transport {name!r} (registered: "
            f"{', '.join(available_transports())})") from None
    return factory(endpoint, **opts)


register_transport("local", LocalTransport)
register_transport("device", DeviceTransport)
register_transport("simnet", SimNetTransport)
