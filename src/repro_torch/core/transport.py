"""Controller<->replica transport, local part: messages, endpoint, delivery.

Port of the local part of ``repro/core/transport.py``:

- **WireMsg** — an opcode-tagged controller->replica message,
- **Replica** — one replica's endpoint: its ``DBSState``, payload pool and
  per-page revision watermarks, executing control and query messages,
- **ReplicaTransport** / **LocalTransport** — the delivery contract and
  its in-process form (a ``post`` IS the endpoint call),
- ``stamp_page_rev`` / ``clone_page_rev`` — the watermark updates the fused
  step and clones make.

On the fused engine the data plane never rides messages: the controller
threads the endpoint tensors through the step, and the transport carries
control traffic. The host-dispatch backends (``loop``, ``slots``) send
their data as WRITE and READ messages. The ``device`` and ``simnet``
transports and the rebuild stream land with the transport slice.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

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
    """Completion handle for one posted message (done at post time on an
    in-process transport)."""

    __slots__ = ("transport", "msg", "value", "done")

    def __init__(self, transport: "ReplicaTransport", msg: WireMsg):
        self.transport = transport
        self.msg = msg
        self.value: Any = None
        self.done = False

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
    safe = new_vol.clamp(min=0)
    row = torch.where(new_vol >= 0, page_rev[int(src_vol)], page_rev[safe])
    out = page_rev.clone()
    out[safe] = row
    return out


# ---------------------------------------------------------------------------
# the replica endpoint (the server side of the boundary)
# ---------------------------------------------------------------------------
@dataclass
class Replica:
    """One replica endpoint: device-resident metadata state, payload pool
    and per-page revision watermarks. ``healthy`` is the controller's mark
    (the endpoint never consults it)."""

    state: dbs.DBSState
    pool: torch.Tensor           # (E+1, page_blocks, *payload)
    page_rev: torch.Tensor       # (V, P) int32 last-write watermarks
    healthy: bool = True

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
        if 0 <= op < len(MSG_NAMES):
            raise ValueError(f"wire opcode {MSG_NAMES[op]} lands with the "
                             "transport slice of the port")
        raise ValueError(f"unknown wire opcode {op}")


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------
class ReplicaTransport:
    """The delivery contract between controller and one replica endpoint:
    ``post`` returns a future, ``tick`` advances simulated time (a no-op
    in-process), ``wait``/``drain`` tick until delivery; ``sent`` counts
    posted messages per opcode name."""

    name = "?"

    MAX_WAIT_TICKS = 1_000_000

    def __init__(self, endpoint):
        self.endpoint = endpoint
        self.sent: collections.Counter = collections.Counter()
        self.delivered = 0

    def _account(self, msg: WireMsg) -> None:
        self.sent[MSG_NAMES[msg.op]] += 1

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
                           f"{MSG_NAMES[fut.msg.op]}")

    def drain(self) -> None:
        for _ in range(self.MAX_WAIT_TICKS):
            if not self.pending():
                return
            self.tick()
        raise RuntimeError(f"{self.name} transport livelocked draining")

    def cancel_pending(self) -> int:
        """Tear down undelivered messages (nothing is ever in flight
        in-process)."""
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
    """Instantiate the transport registered under ``name``."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown transport {name!r} (registered: "
            f"{', '.join(available_transports())}; device and simnet land "
            "with the transport slice of the port)") from None
    return factory(endpoint, **opts)


register_transport("local", LocalTransport)
