"""The SQ/CQ ring protocol, host half: opcodes, the drain and the shard map.

Port of the host half of ``repro/core/ring.py``: the opcode table, the
completion statuses and ``RingFrontend`` — S shards x Q admission queues
drained under the batch-ordering contract into host-side numpy lane
buffers, and ``vmap_shards``, which maps one shard's step over the shard
axis (core/sharded.py). The device half (SQE/CQ records, the opcode-dispatched step,
``RingEngine``) and the COMPUTE opcode class land with the ring slice.

Batch-ordering contract: within one batch, data lanes precede control
lanes (once a control op is drained only further control ops may join, and
a replica op closes the batch), so applying the data phase first and the
control tail in lane order reproduces submission order.
"""
from __future__ import annotations

import collections
from typing import Any, List, Sequence, Set, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

# ---------------------------------------------------------------------------
# the opcode table (SQE.op) and completion statuses (CQE.status)
# ---------------------------------------------------------------------------
OP_NOOP = 0        # barrier: admit + complete, touches nothing
OP_READ = 1
OP_WRITE = 2
OP_SNAPSHOT = 3    # volume-control ops (applied in lane order)
OP_CLONE = 4
OP_UNMAP = 5
OP_DELETE = 6
OP_FAIL = 7        # replica-control ops (close their batch)
OP_REBUILD = 8
OP_COMPUTE = 9     # in-band storage function

OP_NAMES = ("NOOP", "READ", "WRITE", "SNAPSHOT", "CLONE", "UNMAP", "DELETE",
            "FAIL_REPLICA", "REBUILD_REPLICA", "COMPUTE")

KIND_TO_OP = {"noop": OP_NOOP, "read": OP_READ, "write": OP_WRITE,
              "snapshot": OP_SNAPSHOT, "clone": OP_CLONE, "unmap": OP_UNMAP,
              "delete": OP_DELETE, "fail": OP_FAIL, "rebuild": OP_REBUILD,
              "compute": OP_COMPUTE}

# opcode classes: which phases of the step a batch needs
KIND_CLASS = {"noop": "noop", "read": "read", "write": "write",
              "snapshot": "vol", "clone": "vol", "unmap": "vol",
              "delete": "vol", "fail": "repl", "rebuild": "repl",
              "compute": "compute"}

ST_OK = 0          # completed
ST_ERR = -1        # op rejected (bad volume / snapshot table full / bad arg)
ST_LAST = -2       # FAIL would lose the shard's last healthy replica
ST_HEALTHY = -3    # REBUILD target is healthy — nothing to rebuild
ST_MISMATCH = 1    # the op ran, its predicate did not hold (not an error)

# max control ops per batch (the device step's control-scan window)
CTRL_TAIL = 8


def vmap_shards(fn, n_shards: int):
    """Map ``fn`` over a leading (S,) shard axis with ``torch.func.vmap``.
    At S=1 it runs unmapped (squeeze, call, unsqueeze), as the reference
    does: the single shard pays no batching rule."""
    if n_shards == 1:
        def unmapped(*args):
            out = fn(*pytree.tree_map(lambda x: x[0], args))
            return pytree.tree_map(lambda x: x[None], out)
        return unmapped
    return torch.func.vmap(fn)


class RingFrontend:
    """S shards x Q admission queues feeding one opcode-tagged drain.

    Requests hash to shards by volume (``volume % S``; replica-control ops
    carry an explicit ``Request.shard``), then to a queue by request id.
    The submission tick is stamped on ``Request.tick`` at submit (requeues
    keep the original tick). The slot table lives with the engine that
    consumes the drain, not here."""

    def __init__(self, n_shards: int, n_queues: int, n_slots: int,
                 batch: int = 64):
        self.n_shards = n_shards
        self.n_queues = n_queues
        self.n_slots = n_slots
        self.batch = batch
        self.queues: List[List[collections.deque]] = [
            [collections.deque() for _ in range(n_queues)]
            for _ in range(n_shards)]
        self.step: List[int] = [0] * n_shards

    def shard_of(self, req) -> int:
        if getattr(req, "shard", None) is not None:
            return req.shard % self.n_shards
        return req.volume % self.n_shards if req.volume >= 0 else 0

    def submit(self, req) -> None:
        if req.kind not in KIND_TO_OP:
            raise ValueError(f"unknown request kind {req.kind!r} "
                             f"(expected one of {sorted(KIND_TO_OP)})")
        if req.kind == "compute":
            raise ValueError("kind='compute' lands with the ring/compute "
                             "slice of the port")
        s = self.shard_of(req)
        req.tick = self.step[s]
        self.queues[s][req.req_id % self.n_queues].append(req)

    def requeue(self, req) -> None:
        """Put a not-admitted request back at the front of its queue (its
        original submission tick is kept)."""
        self.queues[self.shard_of(req)][req.req_id % self.n_queues].appendleft(
            req)

    def requeue_all(self, reqs: Sequence[Any]) -> None:
        """Requeue a completion's not-admitted lanes, back-to-front:
        admission starves the batch SUFFIX, and an appendleft in forward
        order would reverse the starved lanes' order in their queues."""
        for req in reversed(list(reqs)):
            self.requeue(req)

    def depth(self) -> int:
        return sum(len(q) for qs in self.queues for q in qs)

    def _drain_shard(self, s: int, limit: int) -> List[Any]:
        """Round-robin drain of one shard under the batch-ordering
        contract: the drain cuts when a data op follows a control op, a
        replica-control op closes the batch, and at most CTRL_TAIL control
        ops join one batch. The drain never exceeds ``n_slots``: with the
        transact lifecycle a pump starts with every slot free, so such a
        batch cannot starve."""
        reqs: List[Any] = []
        ctrl_seen = False
        n_ctrl = 0
        limit = min(limit, self.n_slots)
        tail = min(CTRL_TAIL, limit)
        qs = [q for q in self.queues[s] if q]
        while qs and len(reqs) < limit:
            for q in list(qs):
                if not q:
                    qs.remove(q)
                    continue
                k = KIND_CLASS[q[0].kind]
                if ctrl_seen and k not in ("vol", "repl"):
                    return reqs                  # rank downgrade: cut
                if k in ("vol", "repl") and n_ctrl >= tail:
                    return reqs                  # control window full
                r = q.popleft()
                # provisional latency in pump ticks, stamped at drain
                r.latency = self.step[s] - getattr(r, "tick", 0) + 1
                reqs.append(r)
                if k in ("vol", "repl"):
                    ctrl_seen = True
                    n_ctrl += 1
                if k == "repl" or len(reqs) >= limit:
                    return reqs
        return reqs

    def _stage(self, payload_shape: Tuple[int, ...] = ()):
        """Drain every shard and fill host-side numpy lane buffers. Returns
        (per-shard request lists, staged dict | None, opcode classes)."""
        drained = [self._drain_shard(s, self.batch)
                   for s in range(self.n_shards)]
        if not any(drained):
            return [], None, set()
        s_n, b_n = self.n_shards, self.batch
        stage = {"want": np.zeros((s_n, b_n), bool),
                 "payload": np.zeros((s_n, b_n) + tuple(payload_shape),
                                     np.float32),
                 "step": np.zeros((s_n,), np.int32)}
        for k in ("op", "volume", "page", "block", "queue", "tick", "fn",
                  "arg"):
            stage[k] = np.zeros((s_n, b_n), np.int32)
        classes: Set[str] = set()
        for s, reqs in enumerate(drained):
            stage["step"][s] = self.step[s]
            if reqs:
                self.step[s] += 1
            for i, r in enumerate(reqs):
                classes.add(KIND_CLASS[r.kind])
                stage["want"][s, i] = True
                stage["op"][s, i] = KIND_TO_OP[r.kind]
                stage["volume"][s, i] = (r.volume // s_n if r.volume >= 0
                                         else -1)
                stage["page"][s, i] = r.page
                stage["block"][s, i] = r.block
                stage["queue"][s, i] = r.req_id % self.n_queues
                stage["tick"][s, i] = getattr(r, "tick", 0)
                stage["fn"][s, i] = getattr(r, "fnid", 0)
                stage["arg"][s, i] = getattr(r, "arg", 0)
                if r.payload is not None:
                    stage["payload"][s, i] = np.asarray(r.payload)
        return drained, stage, classes

    def drain_ring(self, payload_shape: Tuple[int, ...] = (), *, device):
        """The unified drain: one stacked (S, B, ...) batch per pump, each
        staged leaf moved to ``device`` in one transfer. Returns
        (per-shard request lists, dict of tensors named like the SQE fields
        | None, opcode classes)."""
        drained, st, classes = self._stage(payload_shape)
        if st is None:
            return [], None, set()
        return drained, {k: torch.from_numpy(v).to(device)
                         for k, v in st.items()}, classes
