"""The SQ/CQ ring protocol: one opcode-tagged submission path for data AND
control ops (paper §IV-B/C).

Port of ``repro/core/ring.py``:

- **SQE** — one fixed-shape submission batch, opcode-tagged (READ / WRITE /
  SNAPSHOT / CLONE / UNMAP / DELETE / FAIL_REPLICA / REBUILD_REPLICA /
  COMPUTE / NOOP barrier), admitted through the slot table like any other
  request; the Messages Array records each slot's opcode and function id.
- **CQ** — device-resident completion records indexed by slot id: status,
  op result value, latency in pump ticks and the read payload. The step
  scatters one record per admitted lane; the host fetches the per-lane
  view (``CQEView``) once a pump.
- **the ring step** — one pump: the data phase (mirrored CoW writes, the
  round-robin reads), the compute phase (storage functions, compute/
  phase.py), the volume-control tail in lane order, then the replica-control
  op against the device health mask.
- **RingFrontend** — THE drain protocol: S shards x Q admission queues and
  one opcode-aware drain. The legacy ``MultiQueueFrontend`` and
  ``ShardedFrontend`` are thin adapters over it (core/frontend.py).
- **RingEngine** — ``EngineConfig(comm="ring")``, ``backend="ring"``: S
  engine shards on a ``ShardedReplicaGroup``, a pipelined pump.

The step is EnginePool's (core/sharded.py) with opcodes. A ctypes kernel
cannot run under ``torch.func.vmap``, so the metadata half (admission with
``opcodes``/``fnids``, each replica's ``write_pages`` and watermark stamp,
the read routes, the CQE scatter) is mapped over the shard axis
(``vmap_shards``; at S=1 unmapped), and the DBS kernels run outside the map
on each replica's flattened ``(S*(E+1), page, *payload)`` pool: one write
launch a replica for the data phase (and one more for a compare-and-write
commit) and one routed read launch a replica. The reference scans the
control and compute windows in-program with a ``lax.switch`` over op
class; here each lane's op, volume, page and function are already on the
host in the staged lanes (``RingFrontend._stage``), so the host walks the
windows in lane order and the device applies each op, selected by the
lane's admission flag with ``torch.where``: nothing is read back. Control
ops apply to every replica slice, healthy or not (the lock-step
convention), and an in-band REBUILD copies the donor's pool into the
target's in place, one masked pass a candidate donor, with no pool-sized
temporary.

Batch-ordering contract (what makes in-band control exact against the
host-side sequential reference): within one batch, data lanes precede
compute lanes, which precede control lanes (the drain cuts on every rank
change, a replica op closes the batch, a writing storage function closes
the compute window). The step applies the phases in that order, each in
lane order: submission order. Between batches, program order.
"""
from __future__ import annotations

import collections
import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.compute import registry as compute_registry
from repro_torch.compute.phase import apply_compute_ops, first_healthy
from repro_torch.core import dbs, slots
from repro_torch.core.control import ControlDispatch
from repro_torch.core.fused import read_routes, write_meta
from repro_torch.core.slots import register_pytree_dataclass
from repro_torch.core.transport import clone_page_rev

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
OP_COMPUTE = 9     # in-band storage function (repro_torch/compute)

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
# positive status: the op ran, its predicate did not hold (CAS expectation
# miss, verify_on_read checksum mismatch): not an I/O error. Canonical in
# repro_torch/compute/registry.py (this module imports the compute
# package; never the reverse).
ST_MISMATCH = compute_registry.ST_MISMATCH

# max control ops per batch (the reference's in-program control window;
# here the drain's cap)
CTRL_TAIL = 8

# max COMPUTE ops per batch (EngineConfig.compute_tail overrides per
# engine). Compute is its own batch rank between data and control.
COMPUTE_TAIL = 8

_LANE_FIELDS = ("op", "volume", "page", "block", "queue", "tick", "fn",
                "arg")


# ---------------------------------------------------------------------------
# SQE / CQ records
# ---------------------------------------------------------------------------
@register_pytree_dataclass
@dataclass
class SQE:
    """One fixed-shape submission batch: the opcode-tagged generalisation of
    ``fused.FusedBatch``. Lanes are (S, B) stacked (one shard's slice under
    the map), inert padding lanes marked want=False. ``block`` doubles as
    the replica index of FAIL/REBUILD lanes and as the page count of a
    range-scoped COMPUTE lane; ``tick`` is the submission pump tick
    (latency = admission step - tick + 1)."""
    want: torch.Tensor       # (B,) bool
    op: torch.Tensor         # (B,) int32 opcode (OP_*)
    volume: torch.Tensor     # (B,) int32 shard-local volume (-1 = none)
    page: torch.Tensor       # (B,) int32
    block: torch.Tensor      # (B,) int32 block offset / replica index
    payload: torch.Tensor    # (B, *payload) write payloads
    queue: torch.Tensor      # (B,) int32 admission queue
    tick: torch.Tensor       # (B,) int32 submission pump tick
    fn: torch.Tensor         # (B,) int32 storage-fn id (COMPUTE lanes)
    arg: torch.Tensor        # (B,) int32 storage-fn immediate argument
    step: torch.Tensor       # ()   int32 admission step (this pump's tick)


@register_pytree_dataclass
@dataclass
class CQ:
    """Device-resident completion records, indexed by slot id. A slot's
    record lives until the slot is reacquired."""
    status: torch.Tensor     # (N,) int32 ST_*
    value: torch.Tensor      # (N,) int32 op result (snapshot id / clone vol)
    latency: torch.Tensor    # (N,) int32 completion latency in pump ticks
    payload: torch.Tensor    # (N, *payload) read payload slots


@register_pytree_dataclass
@dataclass
class CQEView:
    """The per-lane view of this pump's completion records: what the host
    fetches once a pump."""
    ok: torch.Tensor         # (B,) bool  lane admitted (and thus completed)
    status: torch.Tensor     # (B,) int32
    value: torch.Tensor      # (B,) int32
    latency: torch.Tensor    # (B,) int32
    reads: torch.Tensor      # (B, *payload)


def make_cq(n_slots: int, payload_shape: Tuple[int, ...] = (), *,
            device) -> CQ:
    z = lambda: torch.zeros((n_slots,), dtype=torch.int32, device=device)
    return CQ(status=z(), value=z(), latency=z(),
              payload=torch.zeros((n_slots,) + tuple(payload_shape),
                                  dtype=torch.float32, device=device))


def make_sharded_cq(n_shards: int, n_slots: int,
                    payload_shape: Tuple[int, ...] = (), *, device) -> CQ:
    return pytree.tree_map(
        lambda x: x[None].repeat((n_shards,) + (1,) * x.dim()).contiguous(),
        make_cq(n_slots, payload_shape, device=device))


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


def _to_device(a, device: torch.device) -> torch.Tensor:
    """A staged numpy leaf on ``device`` in one transfer; to a card through
    pinned memory and without blocking, so the pump never waits on it."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# the step's mapped metadata half (one shard's slice; vmap-safe)
# ---------------------------------------------------------------------------
def _shard_meta(table, states, page_revs, sqe: SQE, rr, healthy, *,
                write: bool, null_backend: bool, null_storage: bool):
    """One shard's metadata step: admission (recording opcodes and function
    ids), the data phase's writes when the batch has a write lane, and the
    read routes of its read lanes. Returns ``(table', states', page_revs',
    slot ids, ok, write ops, read routes)``."""
    table, ids, ok = slots.transact(table, sqe.want, sqe.volume, sqe.queue,
                                    sqe.step, opcodes=sqe.op, fnids=sqe.fn)
    ops, routes = (), ()
    if not null_backend and states:
        if write:
            states, page_revs, ops = write_meta(
                states, page_revs, sqe, ok & (sqe.op == OP_WRITE), healthy,
                null_storage=null_storage)
        if not null_storage:
            routes = read_routes(states, sqe, rr, ok & (sqe.op == OP_READ),
                                 healthy)
    return table, states, page_revs, ids, ok, ops, routes


def _shard_commit(states, page_revs, sqe: SQE, wmask, healthy):
    """The compare-and-write commit: the data phase's write under the
    writing compute lane's mask."""
    return write_meta(states, page_revs, sqe, wmask, healthy)


def _scatter_rows(a: torch.Tensor, idx: torch.Tensor, v: torch.Tensor):
    """``a.at[idx].set(v, mode="drop")`` for (B, ...) rows ``v``; index
    ``len(a)`` is a dump row, sliced off."""
    padded = torch.cat([a, a.new_zeros((1,) + a.shape[1:])])
    padded[idx] = v.to(a.dtype)
    return padded[:-1]


def _shard_emit(table, cq: CQ, ids, ok, status, value, latency, reads):
    """CQE emission, one record per admitted lane at its slot id, and the
    status mirrored into the Messages Array's status lane."""
    idx = torch.where(ok, ids, cq.status.shape[0]).long()
    cq = CQ(status=_scatter_rows(cq.status, idx, status),
            value=_scatter_rows(cq.value, idx, value),
            latency=_scatter_rows(cq.latency, idx, latency),
            payload=_scatter_rows(cq.payload, idx, reads))
    table = dataclasses.replace(
        table, status=_scatter_rows(table.status, idx, status))
    return table, cq


def routed_read(kern, pools, routes, block, payload) -> torch.Tensor:
    """The read phase over shard-stacked pools: one routed read launch a
    replica (``kern.read_stacked``), where each read lane carries its
    extent on the replica that serves it (``fused.read_routes``) and is a
    hole (-1: zeros, no load) on the others, so a chain of selects returns
    each lane's one block. Zeros when there is no route (the null cuts).
    Shared by the ring and ``EnginePool``."""
    reads = None
    for pool, route in zip(pools, routes):
        vals = kern.read_stacked(pool, route, block)
        if reads is None:
            reads = vals
        else:
            hit = (route >= 0).reshape(route.shape + (1,) * (vals.dim() - 2))
            reads = torch.where(hit, vals, reads)
    return torch.zeros_like(payload) if reads is None else reads


# ---------------------------------------------------------------------------
# the host-walked tails (one shard's lanes, in lane order)
# ---------------------------------------------------------------------------
def _take(tree, s: int):
    return pytree.tree_map(lambda x: x[s], tree)


def _put(full_tree, s: int, part_tree):
    """A fresh stacked copy with shard ``s``'s slice replaced (no tensor is
    shared with the step's inputs)."""
    def put(full, part):
        out = full.clone()
        out[s] = part
        return out
    return pytree.tree_map(put, full_tree, part_tree)


def _select(live, new, old):
    return pytree.tree_map(lambda n, o: torch.where(live, n, o), new, old)


def _apply_vol_ops(states, page_revs, lanes, ok, value, status):
    """Apply the SNAPSHOT/CLONE/UNMAP/DELETE lanes ``[(shard, lane, op,
    volume, page)]`` in lane order, on EVERY replica slice, healthy or not
    (the lock-step convention, which lets a rebuild copy metadata
    wholesale). CLONE copies the source's watermark row
    (``clone_page_rev``). Each op's result is selected by the lane's
    admission flag; ``value``/``status`` are (S, B), updated in place.
    Returns ``(states', page_revs')``."""
    states, page_revs = list(states), list(page_revs)
    by_shard: Dict[int, list] = collections.defaultdict(list)
    for lane in lanes:
        by_shard[lane[0]].append(lane[1:])
    for s, shard_lanes in by_shard.items():
        sts = [_take(st, s) for st in states]
        prs = [pr[s] for pr in page_revs]
        for i, op, vol, page in shard_lanes:
            live = ok[s, i]
            val = None
            if op == OP_SNAPSHOT:
                outs = [dbs.snapshot(st, vol) for st in sts]
            elif op == OP_CLONE:
                outs = [dbs.clone(st, vol) for st in sts]
                # each replica clones its own state (lock-step ids) and its
                # watermark row inherits the source's
                prs = [torch.where(live, clone_page_rev(pr, vol, vid), pr)
                       for pr, (_, vid) in zip(prs, outs)]
            elif op == OP_UNMAP:
                pages = torch.full((1,), page, dtype=torch.int64,
                                   device=live.device)
                outs = [(dbs.unmap(st, vol, pages), None) for st in sts]
            else:
                outs = [(dbs.delete_volume(st, vol), None) for st in sts]
            sts = [_select(live, new, old) for (new, _), old in
                   zip(outs, sts)]
            val = outs[0][1]
            if val is not None:
                # snapshot/clone report failure (table full, dead volume)
                # through a negative id; unmap/delete are no-op-on-miss
                value[s, i] = torch.where(live, val, value[s, i])
                status[s, i] = torch.where(live & (val < 0), ST_ERR,
                                           status[s, i])
        states = [_put(full, s, part) for full, part in zip(states, sts)]
        page_revs = [_put(full, s, part)
                     for full, part in zip(page_revs, prs)]
    return tuple(states), tuple(page_revs)


def _apply_repl_ops(states, pools, page_revs, healthy, lanes, ok, status):
    """Apply each shard's (at most one: the drain closes the batch on it)
    FAIL/REBUILD lane ``[(shard, lane, op, replica)]`` against the device
    health mask.

    FAIL clears the mask bit unless the target is the shard's last healthy
    replica (-> ST_LAST, mask untouched). REBUILD copies the healthy
    replica with the highest metadata revision (the donor, a device value)
    into the target — state, pool and watermarks, a whole copy — and marks
    it healthy; rebuilding a healthy replica is a protocol error
    (-> ST_HEALTHY). The target rides the lane's ``block``, so it is known
    on the host: its pool slice is overwritten in place, one masked
    ``torch.where`` pass a candidate donor, with no pool-sized temporary.
    Returns ``(states', page_revs', healthy')``."""
    n_rep = len(states)
    states, page_revs = list(states), list(page_revs)
    healthy = healthy.clone()
    for s, i, op, tgt in lanes:
        live = ok[s, i]
        if not 0 <= tgt < n_rep:
            status[s, i] = torch.where(live, ST_ERR, status[s, i])
            continue
        h = healthy[s].clone()
        n_h = h.to(torch.int32).sum()
        tgt_h = h[tgt]
        if op == OP_FAIL:
            done = live & (~tgt_h | (n_h > 1))
            lane_status = torch.where(
                live & tgt_h & (n_h <= 1), ST_LAST,
                torch.where(done, ST_OK, ST_ERR))
            new_tgt = tgt_h & ~done
        else:
            done = live & ~tgt_h & (n_h >= 1)
            lane_status = torch.where(live & tgt_h, ST_HEALTHY,
                                      torch.where(done, ST_OK, ST_ERR))
            new_tgt = tgt_h | done
            revs = torch.stack([st.revision[s] for st in states])
            donor = torch.argmax(torch.where(h, revs, -(2 ** 31) + 1))
            st_t = _take(states[tgt], s)
            pr_t = page_revs[tgt][s] if page_revs else None
            for r in range(n_rep):
                if r == tgt:
                    continue
                take = done & (donor == r)
                st_t = _select(take, _take(states[r], s), st_t)
                if pools:
                    tgt_pool = pools[tgt][s]
                    torch.where(take, pools[r][s], tgt_pool, out=tgt_pool)
                if page_revs:
                    pr_t = torch.where(take, page_revs[r][s], pr_t)
            states[tgt] = _put(states[tgt], s, st_t)
            if page_revs:
                page_revs[tgt] = _put(page_revs[tgt], s, pr_t)
        healthy[s, tgt] = torch.where(live, new_tgt, tgt_h)
        status[s, i] = torch.where(live, lane_status.to(status.dtype),
                                   status[s, i])
    return tuple(states), tuple(page_revs), healthy


# ---------------------------------------------------------------------------
# RingFrontend — THE drain protocol (legacy frontends adapt over it)
# ---------------------------------------------------------------------------
class RingFrontend:
    """S shards x Q admission queues feeding one opcode-tagged drain.

    Requests hash to shards by volume (``volume % S``; replica-control ops
    carry an explicit ``Request.shard``), then to a queue by request id.
    The submission tick is stamped on ``Request.tick`` at submit (requeues
    keep the original tick). ``with_table=True`` (the ring engine) builds
    the shard-stacked slot table on ``device``; the legacy adapters keep
    their own."""

    def __init__(self, n_shards: int, n_queues: int, n_slots: int,
                 batch: int = 64, with_table: bool = False,
                 compute_tail: int = COMPUTE_TAIL, *, device=None):
        self.n_shards = n_shards
        self.n_queues = n_queues
        self.n_slots = n_slots
        self.batch = batch
        self.compute_tail = compute_tail
        self.queues: List[List[collections.deque]] = [
            [collections.deque() for _ in range(n_queues)]
            for _ in range(n_shards)]
        self.table = (slots.make_sharded_table(n_shards, n_slots, device)
                      if with_table else None)
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
            # name -> registry id at the submission boundary (the unknown
            # name ValueError fires here, not at drain time)
            req.fnid = compute_registry.storage_fn_id(req.fn)
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
        contract: batch rank is data < compute < control, and the drain
        cuts on every rank change (compute lanes are contiguous, follow all
        data lanes and never share a batch with control lanes). A
        replica-control op closes the batch; at most CTRL_TAIL control and
        ``compute_tail`` compute ops join one batch, and a writing storage
        function closes the compute window (one CoW commit a batch).

        The drain never exceeds ``n_slots``: with the transact lifecycle a
        pump starts with every slot free, so such a batch cannot starve,
        and the pipelined drain never sees a starved suffix re-enter the
        queues behind the next pump."""
        reqs: List[Any] = []
        ctrl_seen = comp_seen = comp_closed = False
        n_ctrl = n_comp = 0
        limit = min(limit, self.n_slots)
        tail = min(CTRL_TAIL, limit)
        ctail = min(self.compute_tail, limit)
        qs = [q for q in self.queues[s] if q]
        while qs and len(reqs) < limit:
            for q in list(qs):
                if not q:
                    qs.remove(q)
                    continue
                k = KIND_CLASS[q[0].kind]
                if ctrl_seen and k not in ("vol", "repl"):
                    return reqs                  # rank downgrade: cut
                if comp_seen and k not in ("compute", "vol", "repl"):
                    return reqs                  # data after compute: cut
                if comp_seen and k in ("vol", "repl"):
                    return reqs                  # compute never joins control
                if k in ("vol", "repl") and n_ctrl >= tail:
                    return reqs                  # control window full
                if k == "compute" and (comp_closed or n_comp >= ctail):
                    return reqs                  # compute window closed/full
                r = q.popleft()
                # provisional latency in pump ticks, stamped at drain
                r.latency = self.step[s] - getattr(r, "tick", 0) + 1
                reqs.append(r)
                if k in ("vol", "repl"):
                    ctrl_seen = True
                    n_ctrl += 1
                if k == "compute":
                    comp_seen = True
                    n_comp += 1
                    if compute_registry.fn_writes(getattr(r, "fnid", 0)):
                        comp_closed = True
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
        for k in _LANE_FIELDS:
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
        return drained, {k: _to_device(v, torch.device(device))
                         for k, v in st.items()}, classes


# ---------------------------------------------------------------------------
# RingEngine — comm="ring": S shards, one opcode-dispatched step per pump
# ---------------------------------------------------------------------------
@dataclass
class PendingRing:
    """Completion handle of ``pump_async``: the request lists that rode the
    batch and the per-lane CQE view, in host memory once ``event`` (None
    off the card) has passed."""
    reqs: List[List[Any]]
    view: CQEView
    event: Optional[torch.cuda.Event] = None


class RingEngine(ControlDispatch):
    """S engine shards behind the opcode-dispatched ring step.

    API-compatible with ``EnginePool`` (create_volume/snapshot/submit/pump/
    pump_async/drain/completed/read_volume), plus in-band control:
    snapshot, clone, unmap, delete_volume, fail and rebuild are ring
    submissions that execute inside the same step as foreground I/O.
    Registered as ``backend="ring"``, the only backend whose submission
    path (``data_kinds``) takes control opcodes.

    The reference compiles one program per (batch geometry, opcode-class
    signature) and counts traces; eager PyTorch has no program, so
    ``step_counts`` counts pumps by the canonical signature (``_canon``'s
    seven tiers), ``write_steps`` the pumps with a write lane,
    ``kernel_calls`` the DBS kernel entries and ``dispatches`` the
    pumps."""

    is_pool = True
    data_kinds = frozenset(KIND_TO_OP)

    def __init__(self, cfg):
        if cfg.storage != "dbs":
            raise ValueError("RingEngine requires storage='dbs'")
        s = getattr(cfg, "n_shards", 1)
        if s < 1:
            raise ValueError(f"n_shards must be >= 1, got {s}")
        from repro_torch.core.replication import ShardedReplicaGroup
        from repro_torch.kernels.dbs.registry import (make_kernel,
                                                      resolve_kernel_name)
        self.cfg = cfg
        self.n_shards = s
        self.device = torch.device(cfg.device)
        self._compute_tail = getattr(cfg, "compute_tail", COMPUTE_TAIL)
        self.frontend = RingFrontend(s, cfg.n_queues, cfg.n_slots, cfg.batch,
                                     with_table=True,
                                     compute_tail=self._compute_tail,
                                     device=self.device)
        self.backend = None if cfg.null_backend else ShardedReplicaGroup(
            s, cfg.n_replicas, cfg.n_extents, cfg.max_volumes, cfg.max_pages,
            cfg.page_blocks, cfg.payload_shape,
            null_storage=cfg.null_storage, transport=cfg.transport,
            write_policy=cfg.write_policy, read_policy=cfg.read_policy,
            transport_opts=cfg.transport_opts, device=self.device)
        self.cq = make_sharded_cq(s, cfg.n_slots, cfg.payload_shape,
                                  device=self.device)
        self._kernel = resolve_kernel_name(cfg)
        self._kern = make_kernel(self._kernel)
        cuts = dict(null_backend=cfg.null_backend,
                    null_storage=cfg.null_storage)
        self._meta = {w: vmap_shards(partial(_shard_meta, write=w, **cuts), s)
                      for w in (False, True)}
        self._commit = vmap_shards(_shard_commit, s)
        self._emit = vmap_shards(_shard_emit, s)
        # the null backend's stand-ins for the health mask and the cursors
        self._no_health = torch.ones((s, 1), dtype=torch.bool,
                                     device=self.device)
        self._no_rr = torch.zeros((s,), dtype=torch.int32, device=self.device)
        self._vol_rr = 0
        self._ctl_seq = 1 << 30      # control-op request ids
        self.completed = 0
        self.dispatches = 0
        self.step_counts: Dict[Tuple[str, ...], int] = {}
        self.write_steps = 0         # pumps with a write lane
        self.kernel_calls = {"write": 0, "read": 0}

    # ------------------------------------------------------------ signatures
    @staticmethod
    def _canon(classes: Set[str]) -> Tuple[str, ...]:
        """Canonical step signature of a drained batch. Each tier includes
        the cheaper ones (masked lanes are inert), so at most SEVEN exist a
        batch geometry. Compute gets its own tier (the drain never mixes
        compute with control lanes within a shard), and the control tiers
        gain compute-including variants for one pump that drains control
        on one shard and computes on another."""
        if "repl" in classes:
            base = ("read", "repl", "vol", "write")
        elif "vol" in classes:
            base = ("read", "vol", "write")
        elif "compute" in classes:
            return ("compute", "read", "write")
        elif "write" in classes:
            return ("read", "write")
        else:
            return ("read",)
        if "compute" in classes:
            return ("compute",) + base
        return base

    # ------------------------------------------------------------ volumes
    def create_volume(self) -> int:
        """Create a volume on the next shard (round-robin placement);
        global id = local * S + shard, as in EnginePool."""
        shard = self._vol_rr % self.n_shards
        self._vol_rr += 1
        local = 0 if self.backend is None else self.backend.create_volume(
            shard)
        return local * self.n_shards + shard

    def read_volume(self, vol: int, pages, block_offsets):
        """Host read path for verification (the pump serves reads
        in-band)."""
        if self.backend is None:
            raise RuntimeError("null backend holds no volumes")
        return self.backend.read(vol % self.n_shards, vol // self.n_shards,
                                 pages, block_offsets)

    # ----------------------------------------------------- in-band control
    def _control(self, kind: str, *, volume: int = -1, page: int = 0,
                 block: int = 0, shard: Optional[int] = None):
        """Submit one control request and drain to completion: the
        synchronous wrapper over the in-band path. Replica-protocol
        violations raise (like ``ShardedReplicaGroup.fail/rebuild``); a
        failed snapshot/clone reports a negative result id."""
        from repro_torch.core.frontend import Request
        r = Request(req_id=self._ctl_seq, kind=kind, volume=volume,
                    page=page, block=block, shard=shard)
        self._ctl_seq += 1
        self.submit(r)
        self.drain()
        if r.status == ST_LAST:
            raise RuntimeError(
                f"replica {block} is shard {shard}'s last healthy replica; "
                "failing it would lose the shard's volumes")
        if r.status == ST_HEALTHY:
            raise ValueError(f"shard {shard} replica {block} is healthy; "
                             "only a failed replica can be rebuilt")
        return r.result

    def snapshot(self, vol: int):
        """Freeze the volume head, in-band. Returns the shard-local
        snapshot id, -1 on failure (dead volume, table full)."""
        return self._control("snapshot", volume=vol)

    def clone(self, vol: int) -> int:
        """Fork a volume in-band. Returns the new global volume id, -1 on
        failure, as ``EnginePool.clone``."""
        out = self._control("clone", volume=vol)
        return -1 if out is None or out < 0 else out

    def unmap(self, vol: int, pages: Sequence[int]) -> None:
        """TRIM pages in-band (one request a page; they share batches)."""
        from repro_torch.core.frontend import Request
        for p in pages:
            r = Request(req_id=self._ctl_seq, kind="unmap", volume=vol,
                        page=int(p))
            self._ctl_seq += 1
            self.submit(r)
        self.drain()

    def delete_volume(self, vol: int) -> None:
        self._control("delete", volume=vol)

    def fail(self, shard: int, replica: int) -> None:
        """In-band replica failover (raises like the host-side controller
        on protocol violations, from the CQE status)."""
        if self.backend is not None:
            self.backend._check(shard, replica)
        self._control("fail", shard=shard, block=replica)

    def rebuild(self, shard: int, replica: int) -> None:
        if self.backend is not None:
            self.backend._check(shard, replica)
        self._control("rebuild", shard=shard, block=replica)

    # -------------------------------------------------- backend protocol
    @property
    def storage(self):
        """The replica storage behind this backend (core/backends.py)."""
        return self.backend

    def _control_repl(self, kind, shard, replica):
        # in-band FAIL/REBUILD requests (ControlDispatch.control routes here)
        fn = self.fail if kind == "fail" else self.rebuild
        return fn(shard, replica)

    def depth(self) -> int:
        return self.frontend.depth()

    def submit(self, req) -> None:
        if req.kind not in self.data_kinds:
            raise ValueError(f"unknown request kind {req.kind!r} "
                             f"(expected one of {sorted(self.data_kinds)})")
        # out-of-range ids would index past the device tables (JAX clamps
        # or drops them; a CUDA gather faults)
        cfg, k = self.cfg, KIND_CLASS[req.kind]
        if k in ("read", "write", "vol", "compute"):
            bad = not (req.volume >= 0
                       and req.volume // self.n_shards < cfg.max_volumes)
            if k in ("read", "write") or req.kind == "unmap":
                bad = bad or not 0 <= req.page < cfg.max_pages
            if k in ("read", "write"):
                bad = bad or not 0 <= req.block < cfg.page_blocks
            if bad:
                raise ValueError(
                    f"{req.kind} request out of range: volume {req.volume} "
                    f"(of {cfg.max_volumes} a shard, {self.n_shards} "
                    f"shards), page {req.page} (of {cfg.max_pages}), block "
                    f"{req.block} (of {cfg.page_blocks})")
        self.frontend.submit(req)

    # ------------------------------------------------------------- pumping
    def _write(self, pools, ops, sqe: SQE) -> None:
        for pool, wops in zip(pools, ops):     # in place, every replica
            self._kern.write_stacked(pool, wops, sqe.payload, sqe.block)
            self.kernel_calls["write"] += 1

    def pump_async(self) -> Optional[PendingRing]:
        """Admit one opcode-tagged batch a shard and launch the ring step;
        do NOT wait. Control and compute lanes run in the same step as the
        data lanes: no host dispatch per control op, nothing read back."""
        drained, st, classes = self.frontend._stage(self.cfg.payload_shape)
        if st is None:
            return None
        dev = self.device
        # the device lanes' block and page index the pools and tables even
        # where a lane's op reads them as something else (a replica, a page
        # count) or masks them out: clip them into range (JAX clamps, a
        # CUDA gather faults); the host walks read the staged values
        lanes = dict(st, block=np.clip(st["block"], 0,
                                       self.cfg.page_blocks - 1),
                     page=np.clip(st["page"], 0, self.cfg.max_pages - 1))
        sqe = SQE(**{k: _to_device(lanes[k], dev)
                     for k in ("want", "payload", "step") + _LANE_FIELDS})
        if self.backend is None:
            states, pools, page_revs = (), (), ()
            healthy, rr = self._no_health, self._no_rr
        else:
            states, pools, healthy = self.backend.device_state()
            page_revs = self.backend.device_page_revs()
            rr = self.backend.bump_rr()
        key = self._canon(classes)
        self.step_counts[key] = self.step_counts.get(key, 0) + 1
        self.dispatches += 1
        # every tier but the read-only one runs the write phase's metadata
        # (its revision bumps are the reference's); the kernels launch only
        # for a batch with a write lane (otherwise every lane is inert)
        table, states, page_revs, ids, ok, ops, routes = \
            self._meta["write" in key](self.frontend.table, states,
                                       page_revs, sqe, rr, healthy)
        if ops and pools and "write" in classes:
            self.write_steps += 1
            self._write(pools, ops, sqe)
        reads = routed_read(self._kern, pools, routes, sqe.block,
                            sqe.payload)
        self.kernel_calls["read"] += len(routes)
        s_n, b_n = ok.shape
        status = torch.zeros((s_n, b_n), dtype=torch.int32, device=dev)
        value = torch.full((s_n, b_n), -1, dtype=torch.int32, device=dev)
        if states:
            if "compute" in key and pools:
                states, page_revs = self._compute_phase(
                    st, sqe, states, pools, page_revs, healthy, ok, value,
                    status, reads)
            if "vol" in key:
                states, page_revs = _apply_vol_ops(
                    states, page_revs, self._lanes(st, (OP_SNAPSHOT,
                                                        OP_CLONE, OP_UNMAP,
                                                        OP_DELETE),
                                                   ("volume", "page")),
                    ok, value, status)
            if "repl" in key:
                states, page_revs, healthy = _apply_repl_ops(
                    states, pools, page_revs, healthy,
                    self._lanes(st, (OP_FAIL, OP_REBUILD), ("block",)), ok,
                    status)
        latency = (sqe.step[:, None] - sqe.tick + 1).to(torch.int32)
        table, self.cq = self._emit(table, self.cq, ids, ok, status, value,
                                    latency, reads)
        self.frontend.table = table
        if self.backend is not None and key != ("read",):
            self.backend.set_device_state(states, pools)
            self.backend.set_device_page_revs(page_revs)
            if "repl" in key:
                # only a repl step changes health; the host mirror is
                # fetched lazily, on the control path
                self.backend.adopt_health(healthy)
        view = CQEView(ok=ok, status=status, value=value, latency=latency,
                       reads=reads)
        if dev.type != "cuda":
            return PendingRing(reqs=drained, view=view)
        host = pytree.tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True),
            view)
        for h, t in zip(pytree.tree_leaves(host), pytree.tree_leaves(view)):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return PendingRing(reqs=drained, view=host, event=event)

    @staticmethod
    def _lanes(st, ops, fields):
        """``[(shard, lane, op, *fields)]`` of the staged lanes carrying
        one of ``ops``, in lane order (host ints)."""
        hit = st["want"] & np.isin(st["op"], ops)
        return [(int(s), int(i), int(st["op"][s, i]))
                + tuple(int(st[f][s, i]) for f in fields)
                for s, i in zip(*np.nonzero(hit))]

    def _compute_phase(self, st, sqe: SQE, states, pools, page_revs,
                       healthy, ok, value, status, reads):
        """Each shard's compute lanes in lane order against its first
        healthy replica (the pump's health, before any repl lane), then
        the commit through the data phase's write: one ``write_pages`` a
        replica under the writing lanes' mask (run on every compute pump,
        as the reference runs it while a writing function is registered),
        and one write launch a replica when a lane commits."""
        fields = ("volume", "page", "block", "fn", "arg")
        by_shard: Dict[int, list] = collections.defaultdict(list)
        for s, i, _op, *f in self._lanes(st, (OP_COMPUTE,), fields):
            by_shard[s].append((i, dict(zip(fields, f))))
        commits = []
        for s, lanes in by_shard.items():
            got = apply_compute_ops(
                [x.table[s] for x in states], [p[s] for p in pools],
                first_healthy(healthy[s]), lanes, sqe.payload[s], ok[s],
                value[s], status[s], reads[s], kern=self._kern,
                n_volumes=self.cfg.max_volumes)
            if got is not None:
                commits.append((s,) + got)
        if not any(e.writes for e in compute_registry.device_table()):
            return states, page_revs
        wmask = torch.zeros(ok.shape, dtype=torch.bool, device=ok.device)
        for s, i, do_write in commits:
            wmask[s, i] = do_write
        states, page_revs, ops = self._commit(states, page_revs, sqe, wmask,
                                              healthy)
        if commits:
            self._write(pools, ops, sqe)
        return states, page_revs

    def _fetch(self, p: PendingRing):
        """The pump's one host transfer: the per-lane CQE view as numpy
        (on the card, waiting on the event of the pinned copies that
        ``pump_async`` queued)."""
        if p.event is not None:
            p.event.synchronize()
        v = p.view
        return tuple(t.numpy() for t in (v.ok, v.status, v.value, v.latency,
                                         v.reads))

    def _complete(self, p: PendingRing) -> int:
        """The pump's single host hop: deliver result/status/latency,
        requeue not-admitted requests."""
        ok, status, value, latency, reads = self._fetch(p)
        done = 0
        requeues = []
        for s, shard_reqs in enumerate(p.reqs):
            for i, r in enumerate(shard_reqs):
                if not ok[s, i]:
                    requeues.append(r)
                    continue
                r.status = int(status[s, i])
                r.latency = int(latency[s, i])
                if r.kind == "read":
                    r.result = reads[s, i]
                elif r.kind == "snapshot":
                    r.result = int(value[s, i])
                elif r.kind == "clone":
                    local = int(value[s, i])
                    r.result = (local * self.n_shards + s if local >= 0
                                else -1)
                elif r.kind == "compute":
                    # (scalar result, payload lanes): blockdev wraps it
                    r.result = (int(value[s, i]), reads[s, i])
                done += 1
        self.frontend.requeue_all(requeues)
        self.completed += done
        return done

    def pump(self) -> int:
        p = self.pump_async()
        return self._complete(p) if p is not None else 0

    def drain(self, max_iters: int = 100_000) -> int:
        """Pipelined drain: launch pump N+1, then complete pump N."""
        total = 0
        pending: Optional[PendingRing] = None
        for _ in range(max_iters):
            nxt = self.pump_async()
            if pending is not None:
                total += self._complete(pending)
            pending = nxt
            if nxt is None and self.frontend.depth() == 0:
                break
        if pending is not None:
            total += self._complete(pending)
        return total
