"""Controller<->replica layer: write/read policies over a pluggable transport.

Port of ``ReplicaGroup`` from ``repro/core/replication.py``. Every replica
is a transport endpoint (``transport.Replica``) reached only through
opcode-tagged ``WireMsg`` messages over a registered transport (local |
device | simnet):

- **write policies** decide when a mirrored write completes: ``all`` (every
  healthy replica acked; the paper's default), ``quorum`` (a majority
  acked; stragglers catch up over per-link FIFO), ``async`` (write-behind:
  acked at post time),
- **read policies** pick the serving replica: ``rr`` (round-robin, the
  paper's default) or ``latency`` (lowest observed link latency, queue
  depth then the rr cursor breaking ties),
- **rebuild is a streamed delta**: the target reports its per-page
  watermarks, the donor (healthy, highest revision) works out which
  extents back newer pages, only those pool rows cross in
  ``REBUILD_CHUNK``-row messages, and the donor's metadata is adopted.

The fused step (core/fused.py) applies ``all``/``rr`` inside the step and
threads the endpoint tensors through it; there the transport carries
control and rebuild traffic only. The host-dispatch backends (``loop``,
``slots``) post WRITE and READ messages, where the policies bite. The
shard-stacked group (``ShardedReplicaGroup``) comes with the shards slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import dbs
from repro_torch.core.transport import (MSG_ADOPT_META, MSG_CLONE,
                                        MSG_CREATE, MSG_DELETE,
                                        MSG_FETCH_DELTA, MSG_FETCH_PAGES,
                                        MSG_PUSH_PAGES, MSG_QUERY_REV,
                                        MSG_READ, MSG_SNAPSHOT, MSG_UNMAP,
                                        MSG_WATERMARKS, MSG_WRITE, MsgFuture,
                                        Replica, ReplicaTransport, WireMsg,
                                        make_transport)

WRITE_POLICIES = ("all", "quorum", "async")
READ_POLICIES = ("rr", "latency")

# extents per rebuild-stream message: bounds the transfer unit so a rebuild
# interleaves with (simulated) foreground traffic instead of one giant copy
REBUILD_CHUNK = 64


def _check_policies(write_policy: str, read_policy: str) -> None:
    if write_policy not in WRITE_POLICIES:
        raise ValueError(f"unknown write_policy {write_policy!r} "
                         f"(expected one of {WRITE_POLICIES})")
    if read_policy not in READ_POLICIES:
        raise ValueError(f"unknown read_policy {read_policy!r} "
                         f"(expected one of {READ_POLICIES})")


def _transport_opts(opts: Optional[Dict[str, Any]], i: int) -> Dict[str, Any]:
    """Per-replica view of the transport options: a list/tuple value is
    indexed per replica (``latency=[1, 1, 6]``: a straggler link), a scalar
    is shared. A scalar ``seed`` becomes ``seed + i`` so replicas do not
    drop or reorder in lock step; a seed list is taken as it is."""
    opts = opts or {}
    out = {k: (v[i] if isinstance(v, (list, tuple)) else v)
           for k, v in opts.items()}
    if isinstance(opts.get("seed"), int):
        out["seed"] += i
    return out


class _Waiter:
    """Controller-side plumbing: ``_await`` ticks the undelivered futures'
    transports until ``need`` of them completed (all by default; the loop
    body never runs in-process) and counts the ticks in ``wait_ticks``, the
    controller's wait in simulated time that the policies trade.
    ``_delta_rebuild`` is the rebuild wire sequence: target WATERMARKS ->
    donor FETCH_DELTA -> FETCH_PAGES/PUSH_PAGES chunks (``pages_moved``
    counts their rows) -> ADOPT_META."""

    wait_ticks: int = 0
    null_storage: bool = False

    def _await(self, futs: Sequence[MsgFuture],
               need: Optional[int] = None) -> None:
        need = len(futs) if need is None else need
        for _ in range(ReplicaTransport.MAX_WAIT_TICKS):
            if sum(f.done for f in futs) >= need:
                return
            for f in futs:
                if not f.done:
                    f.transport.tick()
            self.wait_ticks += 1
        raise RuntimeError("replica transports livelocked "
                           f"({sum(f.done for f in futs)}/{need} delivered)")

    def _delta_rebuild(self, donor_t, tgt_t, device) -> None:
        wm = tgt_t.call(WireMsg(op=MSG_WATERMARKS))
        ext_ids, meta = donor_t.call(WireMsg(op=MSG_FETCH_DELTA, meta=wm))
        if not self.null_storage and len(ext_ids):
            # the extent ids cross to the device once; chunks are slices
            self._stream_rows(donor_t, tgt_t, torch.from_numpy(
                ext_ids.astype(np.int64)).to(device))
        tgt_t.call(WireMsg(op=MSG_ADOPT_META, meta=meta))

    @staticmethod
    def _stream_rows(donor_t, tgt_t, ext: torch.Tensor) -> None:
        """FETCH_PAGES/PUSH_PAGES the pool rows ``ext`` (int64, on the
        device) from donor to target in ``REBUILD_CHUNK``-row messages."""
        for lo in range(0, len(ext), REBUILD_CHUNK):
            chunk = ext[lo:lo + REBUILD_CHUNK]
            rows = donor_t.call(WireMsg(op=MSG_FETCH_PAGES, extents=chunk))
            tgt_t.call(WireMsg(op=MSG_PUSH_PAGES, extents=chunk,
                               payload=rows))


class ReplicaGroup(_Waiter):
    """The controller's backend: mirrors control and data ops across
    replica transports under the configured write/read policies, and hands
    the fused step every healthy replica's state, pool and watermarks."""

    def __init__(self, n_replicas: int, n_extents: int, max_volumes: int,
                 max_pages: int, page_blocks: int, payload_shape=(4,),
                 null_storage: bool = False, transport: str = "local",
                 write_policy: str = "all", read_policy: str = "rr",
                 transport_opts: Optional[Dict[str, Any]] = None, *,
                 device):
        _check_policies(write_policy, read_policy)
        self.null_storage = null_storage
        self.page_blocks = page_blocks
        self.write_policy = write_policy
        self.read_policy = read_policy
        self.transport_name = transport
        self.device = torch.device(device)
        # pools carry ONE extra extent row past the allocator's range: the
        # dump row that the write kernel parks inert lanes on.
        # dbs.make_state only ever hands out extents < n_extents.
        self.replicas: List[Replica] = [
            Replica(state=dbs.make_state(n_extents, max_volumes, max_pages,
                                         device=device),
                    pool=torch.zeros((n_extents + 1, page_blocks)
                                     + tuple(payload_shape),
                                     dtype=torch.float32, device=device),
                    page_rev=torch.zeros((max_volumes, max_pages),
                                         dtype=torch.int32, device=device),
                    null_storage=null_storage)
            for _ in range(n_replicas)]
        self.transports = [
            make_transport(transport, r, **_transport_opts(transport_opts, i))
            for i, r in enumerate(self.replicas)]
        self._rr = 0

    # -- control plane: mirrored to every healthy replica ---------------------
    def _mirror_ctl(self, op: int, **kw) -> Any:
        """Post one control message to every healthy replica and wait for
        all acks (control ops always fence: a snapshot acked by some
        replicas only would diverge the mirror). Returns the first reply
        value (mirrored ops agree)."""
        msg = WireMsg(op=op, **kw)
        futs = [t.post(msg) for t, r in zip(self.transports, self.replicas)
                if r.healthy]
        self._await(futs)
        return next((f.value for f in futs if f.value is not None), None)

    def create_volume(self) -> int:
        return int(self._mirror_ctl(MSG_CREATE))

    def snapshot(self, vol: int) -> int:
        return int(self._mirror_ctl(MSG_SNAPSHOT, volume=vol))

    def clone(self, vol: int) -> int:
        return int(self._mirror_ctl(MSG_CLONE, volume=vol))

    def unmap(self, vol: int, pages) -> None:
        dev = self.replicas[0].pool.device
        self._mirror_ctl(MSG_UNMAP, volume=vol, pages=torch.as_tensor(
            list(pages), dtype=torch.int64).to(dev))

    def delete_volume(self, vol: int) -> None:
        self._mirror_ctl(MSG_DELETE, volume=vol)

    # -- fused data plane (core/fused.py) ------------------------------------
    def healthy_indices(self) -> List[int]:
        return [i for i, r in enumerate(self.replicas) if r.healthy]

    def device_state(self):
        """(states, pools) tuples for every healthy replica — what the fused
        step threads through; nothing is fetched. With ``null_storage`` the
        pools are withheld (the step never touches them)."""
        idx = self.healthy_indices()
        states = tuple(self.replicas[i].state for i in idx)
        if self.null_storage:
            return states, ()
        return states, tuple(self.replicas[i].pool for i in idx)

    def set_device_state(self, states, pools) -> None:
        """Write back the fused step's outputs (healthy replicas, in the
        order ``device_state`` returned them)."""
        idx = self.healthy_indices()
        for i, st in zip(idx, states):
            self.replicas[i].state = st
        for i, pool in zip(idx, pools):
            self.replicas[i].pool = pool

    def device_page_revs(self):
        """Per-replica last-write watermark tensors, ``device_state``
        order (none with ``null_storage``: nothing to delta-rebuild)."""
        if self.null_storage:
            return ()
        return tuple(self.replicas[i].page_rev
                     for i in self.healthy_indices())

    def set_device_page_revs(self, page_revs) -> None:
        for i, pr in zip(self.healthy_indices(), page_revs):
            self.replicas[i].page_rev = pr

    def bump_rr(self) -> int:
        """Advance and return the round-robin read cursor (a host int, so
        the step picks its replica by plain indexing)."""
        rr = self._rr
        self._rr += 1
        return rr

    # -- host-dispatched data plane (the loop/slots backends) ---------------
    def write(self, vol, pages: torch.Tensor, block_offsets: torch.Tensor,
              payload: torch.Tensor, mask=None) -> None:
        """Mirror a batch of block writes to every healthy replica, then
        complete per the write policy: ``all`` waits for every ack,
        ``quorum`` for a majority (the rest deliver on later ticks; per-link
        FIFO keeps each replica's history in order), ``async`` for none.
        vol: scalar or (B,) volume ids; tensors on the replicas' device.
        The message's tensors must not change after the call."""
        bits = torch.ones((), dtype=torch.int64, device=self.device) << \
            block_offsets.long()
        if mask is None:
            mask = torch.ones(pages.shape, dtype=torch.bool,
                              device=self.device)
        msg = WireMsg(op=MSG_WRITE, volume=vol, pages=pages,
                      blocks=block_offsets, bits=bits, payload=payload,
                      mask=mask)
        futs = [t.post(msg) for t, r in zip(self.transports, self.replicas)
                if r.healthy]
        if self.write_policy == "all":
            self._await(futs)
        elif self.write_policy == "quorum":
            self._await(futs, need=len(futs) // 2 + 1)
        # "async": acked at post time; deliveries land on later ticks

    def _pick_replica(self) -> int:
        """Read-policy replica selection over the healthy set. ``rr``: the
        cursor advances once per read, and a failed replica's turn passes
        to the next healthy one. ``latency``: the lowest observed link
        latency, then queue depth, then the rr cursor."""
        n = len(self.replicas)
        if self.read_policy == "latency":
            rr = self._rr
            self._rr += 1
            healthy = self.healthy_indices()
            if not healthy:
                raise RuntimeError("no healthy replica")
            return min(healthy, key=lambda i: (
                self.transports[i].latency_ewma,
                self.transports[i].pending(), (i - rr) % n))
        order = [(self._rr + i) % n for i in range(n)]
        self._rr += 1
        for i in order:
            if self.replicas[i].healthy:
                return i
        raise RuntimeError("no healthy replica")

    def read(self, vol, pages: torch.Tensor,
             block_offsets: torch.Tensor) -> torch.Tensor:
        """Read one block per lane from the replica the read policy picks:
        (B, *payload) on the device, holes as zeros. vol: scalar or (B,).
        The read rides behind that link's in-flight writes (FIFO). With
        ``null_storage`` no replica serves and the cursor stays put."""
        if self.null_storage:
            for r in self.replicas:
                if r.healthy:
                    return torch.zeros((pages.shape[0],) + r.pool.shape[2:],
                                       dtype=r.pool.dtype, device=self.device)
            raise RuntimeError("no healthy replica")
        i = self._pick_replica()
        fut = self.transports[i].post(WireMsg(
            op=MSG_READ, volume=vol, pages=pages, blocks=block_offsets))
        self._await([fut])
        return fut.value

    def drain_transports(self) -> None:
        """Deliver everything still in flight on every link (write-behind
        and quorum stragglers)."""
        for t in self.transports:
            t.drain()

    # -- fault handling ------------------------------------------------------
    def _check_index(self, idx: int) -> None:
        if not 0 <= idx < len(self.replicas):
            raise IndexError(f"replica index {idx} out of range "
                             f"[0, {len(self.replicas)})")

    def fail(self, idx: int) -> None:
        """Mark a replica faulty and tear down its link. The controller
        never declares the LAST healthy replica dead (volume loss)."""
        self._check_index(idx)
        survivors = [r for i, r in enumerate(self.replicas)
                     if r.healthy and i != idx]
        if self.replicas[idx].healthy and not survivors:
            raise RuntimeError(f"replica {idx} is the last healthy replica; "
                               "failing it would lose the volume")
        self.replicas[idx].healthy = False
        self.transports[idx].cancel_pending()

    def consistent(self) -> bool:
        """Healthy replicas agree on the metadata revision. The queries
        ride the links (behind in-flight writes) and the revisions come
        back in ONE host fetch."""
        futs = [t.post(WireMsg(op=MSG_QUERY_REV))
                for t, r in zip(self.transports, self.replicas) if r.healthy]
        self._await(futs)
        revs = torch.stack([f.value for f in futs]).tolist()
        return len(set(revs)) == 1

    def rebuild(self, idx: int) -> None:
        """Restore a failed replica by streaming the delta from the most
        up-to-date healthy copy (``_delta_rebuild``): only the pool rows of
        pages written since the target failed cross, then the donor's
        metadata is adopted. Rebuilding a healthy replica, or one that does
        not exist, is an error."""
        self._check_index(idx)
        tgt = self.replicas[idx]
        if tgt.healthy:
            raise ValueError(f"replica {idx} is healthy; only a failed "
                             "replica can be rebuilt")
        donors = self.healthy_indices()
        if not donors:
            raise RuntimeError("no healthy replica to rebuild from")
        self._delta_rebuild(self.transports[self._donor(donors)],
                            self.transports[idx], self.device)
        tgt.healthy = True

    def _donor(self, candidates: Sequence[int]) -> int:
        """The candidate replica with the highest metadata revision (the
        revisions come back in one host fetch)."""
        futs = [self.transports[i].post(WireMsg(op=MSG_QUERY_REV))
                for i in candidates]
        self._await(futs)
        revs = torch.stack([f.value for f in futs]).tolist()
        return candidates[int(np.argmax(revs))]

    def resync_rows(self, idx: int, extents: torch.Tensor) -> None:
        """Stream the pool rows ``extents`` (int64, on the device) to the
        healthy replica ``idx`` from the other healthy replica with the
        highest revision. For data written into the pools behind the
        controller's back, which no watermark records (the serving decode
        program's in-place K/V scatter): a delta rebuild cannot see it."""
        self._check_index(idx)
        donors = [i for i in self.healthy_indices() if i != idx]
        if not self.replicas[idx].healthy or not donors:
            raise ValueError(f"replica {idx} must be healthy with a healthy "
                             "peer to resync from")
        if self.null_storage or not len(extents):
            return
        self._stream_rows(self.transports[self._donor(donors)],
                          self.transports[idx], extents)
