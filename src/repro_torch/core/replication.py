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
``slots``) post WRITE and READ messages, where the policies bite.

``ShardedReplicaGroup`` stacks S such groups along a leading shard axis
for the sharded pool (core/sharded.py): R ``StackedReplica`` endpoints, a
dense (S, R) health mask, and per-shard fail/rebuild (the same streamed
delta, addressed to one shard's slice).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.core import dbs
from repro_torch.core.transport import (MSG_ADOPT_META, MSG_CLONE,
                                        MSG_CREATE, MSG_DELETE,
                                        MSG_FETCH_DELTA, MSG_FETCH_PAGES,
                                        MSG_PUSH_PAGES, MSG_QUERY_REV,
                                        MSG_READ, MSG_SNAPSHOT, MSG_UNMAP,
                                        MSG_WATERMARKS, MSG_WRITE, MsgFuture,
                                        Replica, ReplicaTransport,
                                        StackedReplica, WireMsg,
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

    def _delta_rebuild(self, donor_t, tgt_t, device,
                       shard: Optional[int] = None) -> None:
        """The wire sequence, addressed to ``shard``'s slice on stacked
        endpoints (None on flat ones)."""
        wm = tgt_t.call(WireMsg(op=MSG_WATERMARKS, shard=shard))
        ext_ids, meta = donor_t.call(WireMsg(op=MSG_FETCH_DELTA, meta=wm,
                                             shard=shard))
        if not self.null_storage and len(ext_ids):
            # the extent ids cross to the device once; chunks are slices
            self._stream_rows(donor_t, tgt_t, torch.from_numpy(
                ext_ids.astype(np.int64)).to(device), shard)
        tgt_t.call(WireMsg(op=MSG_ADOPT_META, meta=meta, shard=shard))

    @staticmethod
    def _stream_rows(donor_t, tgt_t, ext: torch.Tensor,
                     shard: Optional[int] = None) -> None:
        """FETCH_PAGES/PUSH_PAGES the pool rows ``ext`` (int64, on the
        device) from donor to target in ``REBUILD_CHUNK``-row messages."""
        for lo in range(0, len(ext), REBUILD_CHUNK):
            chunk = ext[lo:lo + REBUILD_CHUNK]
            rows = donor_t.call(WireMsg(op=MSG_FETCH_PAGES, extents=chunk,
                                        shard=shard))
            tgt_t.call(WireMsg(op=MSG_PUSH_PAGES, extents=chunk,
                               payload=rows, shard=shard))


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


# ---------------------------------------------------------------------------
# the shard-stacked group (the sharded pool's storage, core/sharded.py)
# ---------------------------------------------------------------------------
class ShardedReplicaGroup(_Waiter):
    """S independent replica groups stacked along a leading shard axis.

    Each of the R replicas is ONE ``StackedReplica`` endpoint whose leaves
    carry a leading (S,) axis (shard s's replica r is ``states[r]`` at
    ``[s]``), so the sharded step serves every shard's mirrored writes and
    round-robin reads at once; the transports carry control and rebuild
    traffic, and the data plane is ``all``/``rr`` by construction. Health
    is a dense (S, R) mask that the step takes as a tensor (a failed
    replica's slice takes no writes and serves no reads until ``rebuild``);
    its device copy is cached until ``fail``/``rebuild`` change it. The
    round-robin cursors are an (S,) device tensor moved on by a device add:
    the pump reads neither back."""

    def __init__(self, n_shards: int, n_replicas: int, n_extents: int,
                 max_volumes: int, max_pages: int, page_blocks: int,
                 payload_shape=(4,), null_storage: bool = False,
                 transport: str = "device", write_policy: str = "all",
                 read_policy: str = "rr",
                 transport_opts: Optional[Dict[str, Any]] = None, *,
                 device):
        _check_policies(write_policy, read_policy)   # unknown names first
        if write_policy != "all" or read_policy != "rr":
            raise ValueError(
                "the sharded data plane mirrors writes and round-robins "
                "reads IN-PROGRAM (inside the sharded step); write_policy="
                f"{write_policy!r}/read_policy={read_policy!r} need a "
                "host-dispatch backend (loop | slots)")
        self.n_shards = n_shards
        self.n_replicas = n_replicas
        self.null_storage = null_storage
        self.page_blocks = page_blocks
        self.device = torch.device(device)
        # "local" names the in-process call; on stacked endpoints that IS
        # the device transport
        self.transport_name = "device" if transport == "local" else transport

        def stack(x):
            return x[None].repeat((n_shards,) + (1,) * x.dim())
        # one extra extent row per shard's pool: the dump row
        endpoints = [
            StackedReplica(
                state=pytree.tree_map(stack, dbs.make_state(
                    n_extents, max_volumes, max_pages, device=device)),
                pool=torch.zeros((n_shards, n_extents + 1, page_blocks)
                                 + tuple(payload_shape),
                                 dtype=torch.float32, device=device),
                page_rev=torch.zeros((n_shards, max_volumes, max_pages),
                                     dtype=torch.int32, device=device),
                null_storage=null_storage)
            for _ in range(n_replicas)]
        self.transports = [
            make_transport(self.transport_name, ep,
                           **_transport_opts(transport_opts, i))
            for i, ep in enumerate(endpoints)]
        self._healthy_np = np.ones((n_shards, n_replicas), bool)
        self._healthy_dev: Optional[torch.Tensor] = None   # device cache
        self._healthy_stale = False   # device mask newer than the mirror
        self._rr = torch.zeros((n_shards,), dtype=torch.int32, device=device)

    # -- the stacked endpoint tensors ----------------------------------------
    @property
    def states(self) -> List[dbs.DBSState]:
        return [t.endpoint.state for t in self.transports]

    @property
    def pools(self) -> List[torch.Tensor]:
        return [t.endpoint.pool for t in self.transports]

    @property
    def healthy(self) -> np.ndarray:
        """The host's (S, R) health mirror; after ``adopt_health`` the
        device mask is newer and the mirror is fetched here, on the control
        path, never on the pump's."""
        if self._healthy_stale:
            self._healthy_np = self._healthy_dev.cpu().numpy().copy()
            self._healthy_stale = False
        return self._healthy_np

    def adopt_health(self, mask: torch.Tensor) -> None:
        """Adopt a health mask computed on the device (the ring's in-band
        fail/rebuild, core/ring.py)."""
        self._healthy_dev = mask
        self._healthy_stale = True

    # -- control plane: one shard's slice, on every replica ------------------
    def _mirror_ctl(self, shard: int, op: int, **kw) -> Any:
        """Post one shard-addressed control message to EVERY replica,
        healthy or not: all R slices stay in lock step, so a rebuild adopts
        the donor's metadata without replaying control ops. Returns
        replica 0's reply."""
        msg = WireMsg(op=op, shard=shard, **kw)
        futs = [t.post(msg) for t in self.transports]
        self._await(futs)
        return futs[0].value

    def create_volume(self, shard: int) -> int:
        return int(self._mirror_ctl(shard, MSG_CREATE))

    def snapshot(self, shard: int, vol: int) -> int:
        return int(self._mirror_ctl(shard, MSG_SNAPSHOT, volume=vol))

    def clone(self, shard: int, vol: int) -> int:
        return int(self._mirror_ctl(shard, MSG_CLONE, volume=vol))

    def unmap(self, shard: int, vol: int, pages) -> None:
        self._mirror_ctl(shard, MSG_UNMAP, volume=vol, pages=torch.as_tensor(
            list(pages), dtype=torch.int64).to(self.device))

    def delete_volume(self, shard: int, vol: int) -> None:
        self._mirror_ctl(shard, MSG_DELETE, volume=vol)

    # -- the sharded step's data plane ---------------------------------------
    def device_state(self):
        """(states, pools, healthy): R stacked states, R stacked pools (none
        with ``null_storage``) and the cached (S, R) device mask."""
        pools = () if self.null_storage else tuple(self.pools)
        if self._healthy_dev is None:      # a copy: the mirror changes
            self._healthy_dev = torch.tensor(self.healthy,
                                             device=self.device)
        return tuple(self.states), pools, self._healthy_dev

    def set_device_state(self, states, pools) -> None:
        for t, st in zip(self.transports, states):
            t.endpoint.state = st
        for t, p in zip(self.transports, pools):
            t.endpoint.pool = p

    def device_page_revs(self):
        """Per-replica stacked (S, V, P) watermarks (none with
        ``null_storage``)."""
        if self.null_storage:
            return ()
        return tuple(t.endpoint.page_rev for t in self.transports)

    def set_device_page_revs(self, page_revs) -> None:
        for t, pr in zip(self.transports, page_revs):
            t.endpoint.page_rev = pr

    def bump_rr(self) -> torch.Tensor:
        """Return the (S,) read cursors and move them on (a device add)."""
        rr = self._rr
        self._rr = rr + 1
        return rr

    # -- host read path (verification and tooling) ---------------------------
    def read(self, shard: int, vol: int, pages: torch.Tensor,
             block_offsets: torch.Tensor) -> torch.Tensor:
        """One block per lane from the first healthy replica of ``shard``
        (holes zero); the pump serves reads in the step."""
        for r in range(self.n_replicas):
            if not self.healthy[shard, r]:
                continue
            if self.null_storage:
                pool = self.pools[r]
                return torch.zeros((pages.shape[0],) + tuple(pool.shape[3:]),
                                   dtype=pool.dtype, device=self.device)
            fut = self.transports[r].post(WireMsg(
                op=MSG_READ, shard=shard, volume=vol, pages=pages,
                blocks=block_offsets))
            self._await([fut])
            return fut.value
        raise RuntimeError(f"no healthy replica in shard {shard}")

    def drain_transports(self) -> None:
        for t in self.transports:
            t.drain()

    # -- fault handling, one shard at a time ---------------------------------
    def _check(self, shard: int, replica: int) -> None:
        if not 0 <= shard < self.n_shards:
            raise IndexError(f"shard index {shard} out of range "
                             f"[0, {self.n_shards})")
        if not 0 <= replica < self.n_replicas:
            raise IndexError(f"replica index {replica} out of range "
                             f"[0, {self.n_replicas})")

    def fail(self, shard: int, replica: int) -> None:
        """Mark one shard's replica faulty. The shard's last healthy
        replica is never failed: an all-failed shard would drop writes and
        read zeros while its lanes still complete."""
        self._check(shard, replica)
        if self.healthy[shard, replica] and self.healthy[shard].sum() == 1:
            raise RuntimeError(
                f"replica {replica} is shard {shard}'s last healthy "
                "replica; failing it would lose the shard's volumes")
        self.healthy[shard, replica] = False
        self._healthy_dev = None

    def _donor(self, shard: int, candidates: Sequence[int]) -> int:
        """The candidate with the highest revision on ``shard`` (each
        replica's (S,) revisions, fetched in one host copy)."""
        futs = [self.transports[r].post(WireMsg(op=MSG_QUERY_REV))
                for r in candidates]
        self._await(futs)
        revs = torch.stack([f.value for f in futs]).cpu().numpy()
        return candidates[int(np.argmax(revs[:, shard]))]

    def rebuild(self, shard: int, replica: int) -> None:
        """Restore ``shard``'s slice of ``replica`` from the shard's most
        up-to-date healthy copy: the streamed delta of
        ``ReplicaGroup.rebuild``, addressed to that slice alone."""
        self._check(shard, replica)
        if self.healthy[shard, replica]:
            raise ValueError(f"shard {shard} replica {replica} is healthy; "
                             "only a failed replica can be rebuilt")
        donors = [r for r in range(self.n_replicas)
                  if self.healthy[shard, r]]
        if not donors:
            raise RuntimeError(f"no healthy replica in shard {shard} to "
                               "rebuild from")
        self._delta_rebuild(self.transports[self._donor(shard, donors)],
                            self.transports[replica], self.device,
                            shard=shard)
        self.healthy[shard, replica] = True
        self._healthy_dev = None

    def resync_rows(self, shard: int, replica: int,
                    extents: torch.Tensor) -> None:
        """Stream ``shard``'s pool rows ``extents`` (shard-local, int64, on
        the device) to its healthy ``replica`` from the shard's other
        healthy replica with the highest revision: ``ReplicaGroup.
        resync_rows`` on one shard's slice."""
        self._check(shard, replica)
        donors = [r for r in range(self.n_replicas)
                  if self.healthy[shard, r] and r != replica]
        if not self.healthy[shard, replica] or not donors:
            raise ValueError(f"shard {shard} replica {replica} must be "
                             "healthy with a healthy peer to resync from")
        if self.null_storage or not len(extents):
            return
        self._stream_rows(self.transports[self._donor(shard, donors)],
                          self.transports[replica], extents, shard)

    def consistent(self, shard: Optional[int] = None) -> bool:
        """The healthy replicas of ``shard`` (of every shard by default)
        agree on the metadata revision; every replica's (S,) revisions come
        back in one host copy."""
        futs = [t.post(WireMsg(op=MSG_QUERY_REV)) for t in self.transports]
        self._await(futs)
        revs = torch.stack([f.value for f in futs]).cpu().numpy()  # (R, S)
        healthy = self.healthy
        shards = range(self.n_shards) if shard is None else [shard]
        return all(len({int(revs[r, s]) for r in range(self.n_replicas)
                        if healthy[s, r]}) <= 1 for s in shards)
