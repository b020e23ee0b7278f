"""EnginePool: S engine shards served by one sharded step a pump, pipelined.

Port of ``repro/core/sharded.py``. S independent engine shards — each its
own slot table, R mirrored replica DBS states, payload pools and
round-robin cursor — are stacked along a leading (S,) axis
(``slots.make_sharded_table``, ``replication.ShardedReplicaGroup``).
Volume ``gid`` lives on shard ``gid % S`` as the shard-local id
``gid // S``.

- **One step a pump for every shard.** The reference vmaps its fused step
  into one compiled program. Here the metadata half (admission, each
  replica's ``write_pages`` and watermark stamp: ``fused.step_meta``; the
  read routes: ``fused.read_routes``) runs under ``torch.func.vmap`` over
  the shard axis (``ring.vmap_shards``; at S=1 unmapped, as the
  reference), and the DBS kernels run outside the map on each replica's
  flattened ``(S*(E+1), page, *payload)`` pool: one write launch a replica
  and one routed read launch a replica, over S*B lanes. So the ops a pump
  dispatches and the kernels it launches do not grow with S
  (``step_counts``, ``kernel_calls`` and ``dispatches`` count them; the
  reference's ``trace_counts`` counts compiled programs, which eager
  PyTorch does not have).
- **Health is a tensor.** A failed replica is an (S, R) mask the step
  takes, not a change of the replica tuple: its slice takes no writes and
  serves no reads until ``backend.rebuild(shard, replica)``.
- **Pipelined pump.** ``pump_async`` launches a pump and returns without
  waiting: the completion flags and read payloads go to pinned host
  buffers without blocking, and a CUDA event marks their arrival.
  ``drain`` launches pump N+1 before it waits on pump N's event, so the
  host's drain and staging of N+1 overlap N on the card. Requests that N
  did not admit surface at N's completion and ride pump N+2. Each pump's
  reads are gathered into a fresh tensor before the next pump's in-place
  write is queued on the same stream, so a read never sees a later write.

``EngineConfig(comm="sharded", n_shards=S)`` (``backend="sharded"``)
routes ``Engine`` and ``VolumeManager`` through a pool. The submission
path carries data ops; control ops run on the host between pumps
(``control()``).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional

import torch

from repro_torch.core import slots
from repro_torch.core.control import ControlDispatch
from repro_torch.core.frontend import Request, ShardedFrontend
from repro_torch.core.fused import FusedBatch, read_routes, step_meta
from repro_torch.core.replication import ShardedReplicaGroup
from repro_torch.core.ring import routed_read, vmap_shards
from repro_torch.kernels.dbs.registry import make_kernel, resolve_kernel_name


def _routes(states, batch: FusedBatch, ok, rr, healthy, null_backend,
            null_storage):
    if null_backend or null_storage or not states:
        return ()
    return read_routes(states, batch, rr, ok & ~batch.is_write, healthy)


def _shard_step(table, states, page_revs, batch: FusedBatch, rr, healthy, *,
                null_backend: bool, null_storage: bool):
    """One shard's metadata step: ``fused.step_meta`` under the (R,) health
    mask, then the read routes of its read lanes. Returns ``(table',
    states', page_revs', ok, write ops, read routes)``, per replica."""
    table, states, page_revs, ok, ops = step_meta(
        table, states, page_revs, batch, healthy, null_backend=null_backend,
        null_storage=null_storage)
    return table, states, page_revs, ok, ops, _routes(
        states, batch, ok, rr, healthy, null_backend, null_storage)


def _shard_step_read(table, states, batch: FusedBatch, rr, healthy, *,
                     null_backend: bool, null_storage: bool):
    """``_shard_step`` for a batch with no write lane: admission and the
    read routes (the replica states are inputs only)."""
    table, _ids, ok = slots.transact(table, batch.want, batch.volume,
                                     batch.queue, batch.step)
    return table, ok, _routes(states, batch, ok, rr, healthy, null_backend,
                              null_storage)


@dataclass
class PendingPump:
    """Completion handle of ``pump_async``: the request lists that rode
    the pump and its completion flags and read payloads, in host memory
    once ``event`` (None off the card) has passed."""
    reqs: List[List[Request]]      # per shard, aligned with batch lanes
    ok: torch.Tensor               # (S, B) bool, host
    reads: torch.Tensor            # (S, B, *payload), host
    event: Optional[torch.cuda.Event] = None


class EnginePool(ControlDispatch):
    """S engine shards behind one sharded step a pump, registered as
    ``backend="sharded"``: ``create_volume``/``snapshot``/``clone``/
    ``unmap``/``delete_volume`` on global volume ids, ``submit``,
    ``pump``/``pump_async``/``drain``, and per-shard failover through
    ``backend.fail(shard, replica)``/``backend.rebuild(shard, replica)`` or
    ``control("fail"|"rebuild", shard=, replica=)``."""

    is_pool = True
    data_kinds = frozenset({"read", "write"})

    def __init__(self, cfg):
        self.cfg = cfg
        s = cfg.n_shards
        if s < 1:
            raise ValueError(f"n_shards must be >= 1, got {s}")
        if cfg.storage != "dbs":
            raise ValueError("backend='sharded' requires storage='dbs'")
        self.n_shards = s
        self.device = torch.device(cfg.device)
        self.frontend = ShardedFrontend(s, cfg.n_queues, cfg.n_slots,
                                        cfg.batch, device=self.device)
        self.backend = None if cfg.null_backend else ShardedReplicaGroup(
            s, cfg.n_replicas, cfg.n_extents, cfg.max_volumes, cfg.max_pages,
            cfg.page_blocks, cfg.payload_shape,
            null_storage=cfg.null_storage, transport=cfg.transport,
            write_policy=cfg.write_policy, read_policy=cfg.read_policy,
            transport_opts=cfg.transport_opts, device=self.device)
        self._kernel = resolve_kernel_name(cfg)
        self._kern = make_kernel(self._kernel)
        cuts = dict(null_backend=cfg.null_backend,
                    null_storage=cfg.null_storage)
        self._meta = vmap_shards(partial(_shard_step, **cuts), s)
        self._meta_read = vmap_shards(partial(_shard_step_read, **cuts), s)
        # the null backend's stand-ins for the health mask and the cursors
        self._no_health = torch.ones((s, 1), dtype=torch.bool,
                                     device=self.device)
        self._no_rr = torch.zeros((s,), dtype=torch.int32, device=self.device)
        self._vol_rr = 0
        self.completed = 0
        self.dispatches = 0
        self.step_counts = {"step": 0, "step_read": 0}
        self.kernel_calls = {"write": 0, "read": 0}

    # ------------------------------------------------------------ volumes
    def create_volume(self) -> int:
        """Create a volume on the next shard (round robin). Returns its
        global id ``local * S + shard``."""
        shard = self._vol_rr % self.n_shards
        self._vol_rr += 1
        local = 0 if self.backend is None else self.backend.create_volume(
            shard)
        return local * self.n_shards + shard

    def snapshot(self, vol: int):
        """Freeze the volume head; the shard-local snapshot id (-1 on
        failure), None under ``null_backend``."""
        if self.backend is None:
            return None
        return self.backend.snapshot(vol % self.n_shards,
                                     vol // self.n_shards)

    def clone(self, vol: int) -> int:
        """Fork a volume on its shard; the new global id, -1 on failure."""
        if self.backend is None:
            return -1
        shard = vol % self.n_shards
        local = self.backend.clone(shard, vol // self.n_shards)
        return local * self.n_shards + shard if local >= 0 else -1

    def unmap(self, vol: int, pages) -> None:
        if self.backend is not None:
            self.backend.unmap(vol % self.n_shards, vol // self.n_shards,
                               pages)

    def delete_volume(self, vol: int) -> None:
        if self.backend is not None:
            self.backend.delete_volume(vol % self.n_shards,
                                       vol // self.n_shards)

    def read_volume(self, vol: int, pages: torch.Tensor,
                    block_offsets: torch.Tensor) -> torch.Tensor:
        """Host read path for verification (the pump reads in the step)."""
        if self.backend is None:
            raise RuntimeError("null backend holds no volumes")
        return self.backend.read(vol % self.n_shards, vol // self.n_shards,
                                 pages, block_offsets)

    # -------------------------------------------------- backend protocol
    @property
    def storage(self):
        return self.backend

    def _control_repl(self, kind, shard, replica):
        if self.backend is None:
            raise RuntimeError("null backend holds no replicas")
        if shard is None:
            raise ValueError(f"{kind!r} on backend='sharded' needs shard=")
        fn = self.backend.fail if kind == "fail" else self.backend.rebuild
        return fn(shard, replica)

    def depth(self) -> int:
        return self.frontend.depth()

    def submit(self, req: Request) -> None:
        if req.kind not in self.data_kinds:
            raise ValueError(
                f"kind={req.kind!r} requests need backend='ring' (the "
                "opcode-tagged SQ/CQ path); this backend carries data ops "
                "only — use control() for host-side control ops")
        # out-of-range ids would index past the device tables (JAX clamps
        # or drops them; a CUDA gather faults)
        cfg = self.cfg
        if not (req.volume >= 0
                and req.volume // self.n_shards < cfg.max_volumes
                and 0 <= req.page < cfg.max_pages
                and 0 <= req.block < cfg.page_blocks):
            raise ValueError(
                f"request out of range: volume {req.volume} (of "
                f"{cfg.max_volumes} a shard, {self.n_shards} shards), page "
                f"{req.page} (of {cfg.max_pages}), block {req.block} (of "
                f"{cfg.page_blocks})")
        self.frontend.submit(req)

    # ------------------------------------------------------------- pumping
    def pump_async(self) -> Optional[PendingPump]:
        """Admit one batch a shard and launch the pump; do NOT wait for it.
        Returns a ``PendingPump`` (None when no shard had traffic)."""
        reqs, batch = self.frontend.drain_sharded(self.cfg.payload_shape)
        if batch is None:
            return None
        if self.backend is None:
            states, pools, page_revs = (), (), ()
            healthy, rr = self._no_health, self._no_rr
        else:
            states, pools, healthy = self.backend.device_state()
            page_revs = self.backend.device_page_revs()
            rr = self.backend.bump_rr()
        self.dispatches += 1
        if any(r.kind == "write" for rs in reqs for r in rs):
            self.step_counts["step"] += 1
            table, states, page_revs, ok, ops, routes = self._meta(
                self.frontend.table, states, page_revs, batch, rr, healthy)
            for pool, wops in zip(pools, ops):     # in place, every replica
                self._kern.write_stacked(pool, wops, batch.payload,
                                         batch.block)
                self.kernel_calls["write"] += 1
            if self.backend is not None:
                self.backend.set_device_state(states, pools)
                self.backend.set_device_page_revs(page_revs)
        else:
            # read-only batch: the replica states are inputs only
            self.step_counts["step_read"] += 1
            table, ok, routes = self._meta_read(
                self.frontend.table, states, batch, rr, healthy)
        reads = routed_read(self._kern, pools, routes, batch.block,
                            batch.payload)
        self.kernel_calls["read"] += len(routes)
        self.frontend.table = table
        if self.device.type != "cuda":
            return PendingPump(reqs=reqs, ok=ok, reads=reads)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in (ok, reads)]
        for h, t in zip(host, (ok, reads)):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return PendingPump(reqs=reqs, ok=host[0], reads=host[1], event=event)

    def _complete(self, p: PendingPump) -> int:
        """The pump's one wait: deliver results, requeue the requests it
        did not admit."""
        if p.event is not None:
            p.event.synchronize()
        ok, reads = p.ok.numpy(), p.reads.numpy()
        done = 0
        requeues = []
        for s, shard_reqs in enumerate(p.reqs):
            for i, r in enumerate(shard_reqs):
                if ok[s, i]:
                    r.status = 0
                    if r.kind == "read":
                        r.result = reads[s, i]
                    done += 1
                else:
                    requeues.append(r)
        self.frontend.ring.requeue_all(requeues)
        self.completed += done
        return done

    def pump(self) -> int:
        """One synchronous pool iteration (launch, then complete)."""
        p = self.pump_async()
        return self._complete(p) if p is not None else 0

    def drain(self, max_iters: int = 100_000) -> int:
        """Pipelined drain: launch pump N+1, then wait on pump N."""
        total = 0
        pending: Optional[PendingPump] = None
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
