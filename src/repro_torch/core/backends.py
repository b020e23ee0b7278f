"""The backend registry and the backends of the port.

Port of the registry and the backends of ``repro/core/backends.py``. A
backend is a named factory ``cfg -> Backend``; ``Engine``
(core/engine.py) and ``VolumeManager`` (core/blockdev.py) look the name up
here. The backend protocol is ``submit(req)``, ``pump()``, ``drain()``,
``control(kind, ...)``, ``create_volume()``, ``depth()``, ``completed``,
``storage``, ``frontend``, ``is_pool`` and ``data_kinds``.

| name    | class                 | submission path                        |
| ------- | --------------------- | -------------------------------------- |
| ``loop``  | ``HostDispatchBackend`` | one host dispatch per request        |
| ``slots`` | ``HostDispatchBackend`` | batched slot admission, separate     |
|           |                       | dispatches for writes, reads, retire   |
| ``fused`` | ``FusedBackend``      | one fused step per pump                |
| ``sharded`` | ``sharded.EnginePool`` | one sharded step a pump for S   |
|           |                       | stacked shards, pipelined completion   |
| ``ring``  | ``ring.RingEngine``   | one opcode-tagged step a pump for  |
|           |                       | data, compute AND control, S shards    |
| ``upstream`` | ``engine.UpstreamEngine`` | TGT-style baseline, one request |
|           |                       | per pump over chained stores           |
| ``host``  | ``HostStateBackend``  | one request per pump on one state      |

``loop`` and ``slots`` run over DBS replicas (``ReplicaGroup``, any
transport and policy) or, with ``storage="chained"``, the upstream
chained stores (``engine.ChainedReplicas``). ``null_backend`` leaves them
no storage at all (requests complete at the controller); ``null_storage``
keeps the metadata work and skips the data plane.

``host`` is the sequential oracle the byte-API tests compare engines
against (storage functions included: ``compute/exec.py host_compute``),
and the control plane of the copy-based serving baseline (``alloc_pages``
returns the DBS ``WriteOps`` for an external data plane).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dbs
from repro_torch.core.control import ControlDispatch
from repro_torch.core.frontend import MultiQueueFrontend, Request
from repro_torch.core.fused import (fused_step, fused_step_read,
                                    fused_step_read_tiered, fused_step_tiered)
from repro_torch.core.replication import ReplicaGroup
from repro_torch.kernels.dbs.registry import resolve_kernel_name

_REGISTRY: Dict[str, Callable] = {}


def register_backend(name: str, factory: Optional[Callable] = None, *,
                     override: bool = False):
    """Register ``factory(cfg) -> Backend`` under ``name``; usable directly
    or as a decorator. Duplicate names raise unless ``override=True``."""
    def _put(f):
        if name in _REGISTRY and not override:
            raise ValueError(
                f"duplicate backend {name!r} (registered: "
                f"{', '.join(available_backends())}); pass override=True "
                "to replace")
        _REGISTRY[name] = f
        return f
    if factory is None:
        return _put
    return _put(factory)


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_backend(name: str, cfg):
    """Instantiate the backend registered under ``name`` for ``cfg``."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r} (registered: "
            f"{', '.join(available_backends())})") from None
    return factory(cfg)


def fetch_to_host(*tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """Copy device tensors to host numpy in ONE synchronisation: each into
    a pinned buffer without blocking, then one stream synchronise."""
    if tensors[0].device.type != "cuda":
        return tuple(t.numpy() for t in tensors)
    outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for o, t in zip(outs, tensors):
        o.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return tuple(o.numpy() for o in outs)


class _FrontendBackendBase(ControlDispatch):
    """Shared construction for the MultiQueueFrontend-fed backends: the
    frontend, the replica storage (DBS ``ReplicaGroup``, the chained
    baseline, or None under ``null_backend``) and host-side control
    dispatch (null-backend rows answer snapshot None, clone -1)."""

    is_pool = False
    data_kinds = frozenset({"read", "write"})

    def __init__(self, cfg):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.frontend = MultiQueueFrontend(cfg.n_queues, cfg.n_slots,
                                           cfg.batch, device=self.device)
        if cfg.null_backend:
            self.storage = None
        elif cfg.storage == "chained":
            from repro_torch.core.engine import ChainedReplicas
            self.storage = ChainedReplicas(cfg)
        else:
            self.storage = ReplicaGroup(
                cfg.n_replicas, cfg.n_extents, cfg.max_volumes, cfg.max_pages,
                cfg.page_blocks, cfg.payload_shape,
                null_storage=cfg.null_storage, transport=cfg.transport,
                write_policy=cfg.write_policy, read_policy=cfg.read_policy,
                transport_opts=cfg.transport_opts, device=self.device)
        self._chained = cfg.storage == "chained"
        self._kernel = resolve_kernel_name(cfg)
        self.completed = 0

    def create_volume(self) -> int:
        if self.storage is None:
            return 0
        return self.storage.create_volume()

    def submit(self, req: Request) -> None:
        # validate BEFORE enqueue, so a mixed batch never loses its innocent
        # data requests to a drain-time error
        if req.kind not in self.data_kinds:
            raise ValueError(
                f"kind={req.kind!r} requests need backend='ring' (the "
                "opcode-tagged SQ/CQ path); this backend carries data ops "
                "only — use control() for host-side control ops")
        # out-of-range ids would index past the device tables (JAX clamps
        # or drops them silently; a CUDA gather faults). The chained stores
        # are dicts, whose volume ids grow without bound as in the reference
        cfg = self.cfg
        if not self._chained and not (
                0 <= req.volume < cfg.max_volumes
                and 0 <= req.page < cfg.max_pages
                and 0 <= req.block < cfg.page_blocks):
            raise ValueError(
                f"request out of range: volume {req.volume} (of "
                f"{cfg.max_volumes}), page {req.page} (of {cfg.max_pages}), "
                f"block {req.block} (of {cfg.page_blocks})")
        self.frontend.submit(req)

    def depth(self) -> int:
        return self.frontend.depth()

    def snapshot(self, volume: int):
        return None if self.storage is None else self.storage.snapshot(volume)

    def clone(self, volume: int) -> int:
        return -1 if self.storage is None else self.storage.clone(volume)

    def unmap(self, volume: int, pages) -> None:
        if self.storage is not None:
            self.storage.unmap(volume, pages)

    def delete_volume(self, volume: int) -> None:
        if self.storage is not None:
            self.storage.delete_volume(volume)

    def _control_repl(self, kind, shard, replica):
        if self.storage is None:
            return None
        fn = getattr(self.storage, kind, None)     # ReplicaGroup.fail/rebuild
        if fn is None:
            raise ValueError(f"storage {type(self.storage).__name__} has no "
                             f"{kind!r} control op")
        return fn(replica)

    def drain(self, max_iters: int = 100_000) -> int:
        n = 0
        for _ in range(max_iters):
            got = self.pump()
            if got == 0 and self.frontend.depth() == 0:
                break
            n += got
        return n

    def pump(self) -> int:                         # pragma: no cover
        raise NotImplementedError


@register_backend("loop")
@register_backend("slots")
class HostDispatchBackend(_FrontendBackendBase):
    """The unfused engine iteration: batched slot admission (``slots``) or
    the per-request loop (``loop``), with separate host dispatches for
    admission, writes, reads and completion — the ladder's ``+comm``/
    ``+dbs`` columns and the ``+frontend`` loop baseline. Each read
    dispatch makes one host copy of its results. Over the chained stores
    each write request is its own mirrored store write."""

    def _lanes(self, reqs: List[Request]):
        """The requests' (volume, page, block, mask) lanes padded to a
        multiple of the admission batch, moved to the device in one
        transfer."""
        n, cap = len(reqs), self.cfg.batch
        m = n + (-n) % cap
        cols = np.zeros((3, m), np.int64)
        cols[:, :n] = [[r.volume for r in reqs], [r.page for r in reqs],
                       [r.block for r in reqs]]
        vols, pages, blocks = torch.from_numpy(cols).to(self.device)
        mask = torch.arange(m, device=self.device) < n
        return vols, pages, blocks.to(torch.int32), mask

    def _exec_write_batch(self, rs: List[Request]) -> None:
        if self._chained:
            for r in rs:
                self.storage.write(r.volume, [r.page], [r.block],
                                   [r.payload])
            return
        vols, pages, blocks, mask = self._lanes(rs)
        pay = np.zeros((pages.shape[0],) + tuple(self.cfg.payload_shape),
                       np.float32)
        for i, r in enumerate(rs):
            if r.payload is not None:
                pay[i] = np.asarray(r.payload, np.float32).reshape(
                    pay.shape[1:])
        pay = torch.from_numpy(pay).to(self.device)
        cap = self.cfg.batch
        for i in range(0, pages.shape[0], cap):
            s = slice(i, i + cap)
            self.storage.write(vols[s], pages[s], blocks[s], pay[s],
                               mask=mask[s])

    def _exec_read_batch(self, rs: List[Request]) -> None:
        if self._chained:
            out = self.storage.read([r.volume for r in rs],
                                    [r.page for r in rs],
                                    [r.block for r in rs])
            if out is None:                        # null_storage
                return
            hit = [j for j, v in enumerate(out) if v is not None]
            if hit:                                # one host copy
                got, = fetch_to_host(torch.stack([out[j] for j in hit]))
                for k, j in enumerate(hit):
                    rs[j].result = got[k]
            return
        vols, pages, blocks, _mask = self._lanes(rs)
        cap = self.cfg.batch
        for i in range(0, pages.shape[0], cap):
            s = slice(i, i + cap)
            # one host copy per dispatch, host indexing after
            out, = fetch_to_host(self.storage.read(vols[s], pages[s],
                                                   blocks[s]))
            for j, r in enumerate(rs[i:i + cap]):
                r.result = out[j]

    def pump(self) -> int:
        """One controller iteration: admit a batch, execute it against the
        replicas (writes mirrored, reads round-robin), retire the slots.
        Returns the number of completed requests."""
        slot_ids, reqs = self.frontend.poll_batch()
        if not reqs:
            return 0
        if self.storage is not None:               # none: null_backend
            self._execute(reqs)
        done = self.frontend.complete(slot_ids)
        for r in done:
            r.status = 0
        self.completed += len(done)
        return len(done)

    def _execute(self, reqs: List[Request]) -> None:
        """Writes mirrored, reads from one replica: one request at a time
        on ``loop``, the batch's writes then its reads on ``slots``."""
        if self.cfg.comm == "loop":
            for r in reqs:                 # one request at a time
                if r.kind == "write":
                    self._exec_write_batch([r])
                else:
                    self._exec_read_batch([r])
        else:
            writes = [r for r in reqs if r.kind == "write"]
            reads = [r for r in reqs if r.kind == "read"]
            if writes:
                self._exec_write_batch(writes)
            if reads:
                self._exec_read_batch(reads)


@register_backend("fused")
class FusedBackend(_FrontendBackendBase):
    """The single-step engine (core/fused.py): admission -> CoW writes ->
    mirrored stores -> rr reads -> retirement on the device, one host fetch
    per pump. The null cuts run the step without storage (``null_backend``)
    or without the data plane (``null_storage``)."""

    def __init__(self, cfg):
        if cfg.storage != "dbs":
            raise ValueError("backend='fused' requires storage='dbs'")
        if cfg.write_policy != "all" or cfg.read_policy != "rr":
            raise ValueError(
                "backend='fused' serves the data plane IN-PROGRAM "
                "(mirror-to-all writes, in-program rr reads); write_policy="
                f"{cfg.write_policy!r}/read_policy={cfg.read_policy!r} "
                "need a host-dispatch backend (loop | slots)")
        super().__init__(cfg)
        # cold-extent spill tier (repro_torch/durability/tier.py): bounded
        # device-resident hot set, host-memory capacity tier, spill/fill at
        # the pump boundary. Needs the real DBS storage plane.
        self.tier = None
        if cfg.tier is not None:
            if cfg.null_backend or cfg.null_storage:
                raise ValueError("tier= needs the real storage plane "
                                 "(null_backend/null_storage hold no pools)")
            from repro_torch.durability.tier import as_tier
            self.tier = as_tier(cfg.tier, cfg.n_extents, self.device)

    def pump(self) -> int:
        """One controller iteration: drain raw request tensors in, run the
        fused step, and fetch ``(ok, reads)`` to the host exactly once.
        Between admission and completion nothing crosses to the host.

        With a tier, spill/fill rides the pump boundary: the spilled
        extents the batch touches fault in before the step (which reads
        replica 0's table back to the host), the step is the *tiered* one
        (it also stamps per-extent access ticks), and an over-budget
        resident set is rebalanced after (which reads the stamps back)."""
        reqs, batch = self.frontend.drain_batch(self.cfg.payload_shape)
        if not reqs:
            return 0
        cuts = dict(null_backend=self.cfg.null_backend,
                    null_storage=self.cfg.null_storage, kernel=self._kernel)
        if self.storage is None:
            states, pools, page_revs, rr = (), (), (), 0
        else:
            states, pools = self.storage.device_state()
            page_revs = self.storage.device_page_revs()
            rr = self.storage.bump_rr()
        tier = self.tier
        if tier is not None:
            pools, touched = tier.fault_in(states[0].table.cpu().numpy(),
                                           reqs, pools)
            if any(r.kind == "write" for r in reqs):
                (table, states, pools, page_revs, tier.stamps, ok,
                 reads) = fused_step_tiered(
                    self.frontend.table, states, pools, page_revs,
                    tier.stamps, batch, rr, kernel=self._kernel)
                self.storage.set_device_page_revs(page_revs)
            else:
                table, tier.stamps, ok, reads = fused_step_read_tiered(
                    self.frontend.table, states, pools, tier.stamps, batch,
                    rr, kernel=self._kernel)
            pools = tier.balance(pools, protect=touched)
            self.storage.set_device_state(states, pools)
        elif any(r.kind == "write" for r in reqs):
            table, states, pools, page_revs, ok, reads = fused_step(
                self.frontend.table, states, pools, page_revs, batch, rr,
                **cuts)
            if self.storage is not None:
                self.storage.set_device_state(states, pools)
                self.storage.set_device_page_revs(page_revs)
        else:
            # read-only batch: replica state is untouched
            table, ok, reads = fused_step_read(
                self.frontend.table, states, pools, batch, rr, **cuts)
        self.frontend.table = table
        # the single host hop: completion flags + completed read payloads
        ok_host, reads_host = fetch_to_host(ok, reads)
        done = 0
        requeues: List[Request] = []
        for i, r in enumerate(reqs):
            if ok_host[i]:
                r.status = 0
                if r.kind == "read":
                    r.result = reads_host[i]
                done += 1
            else:
                requeues.append(r)
        self.frontend.ring.requeue_all(requeues)
        self.completed += done
        return done


@register_backend("host")
class HostStateBackend(ControlDispatch):
    """ONE DBS state and payload pool, strictly sequential: one request per
    pump, in submission order.

    The reference oracle the byte-API tests compare engine backends
    against, and the control plane of the copy-based serving baseline:
    ``alloc_pages`` runs the DBS page allocation/CoW on this state and
    returns the ``WriteOps`` (destination extents, CoW sources) for the
    embedder's own pools (serving/engine.py, through
    ``blockdev.VolumeManager``). Under either null cut it holds no pool."""

    is_pool = False
    data_kinds = frozenset({"read", "write", "compute"})

    def __init__(self, cfg):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.frontend = None                 # no admission machinery at all
        self.storage = None
        self.state = dbs.make_state(cfg.n_extents, cfg.max_volumes,
                                    cfg.max_pages, device=self.device)
        self.pool = (None if cfg.null_storage or cfg.null_backend
                     else torch.zeros(
            (cfg.n_extents + 1, cfg.page_blocks) + tuple(cfg.payload_shape),
            dtype=torch.float32, device=self.device))
        self.queue: collections.deque = collections.deque()
        self.step = 0                        # pump tick (latency accounting)
        self.completed = 0

    def _i(self, xs) -> torch.Tensor:
        return torch.tensor(xs, dtype=torch.int64, device=self.device)

    def create_volume(self) -> int:
        self.state, vid = dbs.create_volume(self.state)
        return int(vid)

    def submit(self, req: Request) -> None:
        if req.kind not in self.data_kinds:
            raise ValueError(
                f"kind={req.kind!r} requests need backend='ring'; the host "
                "oracle carries data and compute ops only — use control()")
        req.tick = self.step
        self.queue.append(req)

    def depth(self) -> int:
        return len(self.queue)

    def pump(self) -> int:
        """Execute ONE queued request (strictly sequential: the oracle's
        point is per-op submission-order semantics)."""
        if not self.queue:
            return 0
        r = self.queue.popleft()
        status = 0
        if r.kind == "write":
            self.state, ops = dbs.write_pages(
                self.state, r.volume, self._i([r.page]),
                self._i([1 << r.block]),
                torch.ones((1,), dtype=torch.bool, device=self.device))
            if self.pool is not None:
                pay = torch.from_numpy(np.asarray(
                    r.payload, np.float32).reshape(
                        (1,) + tuple(self.cfg.payload_shape)))
                self.pool = dbs.apply_write_ops(
                    self.pool, ops, pay.to(self.device),
                    self._i([r.block]))
        elif r.kind == "compute":
            # the sequential host_ref: the reference every in-program
            # backend's storage-function results are held against
            if self.pool is not None:
                from repro_torch.compute.exec import host_compute
                val, status, out, self.state, self.pool = host_compute(
                    self.state, self.pool, r, self.cfg.payload_shape)
                r.result = (val, out)
        elif self.pool is not None:
            ext = self.state.table[r.volume, r.page]
            got = self.pool[ext.clamp(min=0), r.block]
            r.result, = fetch_to_host(torch.where(ext >= 0, got, 0))
        r.status = status
        r.latency = self.step - r.tick + 1
        self.step += 1
        self.completed += 1
        return 1

    def drain(self, max_iters: int = 1_000_000) -> int:
        n = 0
        for _ in range(max_iters):
            if not self.pump():
                break
            n += 1
        return n

    def snapshot(self, volume: int) -> int:
        self.state, sid = dbs.snapshot(self.state, volume)
        return int(sid)

    def clone(self, volume: int) -> int:
        self.state, vid = dbs.clone(self.state, volume)
        return int(vid)

    def unmap(self, volume: int, pages) -> None:
        ps = list(pages)
        if ps:
            self.state = dbs.unmap(self.state, volume, self._i(ps))

    def delete_volume(self, volume: int) -> None:
        self.state = dbs.delete_volume(self.state, volume)

    # -- the external-data-plane hook (serving/engine.py) -------------------
    def alloc_pages(self, vols, pages, mask=None, bits=None) -> dbs.WriteOps:
        """Page allocation/CoW on this backend's state for an external data
        plane: ``vols``/``pages`` (B,) device tensors (or a scalar volume),
        ``bits`` the written blocks' bitmaps (block 0 by default, as in
        the reference). Returns the ``WriteOps``; nothing is fetched."""
        if bits is None:
            bits = torch.ones(pages.shape, dtype=torch.int64,
                              device=pages.device)
        self.state, ops = dbs.write_pages(self.state, vols, pages, bits,
                                          mask)
        return ops


@register_backend("sharded")
def _make_sharded(cfg):
    from repro_torch.core.sharded import EnginePool
    return EnginePool(cfg)


@register_backend("ring")
def _make_ring(cfg):
    from repro_torch.core.ring import RingEngine
    return RingEngine(cfg)


@register_backend("upstream")
def _make_upstream(cfg):
    from repro_torch.core.engine import UpstreamEngine
    return UpstreamEngine(cfg)
