"""The backend registry and the fused backend.

Port of the registry, ``_FrontendBackendBase`` and ``FusedBackend`` of
``repro/core/backends.py``. A backend is a named factory ``cfg ->
Backend``; ``Engine`` (core/engine.py) and ``VolumeManager``
(core/blockdev.py) look the name up here. The backend protocol is
``submit(req)``, ``pump()``, ``drain()``, ``control(kind, ...)``,
``create_volume()``, ``depth()``, ``completed``, ``storage``, ``is_pool``
and ``data_kinds``.

Only ``fused`` is ported. The other names of the JAX registry raise a
``ValueError`` naming the slice that brings them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.control import ControlDispatch
from repro_torch.core.frontend import MultiQueueFrontend, Request
from repro_torch.core.fused import fused_step, fused_step_read
from repro_torch.core.replication import ReplicaGroup
from repro_torch.kernels.dbs.registry import resolve_kernel_name

# backends of the JAX package that later slices of the port bring
UNPORTED_BACKENDS = {"loop": "the host-dispatch slice",
                     "slots": "the host-dispatch slice",
                     "host": "the host-dispatch slice",
                     "sharded": "the shards slice",
                     "ring": "the ring slice",
                     "upstream": "the controller slice"}

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
    if name not in _REGISTRY and name in UNPORTED_BACKENDS:
        raise ValueError(f"backend={name!r} lands with "
                         f"{UNPORTED_BACKENDS[name]} of the port")
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
    frontend, the replica storage and host-side control dispatch."""

    is_pool = False
    data_kinds = frozenset({"read", "write"})

    def __init__(self, cfg):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.frontend = MultiQueueFrontend(cfg.n_queues, cfg.n_slots,
                                           cfg.batch, device=self.device)
        self.storage = ReplicaGroup(
            cfg.n_replicas, cfg.n_extents, cfg.max_volumes, cfg.max_pages,
            cfg.page_blocks, cfg.payload_shape, transport=cfg.transport,
            device=self.device)
        self._kernel = resolve_kernel_name(cfg)
        self.completed = 0

    def create_volume(self) -> int:
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
        # or drops them silently; a CUDA gather faults)
        cfg = self.cfg
        if not (0 <= req.volume < cfg.max_volumes
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
        return self.storage.snapshot(volume)

    def clone(self, volume: int) -> int:
        return self.storage.clone(volume)

    def unmap(self, volume: int, pages) -> None:
        self.storage.unmap(volume, pages)

    def delete_volume(self, volume: int) -> None:
        self.storage.delete_volume(volume)

    def _control_repl(self, kind, shard, replica):
        return getattr(self.storage, kind)(replica)  # fail / rebuild

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


@register_backend("fused")
class FusedBackend(_FrontendBackendBase):
    """The single-step engine (core/fused.py): admission -> CoW writes ->
    mirrored stores -> rr reads -> retirement on the device, one host fetch
    per pump. ``engine.check_ported`` has already rejected the storage
    and policies it does not serve."""

    def pump(self) -> int:
        """One controller iteration: drain raw request tensors in, run the
        fused step, and fetch ``(ok, reads)`` to the host exactly once.
        Between admission and completion nothing crosses to the host."""
        reqs, batch = self.frontend.drain_batch(self.cfg.payload_shape)
        if not reqs:
            return 0
        states, pools = self.storage.device_state()
        page_revs = self.storage.device_page_revs()
        rr = self.storage.bump_rr()
        if any(r.kind == "write" for r in reqs):
            table, states, pools, page_revs, ok, reads = fused_step(
                self.frontend.table, states, pools, page_revs, batch, rr,
                kernel=self._kernel)
            self.storage.set_device_state(states, pools)
            self.storage.set_device_page_revs(page_revs)
        else:
            # read-only batch: replica state is untouched
            table, ok, reads = fused_step_read(
                self.frontend.table, states, pools, batch, rr,
                kernel=self._kernel)
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
