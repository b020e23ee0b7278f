"""The engine façade and the upstream baseline.

Port of ``repro/core/engine.py``. ``Engine`` is a thin façade over the
backend registry (core/backends.py): ``EngineConfig.comm`` names a
registered backend, ``make_backend`` builds it, and every method delegates.
``UpstreamEngine`` is the paper's baseline (single-loop frontend,
per-request dispatch, chained snapshot lookup on reads), registered as
``backend="upstream"``; ``ChainedStore`` is its sparse-file-style store,
and ``ChainedReplicas`` puts that store behind the modern frontends
(``storage="chained"``).

The null layer cuts are the paper's §IV-A methodology:
  null_backend  — requests complete at the controller (frontend-only run)
  null_storage  — replicas ack without touching storage (no-storage run)

``device`` names the torch device the engine's state lives on. With no
device the engine runs on ``cuda`` and raises if no card is present: it
never falls back to the CPU. Tests pass ``device="cpu"``.

Configuration whose slice of the port has not landed raises a
``ValueError`` that names the slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.control import ControlDispatch
from repro_torch.core.frontend import Request, UpstreamFrontend


@dataclass
class EngineConfig:
    n_replicas: int = 2
    n_queues: int = 4            # ublk frontend hardware queues
    n_slots: int = 256           # Messages Array size (max in-flight)
    batch: int = 64              # admission batch
    n_extents: int = 1024
    max_volumes: int = 16
    max_pages: int = 256
    page_blocks: int = 32        # paper: 32 blocks per extent
    payload_shape: Tuple[int, ...] = (64,)
    null_backend: bool = False
    null_storage: bool = False
    storage: str = "dbs"         # dbs | chained (sparse-file-style baseline)
    comm: str = "fused"          # a REGISTERED BACKEND name (core/backends):
                                 # fused | slots | loop | sharded | ring
                                 # | host | upstream
    cow: str = "auto"            # LEGACY data-plane axis (pre-registry):
                                 # auto | pallas | ref, only consulted
                                 # when kernel="auto"
    kernel: str = "auto"         # a REGISTERED KERNEL (kernels/dbs
                                 # registry): auto (follow cow: cuda, or
                                 # torch for cow="ref") | cuda | torch
                                 # | ref | copy
    n_shards: int = 1            # engine shards of comm="sharded"/"ring"
    compute_tail: int = 8        # max COMPUTE requests a ring batch (the
                                 # drain's compute window, core/ring.py)
    transport: str = "local"     # controller<->replica wire (a REGISTERED
                                 # TRANSPORT): local | device | simnet
    write_policy: str = "all"    # all | quorum | async (host dispatch)
    read_policy: str = "rr"      # rr | latency
    transport_opts: Optional[Dict[str, Any]] = None
                                 # simnet: latency / window / drop / reorder
                                 # / seed; list values are per-replica
    journal: Any = None
    tier: Any = None
    device: Any = None           # torch device; None = cuda (no fallback)


def resolve_device(device) -> torch.device:
    """The engine's device: ``None`` means ``cuda``, which must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain versions on the CPU")
    return dev


def check_cow(cfg: EngineConfig) -> None:
    """Raise as the reference does on a value of the legacy ``cow`` axis
    that it does not know (``kernels/dbs/registry.py resolve_kernel_name``
    maps the others)."""
    if cfg.cow not in ("auto", "pallas", "ref"):
        raise ValueError(f"unknown cow impl {cfg.cow!r} "
                         "(expected auto | pallas | ref)")


class Engine:
    """Thin façade over a registered backend (core/backends.py):
    ``.frontend`` is the backend's frontend, ``.backend`` its replica
    storage (both None on the host backend), and ``.pool`` the backend
    itself when it is a shard pool (``comm="sharded"``), else None."""

    def __init__(self, cfg: EngineConfig):
        check_cow(cfg)
        from repro_torch.kernels.dbs.registry import available_kernels
        if cfg.kernel != "auto" and cfg.kernel not in available_kernels():
            raise ValueError(
                f"unknown kernel {cfg.kernel!r} (expected auto | "
                f"{' | '.join(available_kernels())})")
        if cfg.tier is not None and cfg.comm != "fused":
            raise ValueError(
                f"tier= (the cold-extent spill tier) needs comm='fused': "
                f"the tier's access stamps live in the fused step; got "
                f"comm={cfg.comm!r}")
        cfg.device = resolve_device(cfg.device)
        self.cfg = cfg
        from repro_torch.core.backends import make_backend
        self._impl = make_backend(cfg.comm, cfg)
        # the durability journal (repro_torch/durability): resolved here so
        # EngineConfig(journal=path) is enough to enable it; the manager
        # (core/blockdev.py) owns the record buffer and the group commit
        self.journal = None
        self._journal_owned = False
        if cfg.journal is not None:
            from repro_torch.durability.journal import as_journal
            self.journal = as_journal(cfg.journal)
            self._journal_owned = self.journal is not cfg.journal
        self.pool = (self._impl if getattr(self._impl, "is_pool", False)
                     else None)
        # the host backend has no frontend, no replica storage and no
        # data-plane kernel
        self.frontend = self._impl.frontend
        self.backend = self._impl.storage
        self._kernel = getattr(self._impl, "_kernel", None)

    @property
    def impl(self):
        """The registered backend instance behind this façade."""
        return self._impl

    @property
    def data_kinds(self):
        """Request kinds the backend's submission boundary accepts."""
        return self._impl.data_kinds

    @property
    def completed(self) -> int:
        return self._impl.completed

    @completed.setter
    def completed(self, v: int) -> None:
        self._impl.completed = v

    def create_volume(self) -> int:
        return self._impl.create_volume()

    def snapshot(self, vol: int):
        return self._impl.control("snapshot", volume=vol)

    def clone(self, vol: int) -> int:
        return self._impl.control("clone", volume=vol)

    def unmap(self, vol: int, pages) -> None:
        self._impl.control("unmap", volume=vol, pages=pages)

    def delete_volume(self, vol: int) -> None:
        self._impl.control("delete", volume=vol)

    def control(self, kind: str, **kw) -> Any:
        """Raw control-plane passthrough (snapshot/clone/unmap/delete/fail/
        rebuild)."""
        return self._impl.control(kind, **kw)

    def submit(self, req: Request) -> None:
        self._impl.submit(req)

    def depth(self) -> int:
        return self._impl.depth()

    def pump(self) -> int:
        """One backend iteration. Returns the number of completions."""
        return self._impl.pump()

    def drain(self, max_iters: int = 100_000) -> int:
        return self._impl.drain(max_iters)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A stored payload as host numpy that owns its memory."""
    return t.to("cpu", copy=True).numpy()


class ChainedReplicas:
    """ReplicaGroup-shaped adapter over the sparse-file-style
    ``ChainedStore`` (the upstream storage scheme behind the modern
    frontend/comm layers: the ladder's ``+frontend`` and ``+comm``
    columns)."""

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.stores = [ChainedStore(cfg.payload_shape, device=cfg.device)
                       for _ in range(cfg.n_replicas)]
        self._rr = 0

    def _agree(self, ids) -> int:
        """Mirrored control ops must agree on the id every store assigned:
        divergent ids would route later I/O of the volume to different data
        on each replica."""
        if len(set(ids)) != 1:
            raise RuntimeError(f"replica stores diverged on id: {ids}")
        return ids[0]

    def create_volume(self) -> int:
        return self._agree([s.create_volume() for s in self.stores])

    def snapshot(self, vol: int) -> None:
        for s in self.stores:
            s.snapshot(vol)

    def clone(self, vol: int) -> int:
        return self._agree([s.clone(vol) for s in self.stores])

    def unmap(self, vol: int, pages) -> None:
        for s in self.stores:
            for p in pages:
                s.unmap(vol, int(p))

    def delete_volume(self, vol: int) -> None:
        for s in self.stores:
            s.delete_volume(vol)

    def write(self, vol, pages, offs, payload, mask=None) -> None:
        """Mirror per-lane block writes to every store, sequentially. vol:
        scalar or per-lane; host lists or arrays."""
        vols = np.broadcast_to(np.asarray(vol), (len(pages),))
        for s in self.stores:
            for i in range(len(pages)):
                if mask is not None and not bool(mask[i]):
                    continue
                s.write(int(vols[i]), int(pages[i]), int(offs[i]),
                        payload[i])

    def read(self, vol, pages, offs) -> Optional[List[Any]]:
        """One block per lane from the next store in round-robin order: the
        stored device tensors, None for holes. With ``null_storage`` no
        store serves and the cursor stays put (returns None)."""
        if self.cfg.null_storage:
            return None
        s = self.stores[self._rr % len(self.stores)]
        self._rr += 1
        vols = np.broadcast_to(np.asarray(vol), (len(pages),))
        return [s.read(int(vols[i]), int(pages[i]), int(offs[i]))
                for i in range(len(pages))]


# ---------------------------------------------------------------------------
# upstream baseline
# ---------------------------------------------------------------------------
class ChainedStore:
    """Sparse-file-style backing store: per-snapshot page maps; reads walk
    the snapshot chain newest->oldest (paper: 'Reads in volumes with many
    snapshots may have to go through the whole chain'). Payloads live on
    ``device``, each in memory of its own (a view into a caller's batch
    would change under a later write and keep the whole batch alive)."""

    def __init__(self, payload_shape=(64,), *, device):
        self.chains: Dict[int, List[Dict[Any, Any]]] = {}
        self.payload_shape = tuple(payload_shape)
        self.device = torch.device(device)
        self._next = 0
        self.layers_walked = 0      # instrumentation: chain-walk depth
        self.reads = 0

    def create_volume(self) -> int:
        vid = self._next
        self._next += 1
        self.chains[vid] = [{}]
        return vid

    # control ops are no-op-on-miss (clone: -1), like the DBS path they are
    # compared against
    def snapshot(self, vol: int) -> None:
        if vol in self.chains:
            self.chains[vol].append({})     # new live layer

    def clone(self, vol: int) -> int:
        """Fork: freeze src (snapshot), share its frozen layers (the dicts
        themselves: CoW at layer granularity), own a fresh live layer."""
        if vol not in self.chains:
            return -1
        self.snapshot(vol)
        vid = self._next
        self._next += 1
        self.chains[vid] = list(self.chains[vol][:-1]) + [{}]
        return vid

    def unmap(self, vol: int, page: int) -> None:
        """TRIM a page: a tombstone in the live layer shadows older layers;
        same-layer writes to the page are dropped (trim-after-write wins,
        and a later write re-creates the key, so write-after-trim wins)."""
        if vol not in self.chains:
            return
        live = self.chains[vol][-1]
        for key in [k for k in live if k[0] == page]:
            del live[key]
        live[("TRIM", page)] = True

    def delete_volume(self, vol: int) -> None:
        self.chains.pop(vol, None)      # clones keep their shared layers

    def write(self, vol: int, page: int, block: int, payload) -> None:
        live = self.chains[vol][-1]
        if isinstance(payload, torch.Tensor):
            own = payload.to(self.device, torch.float32, copy=True)
        else:
            own = torch.as_tensor(np.asarray(payload, np.float32)).to(
                self.device, copy=True)
        live[(page, block)] = own       # delegated allocation (dict = fs)

    def read(self, vol: int, page: int, block: int):
        self.reads += 1
        for layer in reversed(self.chains.get(vol, ())):   # walk the chain
            self.layers_walked += 1
            if (page, block) in layer:
                return layer[(page, block)]
            if ("TRIM", page) in layer:
                return None             # unmapped above any older data
        return None


class UpstreamEngine(ControlDispatch):
    """TGT-style frontend + loop-function dispatch + chained sparse store,
    registered as ``backend="upstream"``: the measured baseline satisfies
    the backend protocol, so the byte API runs against it too. Its stores
    are mirrored as ``ChainedReplicas`` mirrors them (none under
    ``null_backend``); each request is one pump, and a read's payload comes
    back to the host as it completes (one copy per read)."""

    is_pool = False
    data_kinds = frozenset({"read", "write"})
    storage = None                  # no replica-group-shaped storage object

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.frontend = UpstreamFrontend(max_inflight=cfg.n_slots)
        self._chain = None if cfg.null_backend else ChainedReplicas(cfg)
        self.completed = 0

    @property
    def stores(self) -> Optional[List[ChainedStore]]:
        return None if self._chain is None else self._chain.stores

    def create_volume(self) -> int:
        return 0 if self._chain is None else self._chain.create_volume()

    def snapshot(self, vol: int) -> None:
        if self._chain is not None:
            self._chain.snapshot(vol)

    def clone(self, vol: int) -> int:
        return -1 if self._chain is None else self._chain.clone(vol)

    def unmap(self, vol: int, pages) -> None:
        if self._chain is not None:
            self._chain.unmap(vol, pages)

    def delete_volume(self, vol: int) -> None:
        if self._chain is not None:
            self._chain.delete_volume(vol)

    def depth(self) -> int:
        return len(self.frontend)

    def submit(self, req: Request) -> None:
        # validate before enqueue, like every registered backend
        if req.kind not in self.data_kinds:
            raise ValueError(
                f"kind={req.kind!r} requests need backend='ring'; the "
                "upstream baseline carries data ops only")
        self.frontend.submit(req)

    def pump(self) -> int:
        got = self.frontend.poll_one()      # ONE request per loop iteration
        if got is None:
            return 0
        mid, req = got
        if self._chain is not None and not self.cfg.null_storage:
            if req.kind == "write":         # mirrored, sequential
                self._chain.write(req.volume, [req.page], [req.block],
                                  [req.payload])
            else:                           # the next store, round-robin
                val, = self._chain.read(req.volume, [req.page], [req.block])
                req.result = None if val is None else _to_host(val)
        self.frontend.complete(mid)
        req.status = 0
        self.completed += 1
        return 1

    def drain(self, max_iters: int = 1_000_000) -> int:
        n = 0
        for _ in range(max_iters):
            got = self.pump()
            if got == 0 and len(self.frontend) == 0:
                break
            n += got
        return n
