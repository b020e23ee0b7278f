"""The engine façade: ``EngineConfig`` and ``Engine``.

Port of ``EngineConfig`` and ``Engine`` from ``repro/core/engine.py``.
``Engine`` is a thin façade over the backend registry (core/backends.py):
``EngineConfig.comm`` names a registered backend, ``make_backend`` builds
it, and every method delegates.

``device`` names the torch device the engine's state lives on. With no
device the engine runs on ``cuda`` and raises if no card is present: it
never falls back to the CPU. Tests pass ``device="cpu"``.

Configuration whose slice of the port has not landed raises a
``ValueError`` that names the slice. The upstream baseline
(``UpstreamEngine``, ``ChainedStore``) lands with the controller slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.frontend import Request


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
    storage: str = "dbs"
    comm: str = "fused"          # a REGISTERED BACKEND name (core/backends)
    cow: str = "auto"            # legacy data-plane axis: auto only
    kernel: str = "auto"         # a REGISTERED KERNEL (kernels/dbs
                                 # registry): auto (= cuda) | cuda | torch
                                 # | ref | copy
    n_shards: int = 1
    transport: str = "local"     # controller<->replica wire: local
    write_policy: str = "all"
    read_policy: str = "rr"
    transport_opts: Optional[Dict[str, Any]] = None
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


def check_ported(cfg: EngineConfig) -> None:
    """Raise a ValueError naming the slice of the port that brings each
    configuration value this slice does not serve."""
    later = [
        (cfg.n_shards > 1, "n_shards > 1 lands with the shards slice"),
        (cfg.transport != "local",
         f"transport={cfg.transport!r} lands with the transport slice"),
        (cfg.write_policy != "all" or cfg.read_policy != "rr",
         f"write_policy={cfg.write_policy!r}/read_policy="
         f"{cfg.read_policy!r} land with the transport slice (the port "
         "serves all/rr)"),
        (cfg.transport_opts is not None,
         "transport_opts= lands with the transport slice"),
        (cfg.journal is not None, "journal= lands with the durability slice"),
        (cfg.tier is not None, "tier= lands with the durability slice"),
        # the copy-based serving baseline's control plane holds no pool
        (cfg.null_backend or (cfg.null_storage and cfg.comm != "host"),
         "the null_backend/null_storage layer cuts land with the benchmark "
         "slice"),
        (cfg.storage != "dbs",
         f"storage={cfg.storage!r} lands with the controller slice"),
        (cfg.cow != "auto",
         f"cow={cfg.cow!r} (the legacy data-plane axis) is not ported; "
         "name a kernel= instead"),
    ]
    for bad, msg in later:
        if bad:
            raise ValueError(msg)


class Engine:
    """Thin façade over a registered backend (core/backends.py):
    ``.frontend`` is the backend's frontend and ``.backend`` its replica
    storage (both None on the host backend)."""

    def __init__(self, cfg: EngineConfig):
        check_ported(cfg)
        from repro_torch.kernels.dbs.registry import available_kernels
        if cfg.kernel != "auto" and cfg.kernel not in available_kernels():
            raise ValueError(
                f"unknown kernel {cfg.kernel!r} (expected auto | "
                f"{' | '.join(available_kernels())})")
        cfg.device = resolve_device(cfg.device)
        self.cfg = cfg
        from repro_torch.core.backends import make_backend
        self._impl = make_backend(cfg.comm, cfg)
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
