"""The DBS kernel registry: named data-plane implementations.

Port of ``repro/kernels/dbs/registry.py``. A name resolves to a
``DBSKernel`` — one ``write`` (the whole write data plane of a batch: CoW
extent copies + payload block stores, in place on the pool) and one
``read`` (the hole-masked block gather).

========  ==================================================================
name      implementation
========  ==================================================================
cuda      the hand-written ``dbs_rw`` CUDA kernels (rw_kernel.py); their
          wrappers run the plain versions for tensors on the CPU
torch     ``dbs.apply_write_ops`` + the hole-masked gather in plain torch —
          the counterpart of JAX's ``xla`` entry, but a lane with
          ``ok`` and ``dst < 0`` is dropped, as the kernels drop it
ref       the plain row-composition versions (ref.py) on any device
copy      the hybrid of JAX's ``copy`` entry: the hand-written ``dbs_copy``
          CUDA kernel (copy_kernel.py) for the CoW rows, then a plain torch
          block scatter; reads are ``torch``'s gather
========  ==================================================================

``kernel="auto"`` resolves to ``cuda``, the counterpart of JAX's
``pallas`` entry. ``write_stacked``/``read_stacked`` run any entry over a
shard-stacked pool in one call (the flattened-row form, ops.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.dbs import ops as _ops


@dataclass(frozen=True)
class DBSKernel:
    """One registered data plane.

    ``write(pool, ops, payload, block_offsets) -> pool`` applies a
    ``dbs.WriteOps`` batch in place to an (E+1, page, *payload) pool (the
    last row is the dump row). ``read(pool, ext, block_offsets) ->
    (B, *payload)`` gathers one block per lane, holes (``ext < 0``) zero.
    """
    name: str
    write: Callable
    read: Callable

    def write_stacked(self, pool, ops, payload, block_offsets):
        """``write`` over a shard-stacked ``(S, E+1, page, *payload)`` pool
        in ONE call: the (S, B) ops, payloads and offsets of every shard
        become S*B lanes over the flattened pool (ops.py ``shard_rows``).
        Updates ``pool`` in place and returns it."""
        from repro_torch.core.dbs import WriteOps
        rows = pool.shape[1]
        flat = WriteOps(dst=_ops.shard_rows(ops.dst, rows),
                        cow_src=_ops.shard_rows(ops.cow_src, rows),
                        ok=ops.ok.reshape(-1))
        self.write(pool.view((-1,) + tuple(pool.shape[2:])), flat,
                   payload.reshape((-1,) + tuple(payload.shape[2:])),
                   block_offsets.reshape(-1))
        return pool

    def read_stacked(self, pool, ext, block_offsets):
        """``read`` over a shard-stacked pool in ONE call: (S, B) shard-local
        extents (holes -1) -> (S, B, *payload), holes zero."""
        s, b = ext.shape
        out = self.read(pool.view((-1,) + tuple(pool.shape[2:])),
                        _ops.shard_rows(ext, pool.shape[1]),
                        block_offsets.reshape(-1))
        return out.view((s, b) + tuple(pool.shape[3:]))


_REGISTRY: Dict[str, DBSKernel] = {}


def register_kernel(name: str, write: Optional[Callable] = None, *,
                    read: Optional[Callable] = None,
                    override: bool = False) -> DBSKernel:
    """Register a ``DBSKernel`` under ``name`` from its two callables (or
    pass a ready ``DBSKernel`` as ``write``). Duplicate names raise unless
    ``override=True``."""
    if isinstance(write, DBSKernel):
        kern = write
    else:
        if write is None or read is None:
            raise ValueError("register_kernel needs write= and read= "
                             "callables (or a DBSKernel)")
        kern = DBSKernel(name=name, write=write, read=read)
    if name in _REGISTRY and not override:
        raise ValueError(
            f"duplicate kernel {name!r} (registered: "
            f"{', '.join(available_kernels())}); pass override=True "
            "to replace")
    _REGISTRY[name] = kern
    return kern


def available_kernels() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_kernel(name: str) -> DBSKernel:
    """Resolve the kernel registered under ``name``."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel {name!r} (registered: "
            f"{', '.join(available_kernels())})") from None


def resolve_kernel_name(cfg) -> str:
    """``EngineConfig`` -> registry name, honouring the legacy ``cow`` axis
    as the reference does: an explicit ``kernel`` wins; ``kernel="auto"``
    follows ``cow``: ``"pallas"`` (the hand-written kernels) and
    ``"auto"`` pick ``cuda``, ``"ref"`` (the plain write of
    ``dbs.apply_write_ops``, the reference's ``xla`` entry) picks
    ``torch``."""
    kernel = getattr(cfg, "kernel", "auto")
    if kernel != "auto":
        return kernel
    return "torch" if getattr(cfg, "cow", "auto") == "ref" else "cuda"


# ---------------------------------------------------------------------------
# built-in entries
# ---------------------------------------------------------------------------
def _torch_write(pool, ops, payload, block_offsets):
    from repro_torch.core import dbs
    return dbs.apply_write_ops(pool, ops, payload, block_offsets)


def _torch_read(pool, ext, block_offsets):
    got = pool[ext.clamp(min=0).long(), block_offsets.long()]
    m = (ext >= 0).reshape(ext.shape + (1,) * (got.dim() - ext.dim()))
    return torch.where(m, got, 0)


def _copy_write(pool, ops, payload, block_offsets):
    """The ``copy`` hybrid: ``dbs_copy`` for the CoW rows, then the block
    scatter of ``dbs.store_blocks``. Not-ok lanes and lanes with no
    destination write nothing (the JAX entry clamps an ``ok, dst=-1`` lane
    onto extent 0; ``write_pages`` never emits one), and duplicate
    (dst, block) lanes are won by the highest lane, as in XLA's sequential
    scatter."""
    from repro_torch.core import dbs
    live = ops.ok & (ops.dst >= 0)
    _ops.dbs_copy_pool(pool, ops.cow_src, ops.dst,
                       (ops.cow_src >= 0) & live)
    return dbs.store_blocks(pool, ops, payload, block_offsets)


def _ref_write(pool, ops, payload, block_offsets):
    from repro_torch.kernels.dbs.ref import dbs_rw_write_ref
    e, page = pool.shape[:2]
    src, dst, lane_of = _ops._route_writes(ops, page, block_offsets, e - 1)
    dbs_rw_write_ref(pool.view(e, page, -1), src, dst, lane_of,
                     payload.reshape(payload.shape[0], -1).to(pool.dtype))
    return pool


def _ref_read(pool, ext, block_offsets):
    from repro_torch.kernels.dbs.ref import dbs_rw_read_ref
    e, page = pool.shape[:2]
    out = dbs_rw_read_ref(pool.view(e, page, -1), ext, block_offsets)
    return out.view((ext.shape[0],) + tuple(pool.shape[2:]))


register_kernel("cuda", _ops.dbs_rw_write_pool, read=_ops.dbs_rw_read_pool)
register_kernel("torch", _torch_write, read=_torch_read)
register_kernel("ref", _ref_write, read=_ref_read)
register_kernel("copy", _copy_write, read=_torch_read)
