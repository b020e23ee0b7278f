"""The fused engine step: one controller iteration, device-resident.

Port of ``repro/core/fused.py``. One step per pump performs

    slot admission  ->  write_pages control-plane resolution (per replica)
                    ->  CoW copies + payload stores, mirrored across all
                        replicas (a REGISTERED KERNEL, kernels/dbs: the
                        hand-written ``dbs_rw`` CUDA kernels by default)
                    ->  watermark stamps
                    ->  round-robin read gathers (the same kernel's read)
                    ->  slot retirement

with no host read-back inside: the slot table, every replica's
``DBSState``, pools and watermarks stay on the device across pumps, and the
host fetches ``(ok, reads)`` once per pump (core/backends.py).

JAX donates the step's buffers; here the payload pools are updated in
place (each CoW row is gathered before any destination row is written, by
the routing contract of the kernels), and the small metadata tensors are
replaced by new ones. The round-robin cursor is a host int, so the serving
replica is picked by plain Python indexing. The null layer cuts stop the
step early: ``null_backend`` after admission, ``null_storage`` after the
metadata writes (no pool write, no watermark stamp, no gather).

``step_meta`` is the step's metadata half (admission, ``write_pages``,
watermark stamps), pure tensor code that core/sharded.py maps over a
leading shard axis with an (R,) ``healthy`` mask over a fixed replica
tuple; there the kernels run outside the map on the flattened pools, and
``read_routes`` (the masked round-robin read: the (rr mod H)-th healthy
replica) tells each replica's read launch which lanes are its own.

The tiered variants (``step_core_tiered``, ``step_core_read_tiered``)
thread the spill tier's per-extent access stamps (repro_torch/durability/
tier.py) through the same step and launch the same kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.core import dbs, slots
from repro_torch.core.slots import register_pytree_dataclass
from repro_torch.core.transport import stamp_page_rev
from repro_torch.kernels.dbs.registry import make_kernel


@register_pytree_dataclass
@dataclass
class FusedBatch:
    """Fixed-shape admitted-request batch: the raw tensors the host moves
    in. Inert padding lanes are marked want=False."""
    want: torch.Tensor       # (B,) bool  lane carries a real request
    is_write: torch.Tensor   # (B,) bool  write (True) vs read (False)
    volume: torch.Tensor     # (B,) int32
    page: torch.Tensor       # (B,) int32
    block: torch.Tensor      # (B,) int32 block offset within the page
    payload: torch.Tensor    # (B, *payload) write payloads (zeros for reads)
    queue: torch.Tensor      # (B,) int32 admission queue per lane
    step: torch.Tensor       # ()   int32 admission step (fairness/arrival)


def _cow_apply(pool, ops: dbs.WriteOps, payload, block_offsets, kernel: str):
    """Data plane of a mirrored write batch — CoW extent copies + payload
    block stores — dispatched through the kernel registry; the pool is
    updated in place (its last row is the dump row)."""
    return make_kernel(kernel).write(pool, ops, payload, block_offsets)


def step_meta(table: slots.SlotTable, states: Tuple[dbs.DBSState, ...],
              page_revs: Tuple[torch.Tensor, ...], batch: FusedBatch,
              healthy=None, *, null_backend: bool = False,
              null_storage: bool = False):
    """The metadata half of the step, up to the kernels: admission, each
    replica's ``write_pages`` and watermark stamp. Pure tensor code, so
    core/sharded.py maps it over a leading shard axis.

    ``healthy``: None for the single-engine path (the caller passes only
    healthy replicas, ``ReplicaGroup.device_state``), or an (R,) bool mask
    over a fixed replica tuple: a failed replica's state takes the
    all-masked call, as in the reference, so its revision moves on, and
    its slice takes no writes. Returns ``(table', states', page_revs', ok,
    write ops per replica)``; ``page_revs`` is empty with ``null_storage``,
    the ops with ``null_backend``."""
    table, _ids, ok = slots.transact(table, batch.want, batch.volume,
                                     batch.queue, batch.step)
    if null_backend or not states:
        return table, states, page_revs, ok, ()
    states, page_revs, ops = write_meta(states, page_revs, batch,
                                        ok & batch.is_write, healthy,
                                        null_storage=null_storage)
    return table, states, page_revs, ok, ops


def write_meta(states, page_revs, batch, wmask, healthy=None, *,
               null_storage: bool = False):
    """Each replica's ``write_pages`` of the lanes in ``wmask`` (under the
    (R,) ``healthy`` mask when given: a failed replica takes the
    all-masked call) and its watermark stamp; ``batch`` needs ``volume``,
    ``page`` and ``block`` lanes (a ``FusedBatch`` or the ring's SQE).
    Returns ``(states', page_revs', write ops)``; no watermarks with
    ``null_storage``."""
    bits = torch.ones((), dtype=torch.int64, device=wmask.device) << \
        batch.block.to(torch.int64)
    out_states, out_ops, out_prs = [], [], []
    for i, st in enumerate(states):            # mirrored write-to-all
        m = wmask if healthy is None else wmask & healthy[i]
        st, wops = dbs.write_pages(st, batch.volume, batch.page, bits, m)
        if not null_storage:
            out_prs.append(stamp_page_rev(page_revs[i], batch.volume,
                                          batch.page, wops.ok, st.revision))
        out_states.append(st)
        out_ops.append(wops)
    return tuple(out_states), tuple(out_prs), tuple(out_ops)


def step_core(table: slots.SlotTable, states: Tuple[dbs.DBSState, ...],
              pools: Tuple[torch.Tensor, ...],
              page_revs: Tuple[torch.Tensor, ...], batch: FusedBatch,
              rr: int, *, null_backend: bool = False,
              null_storage: bool = False, kernel: str = "cuda"):
    """The fused controller iteration over the healthy replicas' states,
    pools and watermarks (``pools``/``page_revs`` empty with
    ``null_storage``): ``step_meta``, then each replica's write kernel and
    the round-robin read. Returns ``(table', states', pools', page_revs',
    ok (B,) bool, reads (B, *payload))``."""
    table, states, page_revs, ok, ops = step_meta(
        table, states, page_revs, batch, null_backend=null_backend,
        null_storage=null_storage)
    reads = torch.zeros_like(batch.payload)
    if null_backend or not states:
        return table, states, pools, page_revs, ok, reads
    if null_storage:
        return table, states, (), page_revs, ok, reads
    pools = tuple(_cow_apply(pool, wops, batch.payload, batch.block, kernel)
                  for pool, wops in zip(pools, ops))
    reads = _rr_gather(states, pools, batch, rr, ok & ~batch.is_write,
                       reads, kernel)
    return table, states, pools, page_revs, ok, reads


def fused_step(table, states, pools, page_revs, batch: FusedBatch, rr: int,
               *, null_backend: bool = False, null_storage: bool = False,
               kernel: str = "cuda"):
    """One whole controller iteration (``step_core``). The pools are
    updated in place; callers replace their references to the table,
    states and watermarks with the returned ones."""
    return step_core(table, states, pools, page_revs, batch, rr,
                     null_backend=null_backend, null_storage=null_storage,
                     kernel=kernel)


def _rr_gather(states, pools, batch: FusedBatch, rr: int, rmask, reads,
               kernel: str = "cuda"):
    """Round-robin read: resolve + gather from replica ``rr % R`` (one
    resolve and one gather per batch). Holes (ext < 0) read as zeros."""
    i = rr % len(states)
    ext = dbs.read_resolve(states[i], batch.volume, batch.page)
    vals = make_kernel(kernel).read(pools[i], ext, batch.block)
    return torch.where(rmask.reshape(rmask.shape + (1,) * (vals.dim() - 1)),
                       vals, reads)


def step_core_read(table: slots.SlotTable, states, pools,
                   batch: FusedBatch, rr: int, *, null_backend: bool = False,
                   null_storage: bool = False, kernel: str = "cuda"):
    """``step_core`` specialised to batches with no write lanes (replica
    state and pools are inputs only). Returns ``(table', ok, reads)``."""
    table, _ids, ok = slots.transact(table, batch.want, batch.volume,
                                     batch.queue, batch.step)
    reads = torch.zeros_like(batch.payload)
    if null_backend or null_storage or not states:
        return table, ok, reads
    return table, ok, _rr_gather(states, pools, batch, rr,
                                 ok & ~batch.is_write, reads, kernel)


def fused_step_read(table, states, pools, batch: FusedBatch, rr: int, *,
                    null_backend: bool = False, null_storage: bool = False,
                    kernel: str = "cuda"):
    """``fused_step`` specialised to batches with no write lanes."""
    return step_core_read(table, states, pools, batch, rr,
                          null_backend=null_backend,
                          null_storage=null_storage, kernel=kernel)


# ---------------------------------------------------------------------------
# tiered variants: the same step + per-extent access stamps for the spill
# tier (repro_torch/durability/tier.py). The stamps are an (E+1,) int32
# tensor, row E the dump slot invalid lanes scatter into; every extent a
# batch resolves (read extents, write destinations AND CoW sources) is
# stamped with the batch step inside the step, so the clock/second-chance
# sweep needs no extra device round trip on the hot path.
# ---------------------------------------------------------------------------
def _stamp_tier(stamps, state, batch: FusedBatch, ok, cow_src=None):
    """Stamp the batch's resolved extents with the admission step, in
    place; returns ``stamps``.

    ``state`` is the POST-write replica-0 state, so write lanes resolve to
    their freshly allocated/CoW'd destination extents; ``cow_src`` (the
    write ops' CoW sources, pre-write extents) is stamped too: a CoW read
    is an access. Lanes hit one extent many times, so the stamps take a
    scatter-max (a plain scatter with duplicate indices is undefined on
    CUDA). Invalid lanes land on the dump row E, zeroed back so it never
    looks hot."""
    dump = stamps.shape[0] - 1
    step = batch.step.to(stamps.dtype).reshape(1).expand(ok.shape)
    ext = dbs.read_resolve(state, batch.volume, batch.page)
    idx = torch.where(ok & (ext >= 0), ext, dump).long()
    stamps.scatter_reduce_(0, idx, step, "amax")
    if cow_src is not None:
        src = torch.where(ok & batch.is_write & (cow_src >= 0), cow_src,
                          dump).long()
        stamps.scatter_reduce_(0, src, step, "amax")
    stamps[dump:].zero_()
    return stamps


def step_core_tiered(table: slots.SlotTable, states: Tuple[dbs.DBSState, ...],
                     pools: Tuple[torch.Tensor, ...],
                     page_revs: Tuple[torch.Tensor, ...],
                     stamps: torch.Tensor, batch: FusedBatch, rr: int, *,
                     kernel: str = "cuda"):
    """``step_core`` + tier stamping. The tier needs the real storage
    plane, so there are no null_backend/null_storage forms. Returns
    ``(table', states', pools', page_revs', stamps', ok, reads)``."""
    table, states, page_revs, ok, ops = step_meta(table, states, page_revs,
                                                  batch)
    pools = tuple(_cow_apply(pool, wops, batch.payload, batch.block, kernel)
                  for pool, wops in zip(pools, ops))
    # replicas agree on the CoW sources (mirror-all)
    stamps = _stamp_tier(stamps, states[0], batch, ok, ops[0].cow_src)
    reads = _rr_gather(states, pools, batch, rr, ok & ~batch.is_write,
                       torch.zeros_like(batch.payload), kernel)
    return table, states, pools, page_revs, stamps, ok, reads


def fused_step_tiered(table, states, pools, page_revs, stamps,
                      batch: FusedBatch, rr: int, *, kernel: str = "cuda"):
    """``fused_step`` with the tier's access stamps threaded through (the
    pools and the stamps are updated in place)."""
    return step_core_tiered(table, states, pools, page_revs, stamps, batch,
                            rr, kernel=kernel)


def step_core_read_tiered(table: slots.SlotTable, states, pools,
                          stamps: torch.Tensor, batch: FusedBatch, rr: int,
                          *, kernel: str = "cuda"):
    """``step_core_read`` + tier stamping. Returns ``(table', stamps', ok,
    reads)``."""
    table, _ids, ok = slots.transact(table, batch.want, batch.volume,
                                     batch.queue, batch.step)
    stamps = _stamp_tier(stamps, states[0], batch, ok, None)
    reads = _rr_gather(states, pools, batch, rr, ok & ~batch.is_write,
                       torch.zeros_like(batch.payload), kernel)
    return table, stamps, ok, reads


def fused_step_read_tiered(table, states, pools, stamps, batch: FusedBatch,
                           rr: int, *, kernel: str = "cuda"):
    """``fused_step_read`` + tier stamping: states and pools are inputs
    only; the stamps are updated in place."""
    return step_core_read_tiered(table, states, pools, stamps, batch, rr,
                                 kernel=kernel)


# ---------------------------------------------------------------------------
# the read routes of the shard-stacked pool (vmap-safe; core/sharded.py)
# ---------------------------------------------------------------------------
def read_routes(states, batch: FusedBatch, rr, rmask, healthy):
    """The masked form of ``_rr_gather`` for a fixed replica tuple: each
    replica's read route, the extent of every read lane on the replica
    that serves it and -1 on every other replica and lane. The serving
    replica is the (rr mod H)-th healthy one, picked with the reference's
    rank-compare one-hot, so every lane reads through exactly one
    replica's gather and a hole (-1) loads nothing. ``rr`` is a device
    scalar, ``healthy`` an (R,) bool."""
    h = healthy.to(torch.int32)
    target = rr % h.sum().clamp(min=1)
    sel = healthy & (torch.cumsum(h, 0) - 1 == target)       # (R,) one-hot
    return tuple(torch.where(sel[i] & rmask,
                             dbs.read_resolve(st, batch.volume, batch.page),
                             -1)
                 for i, st in enumerate(states))
