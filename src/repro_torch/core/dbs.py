"""Device-side Direct Block Store (paper §IV-D), on torch tensors.

Port of ``repro/core/dbs.py``; the layout is the same:

- the storage medium is a fixed pool of **extents**; payload pools live
  beside the state and are indexed by extent id,
- the extent-status region is ``extent_owner`` (owning snapshot per extent)
  plus a per-extent **block bitmap** of 32 bits. torch has no ``<<`` or
  ``index_put_`` on uint32, so the bitmap is held as int64 masked to 32 bits
  (``convert.py`` carries it to and from uint32),
- volume and snapshot metadata are fixed tables (``vol_head``,
  ``snap_parent``, ``snap_vol``),
- the superblock allocation mark is the free-extent ``SlotRing``,
- the in-memory extent map ``table[vol, page] -> extent`` makes reads O(1)
  and independent of the snapshot-chain depth.

Every function returns new metadata tensors and reads nothing back to the
host. ``DBSState`` and ``WriteOps`` are pytrees, and ``write_pages``,
``read_resolve`` and the slot functions run unchanged under
``torch.func.vmap`` over a leading shard axis (core/sharded.py); the
control ops take host ints and run on one shard's slice. JAX clamps
out-of-bounds gathers and drops out-of-bounds scatters; torch raises on
both, so each such site clamps, masks or scatters into a one-row pad that
is sliced off.

``write_pages`` is the control plane. ``apply_write_ops`` is the plain
data-plane reference (the ``torch`` kernel-registry entry); the fused step
runs the hand-written ``dbs_rw`` kernels (kernels/dbs).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.core.slots import (SlotRing, _isum, _scatter_drop, acquire,
                                    make_ring, register_pytree_dataclass,
                                    release)

NULL = -1
I32 = torch.int32
BITS = 32                   # bitmap width: blocks per extent row at most


@register_pytree_dataclass
@dataclass
class DBSState:
    # extent-status region
    extent_owner: torch.Tensor  # (E,) int32 snapshot id, -1 = free
    bitmap: torch.Tensor        # (E,) int64 allocated-block bits (32 used)
    free: SlotRing              # available extent ids
    # volume / snapshot metadata region
    vol_head: torch.Tensor      # (V,) int32 head snapshot, -1 = unused volume
    snap_parent: torch.Tensor   # (S,) int32 parent snapshot, -1 root, -2 unused
    snap_vol: torch.Tensor      # (S,) int32 owning volume
    n_snaps: torch.Tensor       # () int32 next snapshot id (monotone)
    # in-memory flattened extent maps (one per volume)
    table: torch.Tensor         # (V, P) int32 page -> extent, -1 = hole
    # mirroring metadata (paper §III: replica consistency "version")
    revision: torch.Tensor      # () int32 bumped on every mutating op

    @property
    def n_extents(self) -> int:
        return self.extent_owner.shape[0]


def make_state(n_extents: int, max_volumes: int, max_pages: int,
               max_snapshots: int = 0, *, device) -> DBSState:
    s = max_snapshots or (4 * max_volumes)
    full = lambda shape, v: torch.full(shape, v, dtype=I32, device=device)
    return DBSState(
        extent_owner=full((n_extents,), NULL),
        bitmap=torch.zeros((n_extents,), dtype=torch.int64, device=device),
        free=make_ring(n_extents, device),
        vol_head=full((max_volumes,), NULL),
        snap_parent=full((s,), -2),
        snap_vol=full((s,), NULL),
        n_snaps=full((), 0),
        table=full((max_volumes, max_pages), NULL),
        revision=full((), 0),
    )


def _bump(st: DBSState) -> DBSState:
    return dataclasses.replace(st, revision=st.revision + 1)


def _vol(st: DBSState, vol) -> torch.Tensor:
    """A volume id as an int64 device tensor (control ops take host ints)."""
    if isinstance(vol, torch.Tensor):
        return vol.to(torch.int64)
    return torch.full((), int(vol), dtype=torch.int64,
                      device=st.vol_head.device)


def _ix(i: torch.Tensor) -> torch.Tensor:
    """A 0-d index tensor as a (1,) int64 one. Outside ``vmap`` torch reads
    a 0-d integer index back to the host (``.item()``), which synchronises
    with a card; a (1,) index stays on the device."""
    return i.reshape(1).long()


def _get(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[i]`` for a 0-d index tensor that callers keep in bounds."""
    return a[_ix(i)][0]


def _set(a: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``a.at[i].set(v)`` for a 0-d index tensor that callers keep in
    bounds."""
    a = a.clone()
    a[_ix(i)] = v
    return a


def _true(n: int, device) -> torch.Tensor:
    """(n,) True, filled on the device: a Python scalar stored into a CUDA
    tensor is copied from the host, which synchronises."""
    return torch.ones((n,), dtype=torch.bool, device=device)


def _first_free_volume(st: DBSState) -> torch.Tensor:
    # argmin over bools raises in torch: cast first (first minimum wins)
    return torch.argmin((st.vol_head >= 0).to(I32))


# ---------------------------------------------------------------------------
# volume lifecycle
# ---------------------------------------------------------------------------
def create_volume(st: DBSState) -> Tuple[DBSState, torch.Tensor]:
    """New empty volume (fresh root snapshot). Returns (state, vol_id|-1)."""
    vid = _first_free_volume(st)
    sid = st.n_snaps
    n_s = st.snap_parent.shape[0]
    sidc = sid.clamp(max=n_s - 1)          # JAX clamps; the write is masked
    ok = (_get(st.vol_head, vid) < 0) & (sid < n_s)
    st = dataclasses.replace(
        st,
        vol_head=_set(st.vol_head, vid,
                      torch.where(ok, sid, _get(st.vol_head, vid))),
        snap_parent=_set(st.snap_parent, sidc,
                         torch.where(ok, NULL, _get(st.snap_parent, sidc))),
        snap_vol=_set(st.snap_vol, sidc,
                      torch.where(ok, vid.to(I32), _get(st.snap_vol, sidc))),
        n_snaps=st.n_snaps + ok.to(I32),
        table=_set(st.table, vid,
                   torch.where(ok, NULL, _get(st.table, vid))),
    )
    return _bump(st), torch.where(ok, vid.to(I32), NULL)


def snapshot(st: DBSState, vol) -> Tuple[DBSState, torch.Tensor]:
    """Freeze the volume head; subsequent writes copy-on-write."""
    vol = _vol(st, vol)
    sid = st.n_snaps
    n_s = st.snap_parent.shape[0]
    sidc = sid.clamp(max=n_s - 1)
    head = _get(st.vol_head, vol)
    ok = (head >= 0) & (sid < n_s)
    st = dataclasses.replace(
        st,
        snap_parent=_set(st.snap_parent, sidc,
                         torch.where(ok, head, _get(st.snap_parent, sidc))),
        snap_vol=_set(st.snap_vol, sidc,
                      torch.where(ok, vol.to(I32), _get(st.snap_vol, sidc))),
        vol_head=_set(st.vol_head, vol, torch.where(ok, sid, head)),
        n_snaps=st.n_snaps + ok.to(I32),
    )
    return _bump(st), torch.where(ok, sid, NULL)


def clone(st: DBSState, src_vol) -> Tuple[DBSState, torch.Tensor]:
    """Fork a new volume from src's current state (prefix sharing):
    snapshot(src), then a new volume whose root snapshot's parent is that
    snapshot and whose extent map is a copy of src's."""
    src_vol = _vol(st, src_vol)
    st, frozen = snapshot(st, src_vol)
    vid = _first_free_volume(st)
    sid = st.n_snaps
    n_s = st.snap_parent.shape[0]
    sidc = sid.clamp(max=n_s - 1)
    ok = (_get(st.vol_head, vid) < 0) & (frozen >= 0) & (sid < n_s)
    st = dataclasses.replace(
        st,
        vol_head=_set(st.vol_head, vid,
                      torch.where(ok, sid, _get(st.vol_head, vid))),
        snap_parent=_set(st.snap_parent, sidc,
                         torch.where(ok, frozen, _get(st.snap_parent, sidc))),
        snap_vol=_set(st.snap_vol, sidc,
                      torch.where(ok, vid.to(I32), _get(st.snap_vol, sidc))),
        n_snaps=st.n_snaps + ok.to(I32),
        table=_set(st.table, vid,
                   torch.where(ok, _get(st.table, src_vol),
                               _get(st.table, vid))),
    )
    return _bump(st), torch.where(ok, vid.to(I32), NULL)


def _free_extents(st: DBSState, mask: torch.Tensor) -> DBSState:
    """Return masked extents to the free ring, clear their status."""
    e = st.n_extents
    ids = torch.where(mask, torch.arange(e, dtype=I32, device=mask.device),
                      -1)
    return dataclasses.replace(
        st, free=release(st.free, ids),
        extent_owner=torch.where(mask, NULL, st.extent_owner),
        bitmap=torch.where(mask, 0, st.bitmap))


def delete_volume(st: DBSState, vol) -> DBSState:
    """Delete the volume's snapshot chain and free the extents its
    snapshots own, minus those another live volume's table still references
    (prefix sharing from clones)."""
    vol = _vol(st, vol)
    ok = _get(st.vol_head, vol) >= 0
    owner_vol = torch.where(st.extent_owner >= 0,
                            st.snap_vol[st.extent_owner.clamp(min=0)], NULL)
    mine = ok & (owner_vol == vol)
    n_v = st.vol_head.shape[0]
    live_vols = (st.vol_head >= 0) & (
        torch.arange(n_v, device=vol.device) != vol)
    referenced = torch.zeros((st.n_extents + 1,), dtype=torch.bool,
                             device=vol.device)
    # every index writes True, so duplicate indices are harmless
    idx = torch.where(live_vols[:, None], st.table + 1, 0).flatten().long()
    referenced[idx] = _true(idx.shape[0], idx.device)
    st = _free_extents(st, mine & ~referenced[1:])
    snaps_of_vol = st.snap_vol == vol
    st = dataclasses.replace(
        st,
        vol_head=_set(st.vol_head, vol,
                      torch.where(ok, NULL, _get(st.vol_head, vol))),
        table=_set(st.table, vol, torch.where(ok, NULL, _get(st.table, vol))),
        snap_parent=torch.where(snaps_of_vol & ok, -2, st.snap_parent),
    )
    return _bump(st)


# ---------------------------------------------------------------------------
# I/O path
# ---------------------------------------------------------------------------
def read_resolve(st: DBSState, vol, pages: torch.Tensor) -> torch.Tensor:
    """(B,) page ids -> (B,) extent ids (-1 for holes). O(1) per page and
    independent of snapshot-chain depth."""
    pages = pages.long()
    return st.table[_vol(st, vol).expand(pages.shape), pages]


def _unpack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(B,) 32-bit maps -> (B, 32) bool."""
    shifts = torch.arange(BITS, dtype=torch.int64, device=bits.device)
    return ((bits[:, None] >> shifts) & 1).bool()


def _pack_bits(flags: torch.Tensor) -> torch.Tensor:
    """(B, 32) bool -> (B,) int64 maps (each bit set at most once, so the
    sum never carries)."""
    weights = torch.ones((), dtype=torch.int64, device=flags.device) << \
        torch.arange(BITS, dtype=torch.int64, device=flags.device)
    return (flags.to(torch.int64) * weights).sum(1)


def _group_lanes(vol: torch.Tensor, pages: torch.Tensor,
                 block_bits: torch.Tensor, mask: torch.Tensor,
                 max_pages: int):
    """Group write lanes that target the same (vol, page) pair.

    Returns (leader (B,) — the first live lane of each group, is_leader (B,)
    bool, group_bits (B,) int64 — the OR of the group's block bitmaps,
    meaningful on leader lanes). torch has no OR reduction: the bitmaps are
    unpacked to bools, reduced with ``any`` over the group and repacked
    (a sum would carry on duplicate blocks)."""
    b = pages.shape[0]
    key = vol.to(torch.int64) * max_pages + pages
    same = mask[:, None] & mask[None, :] & (key[:, None] == key[None, :])
    leader = torch.argmax(same.to(I32), dim=1)     # first maximum wins
    is_leader = mask & (leader == torch.arange(b, device=pages.device))
    group = (same[:, :, None] & _unpack_bits(block_bits)[None, :, :]).any(1)
    return leader, is_leader, _pack_bits(group)


def write_pages(st: DBSState, vol, pages: torch.Tensor,
                block_bits: torch.Tensor, mask=None):
    """Write blocks in (possibly new) pages.

    vol: scalar volume id or (B,) tensor; pages: (B,) page indices;
    block_bits: (B,) int64 masks of blocks written. Returns (state,
    WriteOps). Lanes targeting the same (vol, page) pair are grouped: the
    group's first live lane (the leader) resolves allocation/CoW once with
    the OR of the group's bitmaps, and every member lane inherits the
    leader's destination extent.
    """
    pages = pages.long()
    vol = _vol(st, vol).expand(pages.shape)
    if mask is None:
        mask = torch.ones(pages.shape, dtype=torch.bool, device=pages.device)
    n_e, n_p = st.n_extents, st.table.shape[1]
    leader, is_leader, group_bits = _group_lanes(vol, pages, block_bits,
                                                 mask, n_p)
    head = st.vol_head[vol]
    ext = st.table[vol, pages]
    owner = torch.where(ext >= 0, st.extent_owner[ext.clamp(min=0)], NULL)
    in_place = (ext >= 0) & (owner == head) & is_leader
    need_alloc = is_leader & ~in_place                       # hole or CoW
    ring, new_ids, got = acquire(st.free, pages.shape[0], need_alloc)
    dst = torch.where(in_place, ext, new_ids)                # -1 if starved
    ok = (in_place | got) & is_leader
    is_cow = ok & ~in_place & (ext >= 0)

    safe_dst = dst.clamp(min=0)
    old_bits = torch.where(is_cow, st.bitmap[ext.clamp(min=0)], 0)
    new_bits = (st.bitmap[safe_dst] * in_place.to(torch.int64)
                | old_bits | group_bits)
    # lanes that perform no write scatter into a dump row that is sliced
    # off: a write-back of the current value is NOT inert when another lane
    # of the batch targets the same slot. Only group leaders, whose
    # destinations are distinct, reach a live row.
    drop_ext = torch.where(ok, safe_dst, n_e)
    drop_page = torch.where(ok, pages, n_p)
    table = torch.cat([st.table, st.table.new_zeros((st.table.shape[0], 1))],
                      dim=1)
    table[vol, drop_page] = dst
    st = dataclasses.replace(
        st, free=ring,
        extent_owner=_scatter_drop(st.extent_owner, drop_ext, head),
        bitmap=_scatter_drop(st.bitmap, drop_ext, new_bits),
        table=table[:, :n_p].contiguous(),
    )
    # expand leader results to every member lane (cow_src stays leader-only)
    ok_all = mask & ok[leader]
    ops = WriteOps(dst=torch.where(ok_all, dst[leader], NULL),
                   cow_src=torch.where(is_cow, ext, NULL), ok=ok_all)
    return _bump(st), ops


@register_pytree_dataclass
@dataclass
class WriteOps:
    dst: torch.Tensor       # (B,) destination extents (-1 = failed/starved)
    cow_src: torch.Tensor   # (B,) source extents to copy first (-1 = none)
    ok: torch.Tensor        # (B,) bool


def apply_write_ops(pool: torch.Tensor, ops: WriteOps, payload: torch.Tensor,
                    block_offsets: torch.Tensor) -> torch.Tensor:
    """Data-plane half of a write, in place: CoW copies, then payload stores.

    pool: (E+1, page, ...), whose LAST row is the engine's scratch row;
    payload: (B, ...) one block per lane; block_offsets: (B,) position of
    the written block within its page. Returns ``pool``.

    A lane writes only when ``ok`` and ``dst >= 0``. (The JAX reference's
    ``apply_write_ops`` tests only ``ok`` and so writes an ``ok, dst=-1``
    lane into extent 0; its kernels drop such a lane, and so does this
    function. ``write_pages`` never emits one.)

    Lanes that must not write are routed onto the scratch row with the
    value that row already holds, so every duplicate index of a scatter
    writes one value. Where several live lanes store the same (dst, block),
    the highest lane wins, as in XLA's sequential scatter and the kernels'
    routing; the others are routed to the scratch row too, because the
    order in which ``index_put_`` applies duplicates is not defined on CUDA.
    """
    dump = pool.shape[0] - 1
    live = ops.ok & (ops.dst >= 0)
    do_copy = live & (ops.cow_src >= 0)
    src = torch.where(do_copy, ops.cow_src, dump).long()
    dst = torch.where(do_copy, ops.dst, dump).long()
    pool[dst] = pool[src]              # every source row is gathered first
    return store_blocks(pool, ops, payload, block_offsets)


def last_live_lane(key: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """For each lane i, the highest live lane j with ``key[j] == key[i]``,
    or -1 where no live lane shares i's key: the lane that wins a scatter
    index under XLA's sequential order. An (N, N) election on the device,
    with no host sync; the scatters that use it stay deterministic where
    ``index_put_`` leaves the order of duplicates undefined on CUDA."""
    lanes = torch.arange(key.shape[0], device=key.device)
    if not key.shape[0]:
        return lanes
    same = live[None, :] & (key[:, None] == key[None, :])
    return torch.where(same, lanes[None, :], -1).amax(1)


def store_blocks(pool: torch.Tensor, ops: WriteOps, payload: torch.Tensor,
                 block_offsets: torch.Tensor) -> torch.Tensor:
    """The payload-store half of ``apply_write_ops``, in place: each lane
    with ``ok`` and ``dst >= 0`` stores its block; where several store the
    same (dst, block) the highest lane wins (``last_live_lane``), and every
    other lane writes the scratch row's own value back (see
    ``apply_write_ops``)."""
    dump = pool.shape[0] - 1
    page = pool.shape[1]
    blk = block_offsets.long()
    live = ops.ok & (ops.dst >= 0)
    key = ops.dst.long() * page + blk
    lanes = torch.arange(key.shape[0], device=key.device)
    win = live & (last_live_lane(key, live) == lanes)
    rows = torch.where(win, ops.dst, dump).long()
    keep = pool[dump, blk]
    win_b = win.reshape(win.shape + (1,) * (payload.dim() - 1))
    pool[rows, blk] = torch.where(win_b, payload.to(pool.dtype), keep)
    return pool


def unmap(st: DBSState, vol, pages: torch.Tensor) -> DBSState:
    """Drop pages from a volume (TRIM). Extents owned by the live head are
    freed; snapshot-owned extents just unlink (data stays for the
    snapshot)."""
    pages = pages.long()
    vol = _vol(st, vol).expand(pages.shape)
    head = st.vol_head[vol]
    ext = st.table[vol, pages]
    valid = ext >= 0
    owned_by_head = valid & (st.extent_owner[ext.clamp(min=0)] == head)
    e = st.n_extents
    free_mask = torch.zeros((e + 1,), dtype=torch.bool, device=ext.device)
    free_mask[torch.where(owned_by_head, ext, e).long()] = _true(
        ext.shape[0], ext.device)
    st = _free_extents(st, free_mask[:e])
    table = st.table.clone()
    table[vol, pages] = torch.where(valid, NULL, ext)
    return _bump(dataclasses.replace(st, table=table))


# ---------------------------------------------------------------------------
# introspection (host-side convenience)
# ---------------------------------------------------------------------------
def stats(st: DBSState) -> dict:
    vals = torch.stack([
        st.free.tail - st.free.head, _isum(st.extent_owner >= 0),
        _isum(st.vol_head >= 0), st.n_snaps, st.revision]).tolist()
    return dict(zip(("extents_free", "extents_used", "volumes", "snapshots",
                     "revision"), vals))
