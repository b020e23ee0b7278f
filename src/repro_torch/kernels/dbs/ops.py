"""The DBS kernel family's ops surface: write routing, pool wrappers, bytes.

Port of ``repro/kernels/dbs/ops.py``: ``_route_writes`` turns a
``dbs.WriteOps`` batch into the write kernel's one-row-per-lane form,
``dbs_copy_pool``/``dbs_rw_write_pool``/``dbs_rw_read_pool`` adapt an
``(E+1, page, *payload)`` engine pool to the kernels' ``(E+1, page, D)``
layout, and ``dbs_write_bytes``/``dbs_read_bytes``/``dbs_copy_bytes`` count
the bytes a batch semantically moves (the numerator of each kernel's bound).
``dbs_copy`` is the copy kernel's wrapper (copy_kernel.py).

Engine pools carry one row past the allocator's range: the dump row that
inert lanes are parked on (``ReplicaGroup`` sizes pools to n_extents+1).

A shard-stacked pool ``(S, E+1, page, *payload)`` is served in one call as
the flattened ``(S*(E+1), page, *payload)`` pool: ``shard_rows`` offsets
shard s's row ids by ``s*(E+1)`` (holes stay -1), and the kernels index
rows with 64-bit offsets. The write routing then parks inert lanes on the
flattened pool's last row, shard S-1's dump row, where each is a no-op
copy of that row onto itself; no other shard's dump row is touched.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dbs.copy_kernel import dbs_copy
from repro_torch.kernels.dbs.rw_kernel import dbs_rw_read, dbs_rw_write

I32 = torch.int32


def shard_rows(ids, rows_per_shard: int):
    """(S, B) shard-local row ids -> (S*B,) rows of the flattened
    ``(S*rows_per_shard, ...)`` pool: shard s's ids move up by
    ``s*rows_per_shard``; holes (-1) stay -1."""
    off = torch.arange(ids.shape[0], dtype=ids.dtype,
                       device=ids.device)[:, None] * rows_per_shard
    return torch.where(ids >= 0, ids + off, -1).reshape(-1)


def dbs_copy_pool(pool, src, dst, mask, *, check_routing: bool = False):
    """Extent CoW copy over an (E, page, *payload) engine pool, in place:
    the trailing payload dims are flattened to the kernel's (E, page, D)
    view. Returns ``pool``.

    The kernel skips masked lanes without touching memory, so they need no
    routing: they keep their ids (-1 included), and no dump row or appended
    zero row is needed. (The reference's ``scratch=`` option routes them to
    the dump row or appends a zero row, because its kernel rewrites a masked
    lane's destination.) Live lanes must be in range.
    """
    e, page = pool.shape[:2]
    dbs_copy(pool.view(e, page, -1), src.to(I32).contiguous(),
             dst.to(I32).contiguous(), mask.bool().contiguous(),
             check_routing=check_routing)
    return pool


def _route_writes(ops, page: int, block_offsets, dump: int):
    """Route a WriteOps batch into the write kernel's one-row-per-lane form.

    Elect the first live lane of each dst group as its leader (for
    ``write_pages`` batches that is exactly the lane carrying ``cow_src``),
    build its (page,) block -> writing-lane map with a scatter-max (the
    HIGHEST lane wins a block, as XLA's sequential scatter applies
    duplicates; a max is deterministic where ``index_put_`` is not), and
    park every other lane on the ``dump`` row with ``src == dst`` so its
    write is a no-op. Returns (src, dst, lane_of) for ``dbs_rw_write``.
    """
    b = ops.dst.shape[0]
    dev = ops.dst.device
    arange = torch.arange(b, dtype=I32, device=dev)
    ok = ops.ok & (ops.dst >= 0)
    same = ok[None, :] & ok[:, None] & (ops.dst[None, :] == ops.dst[:, None])
    leader = torch.argmax(same.to(I32), dim=1)   # first live lane, my dst
    is_leader = ok & (leader == arange)
    row = torch.where(ok, leader, b)             # row b is the dump
    flat = torch.full(((b + 1) * page,), -1, dtype=I32, device=dev)
    flat.scatter_reduce_(0, row * page + block_offsets.long(), arange,
                         "amax", include_self=True)
    lane_of = torch.where(is_leader[:, None], flat[:b * page].view(b, page),
                          -1)
    src = torch.where(is_leader,
                      torch.where(ops.cow_src >= 0, ops.cow_src, ops.dst),
                      dump).to(I32)
    dst = torch.where(is_leader, ops.dst, dump).to(I32)
    return src, dst, lane_of


def dbs_rw_write_pool(pool, ops, payload, block_offsets, *,
                      check_routing: bool = False):
    """The whole write data plane — CoW copy and payload block stores — as
    one ``dbs_rw_write`` pass over an (E+1, page, *payload) engine pool,
    whose last row is the dump. Updates ``pool`` in place and returns it."""
    e, page = pool.shape[:2]
    flat = pool.view(e, page, -1)
    pay = payload.reshape(payload.shape[0], -1).to(pool.dtype).contiguous()
    src, dst, lane_of = _route_writes(ops, page, block_offsets, e - 1)
    dbs_rw_write(flat, src, dst, lane_of, pay, check_routing=check_routing)
    return pool


def dbs_rw_read_pool(pool, ext, block_offsets):
    """Hole-masked block gather over an (E+1, page, *payload) engine pool:
    returns (B, *payload); lanes with ``ext < 0`` read as zeros."""
    e, page = pool.shape[:2]
    out = dbs_rw_read(pool.view(e, page, -1), ext.to(I32).contiguous(),
                      block_offsets.to(I32).contiguous())
    return out.view((ext.shape[0],) + tuple(pool.shape[2:]))


# ---------------------------------------------------------------------------
# nominal-bytes accounting (the numerator of each kernel's bound)
# ---------------------------------------------------------------------------
def dbs_write_bytes(n_lanes: int, n_cow: int, page_blocks: int,
                    block_elems: int, itemsize: int) -> int:
    """Bytes a write batch SEMANTICALLY moves (implementation-independent):
    each CoW lane reads + writes one whole extent row, each live lane
    writes one block."""
    row = page_blocks * block_elems * itemsize
    return n_cow * 2 * row + n_lanes * block_elems * itemsize


def dbs_read_bytes(n_lanes: int, block_elems: int, itemsize: int) -> int:
    """Bytes a read batch semantically moves: one block read + written out
    per lane."""
    return 2 * n_lanes * block_elems * itemsize


def dbs_copy_bytes(n_copied: int, page_blocks: int, block_elems: int,
                   itemsize: int) -> int:
    """Bytes a copy batch semantically moves: each copied lane reads and
    writes one whole extent row."""
    return 2 * n_copied * page_blocks * block_elems * itemsize
