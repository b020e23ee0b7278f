"""The Messages Array + available-ID channel (paper §IV-C), on torch tensors.

Port of ``repro/core/slots.py``. A fixed-size array indexed by
pre-allocated integer tokens handed out through a ring replaces the dynamic
Messages Map, so no lock and no coordinator serialize admission:

- ``ids``   : a ring buffer holding the free token ids (the Go channel),
- ``head``  : pop cursor (acquire), ``tail``: push cursor (release),
- the Messages Array itself is the fixed-size per-slot state indexed by the
  acquired ids (``SlotTable``).

Every function is plain tensor code on the tensors' own device and never
reads a value back to the host. Out-of-bounds scatters (JAX's
``mode="drop"``) become scatters into a one-row pad that is sliced off.

The dataclasses are registered as pytrees (``register_pytree_dataclass``),
so ``torch.func.vmap`` maps these functions over a leading shard axis
unchanged (``make_sharded_table``; core/sharded.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.utils._pytree as pytree

I32 = torch.int32


def register_pytree_dataclass(cls):
    """Register a dataclass of tensors (and nested such dataclasses) as a
    pytree node whose children are its fields in order, so ``vmap`` and
    ``tree_map`` walk it. Returns ``cls`` (usable as a decorator)."""
    names = [f.name for f in dataclasses.fields(cls)]
    pytree.register_pytree_node(
        cls, lambda x: ([getattr(x, n) for n in names], None),
        lambda values, _ctx: cls(*values))
    return cls


@register_pytree_dataclass
@dataclass
class SlotRing:
    ids: torch.Tensor    # (N,) int32 ring storage of free slot ids
    head: torch.Tensor   # () int32, monotonically increasing pop cursor
    tail: torch.Tensor   # () int32, monotonically increasing push cursor

    @property
    def capacity(self) -> int:
        return self.ids.shape[0]


def make_ring(n_slots: int, device) -> SlotRing:
    return SlotRing(ids=torch.arange(n_slots, dtype=I32, device=device),
                    head=torch.zeros((), dtype=I32, device=device),
                    tail=torch.full((), n_slots, dtype=I32, device=device))


def num_free(ring: SlotRing) -> torch.Tensor:
    return ring.tail - ring.head


def _isum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dtype=I32)


def _icumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=I32)


def _scatter_drop(a: torch.Tensor, idx: torch.Tensor, v) -> torch.Tensor:
    """``a.at[idx].set(v, mode="drop")`` for ``idx`` in ``[0, len(a)]``:
    index ``len(a)`` is the dump row, sliced off afterwards."""
    padded = torch.cat([a, a.new_zeros((1,) + a.shape[1:])])
    # a Python scalar is filled on the device: assigning it as is would
    # copy it from the host, which synchronises
    padded[idx] = (v.to(a.dtype).expand(idx.shape)
                   if isinstance(v, torch.Tensor) else
                   torch.full(idx.shape, v, dtype=a.dtype, device=a.device))
    return padded[:-1]


def acquire(ring: SlotRing, k: int, mask=None):
    """Pop up to ``k`` ids. ``mask`` (k,) bool marks lanes that want a token.

    Returns (ring', ids (k,) int32 with -1 for lanes that got nothing, ok (k,)).
    """
    n = ring.capacity
    want = (torch.ones((k,), dtype=torch.bool, device=ring.ids.device)
            if mask is None else mask)
    pos = _icumsum(want.to(I32)) - 1                     # lane -> offset
    ok = want & (pos < num_free(ring))
    idx = (ring.head + pos) % n
    ids = torch.where(ok, ring.ids[idx], -1)
    return dataclasses.replace(ring, head=ring.head + _isum(ok)), ids, ok


def release(ring: SlotRing, ids: torch.Tensor, mask=None) -> SlotRing:
    """Push ids back (lanes with mask=False or id<0 are ignored)."""
    n = ring.capacity
    ok = ids >= 0
    if mask is not None:
        ok = ok & mask
    pos = _icumsum(ok.to(I32)) - 1
    idx = torch.where(ok, (ring.tail + pos) % n, n)      # n = dump slot
    new_ids = _scatter_drop(ring.ids, idx, torch.where(ok, ids, 0))
    return dataclasses.replace(ring, ids=new_ids, tail=ring.tail + _isum(ok))


@register_pytree_dataclass
@dataclass
class SlotTable:
    ring: SlotRing
    active: torch.Tensor     # (N,) bool — slot currently owned
    seq_len: torch.Tensor    # (N,) int32 — tokens generated so far
    volume: torch.Tensor     # (N,) int32 — DBS volume backing this request
    queue: torch.Tensor      # (N,) int32 — admission queue the request used
    arrival: torch.Tensor    # (N,) int32 — admission step (for fairness)
    opcode: torch.Tensor     # (N,) int32 — ring opcode of the slot's request
    fnid: torch.Tensor       # (N,) int32 — storage-fn id (COMPUTE slots)
    status: torch.Tensor     # (N,) int32 — completion status (CQ mirror)


def make_table(n_slots: int, device) -> SlotTable:
    z = lambda: torch.zeros((n_slots,), dtype=I32, device=device)
    return SlotTable(ring=make_ring(n_slots, device),
                     active=torch.zeros((n_slots,), dtype=torch.bool,
                                        device=device),
                     seq_len=z(), volume=z() - 1, queue=z(), arrival=z(),
                     opcode=z(), fnid=z(), status=z())


def make_sharded_table(n_shards: int, n_slots: int, device) -> SlotTable:
    """S independent Messages Arrays, shard-major: every leaf gains a
    leading (S,) axis, so slot ``(s, i)`` belongs to shard ``s`` alone —
    the layout ``torch.func.vmap`` maps one admission over for all shards
    (core/sharded.py)."""
    return pytree.tree_map(
        lambda x: x[None].repeat((n_shards,) + (1,) * x.dim()).contiguous(),
        make_table(n_slots, device))


def admit(table: SlotTable, want: torch.Tensor, volumes, queues, step,
          opcodes=None, fnids=None):
    """Admit up to len(want) requests. Returns (table', slot_ids, ok).

    ``opcodes``/``fnids`` (optional (k,) int32) record each lane's ring
    opcode and storage-function id; omitted lanes record 0."""
    ring, ids, ok = acquire(table.ring, want.shape[0], want)
    # not-admitted lanes scatter into the dump row: clamping them to slot 0
    # would race a lane that legitimately acquired slot 0
    idx = torch.where(ok, ids, table.active.shape[0])
    upd = lambda a, v: _scatter_drop(a, idx, v)
    return dataclasses.replace(
        table, ring=ring,
        active=upd(table.active, True),
        seq_len=upd(table.seq_len, 0),
        volume=upd(table.volume, volumes),
        queue=upd(table.queue, queues),
        arrival=upd(table.arrival, step),
        opcode=upd(table.opcode, 0 if opcodes is None else opcodes),
        fnid=upd(table.fnid, 0 if fnids is None else fnids),
        status=upd(table.status, 0),
    ), ids, ok


def retire(table: SlotTable, ids: torch.Tensor, mask=None,
           statuses=None) -> SlotTable:
    """Release slots; ``statuses`` (optional, aligned with ids) records each
    slot's completion status in the Messages Array's status lane."""
    ok = ids >= 0
    if mask is not None:
        ok = ok & mask
    idx = torch.where(ok, ids, table.active.shape[0])
    status = table.status
    if statuses is not None:
        status = _scatter_drop(status, idx, statuses)
    return dataclasses.replace(table, ring=release(table.ring, ids, mask),
                               active=_scatter_drop(table.active, idx, False),
                               status=status)


def n_active(table: SlotTable) -> torch.Tensor:
    """Slots currently owned (device-side)."""
    return _isum(table.active)


def transact(table: SlotTable, want: torch.Tensor, volumes, queues, step,
             opcodes=None, fnids=None):
    """Admit a batch and immediately retire the admitted slots — the fused
    engine's slot lifecycle: a request is admitted, executed and completed
    inside one step, so its token never outlives the step that acquired it.
    Returns (table', slot_ids, ok)."""
    table, ids, ok = admit(table, want, volumes, queues, step, opcodes,
                           fnids)
    return retire(table, ids, ok), ids, ok
