"""Cold-extent spill tier for the fused engine (durability pillar 4).

Port of ``repro/durability/tier.py``. The DBS extent pool is sized at
config time and every extent is device-resident, so capacity is bounded by
device memory. ``ExtentTier`` turns the pool into a HOT SET: a bounded
number of extents stay device-resident, cold extents spill to host memory,
and spilled extents fault back in when a batch touches them. The
invariants:

- **The hot path stays one step per pump.** The fused step gains one
  extra operand, ``stamps``, an ``(E+1,)`` int32 of per-extent access
  ticks, and stamps every extent a batch resolves (reads, write
  destinations AND CoW sources) with the batch step inside the step
  (core/fused.py ``_stamp_tier``). All spill/fill traffic rides the pump
  boundary in host code.
- **Fill before, balance after.** Before a pump the tier resolves the
  batch's (volume, page) lanes against a host copy of replica 0's table
  ONCE, and faults every spilled extent the batch needs back in with one
  ``index_copy_`` per replica pool, in place (the pools the write kernel
  updates in place). After the pump, if the resident set exceeds the
  budget, a clock/second-chance sweep over the stamps picks victims: the
  first pass spares extents whose stamp advanced since the hand last saw
  them, the second evicts unconditionally. Victim rows are gathered once
  (write="all" keeps replicas identical, so ONE host copy serves them
  all) and the device rows are zeroed.
- **Spilled rows live in pinned host memory** on a CUDA device. The spill
  copy (device -> pinned) and the fill copies (pinned -> device) are
  non-blocking and stream-ordered: a fill enqueued after a spill reads the
  rows the spill wrote, and zeroing a victim's device row is ordered after
  its copy out. The host waits on one event, the last spill's, only where
  it reads the spilled bytes itself (``spilled_rows``).
- **Zeroing spilled rows is safe.** DBS never zeroes freshly allocated
  extents: a fresh allocation inherits whatever bytes the pool row holds,
  and every byte a volume can read through a live mapping was either
  written (faulted in before the write's CoW copy runs) or is a hole
  (masked to zeros on read). A freed-then-spilled-then-reallocated extent
  therefore reads zeros, matching the zero-filled oracle.

Enabled with ``EngineConfig(tier=N)`` (or ``tier=dict(device_extents=N)``)
on the fused engine; ``export.SnapshotExport`` overlays the tier's
``spilled_rows`` on the rows it gathers, so exports see spilled bytes.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch


class ExtentTier:
    """Host-side state of the spill tier: which extents are device-resident,
    the spilled rows, and the clock hand (module docstring). ``device`` is
    where the stamps live (the engine's device)."""

    def __init__(self, n_extents: int, device_extents: int, *,
                 device="cpu"):
        if not 0 < device_extents:
            raise ValueError(f"device_extents must be positive, got "
                             f"{device_extents}")
        self.n_extents = int(n_extents)
        self.device_extents = int(min(device_extents, n_extents))
        self.device = torch.device(device)
        # stamps[e] = step of the last batch that resolved extent e; row E
        # is the dump slot for the fused step's invalid-lane scatter.
        self.stamps = torch.zeros((self.n_extents + 1,), dtype=torch.int32,
                                  device=self.device)
        self.resident = np.ones(self.n_extents, bool)
        self.spilled: Dict[int, torch.Tensor] = {}   # host rows
        self._mapped = np.zeros(self.n_extents, bool)
        self._hand = 0
        self._seen = np.zeros(self.n_extents, np.int64)
        self._spill_done: Optional[torch.cuda.Event] = None
        self.fills = 0             # fault-in batches
        self.spills = 0            # eviction sweeps
        self.extents_filled = 0
        self.extents_spilled = 0
        self.bytes_filled = 0      # host -> device
        self.bytes_spilled = 0     # device -> host

    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    # ------------------------------------------------------------- pump hooks
    def fault_in(self, table_host: np.ndarray, reqs,
                 pools: Tuple[torch.Tensor, ...]
                 ) -> Tuple[Tuple[torch.Tensor, ...], set]:
        """Pre-pump fill: resolve the batch's (volume, page) lanes against
        the host copy of replica 0's table and fault every spilled extent
        back in with one ``index_copy_`` per replica pool, in place.
        Returns the pools and the set of extents the batch touches.

        Also reconciles the spill set against the table: only MAPPED extents
        are ever evicted (below), so the allocator only hands out extents
        whose device rows are live; but an extent can be freed *after*
        spilling (unmap / delete / CoW superseding it). Its content is dead
        to the data plane the moment it leaves the table, and its device row
        was zeroed at eviction (exactly the content a fresh allocation is
        supposed to inherit), so the stale spilled copy is dropped and the
        row counts as resident again. Without this, a reallocation of a
        spilled-then-freed extent would later fault stale bytes in over
        freshly written data."""
        self._mapped = np.zeros(self.n_extents, bool)
        self._mapped[table_host[table_host >= 0]] = True
        for e in [e for e in self.spilled if not self._mapped[e]]:
            del self.spilled[e]
            self.resident[e] = True
        nv, npg = table_host.shape
        need = set()
        for r in reqs:
            if 0 <= r.volume < nv and 0 <= r.page < npg:
                e = int(table_host[r.volume, r.page])
                if e >= 0:
                    need.add(e)
        fill = sorted(e for e in need if not self.resident[e])
        if fill:
            like = pools[0]
            rows = torch.empty((len(fill),) + tuple(like.shape[1:]),
                               dtype=like.dtype, device=like.device)
            for j, e in enumerate(fill):     # stream-ordered after the spill
                rows[j].copy_(self.spilled.pop(e), non_blocking=True)
            idx = torch.tensor(fill, dtype=torch.int64).to(
                like.device, non_blocking=True)
            for p in pools:
                p.index_copy_(0, idx, rows)
            for e in fill:
                self.resident[e] = True
            self.fills += 1
            self.extents_filled += len(fill)
            self.bytes_filled += rows.numel() * rows.element_size()
        return pools, need

    def balance(self, pools: Tuple[torch.Tensor, ...],
                protect: Iterable[int] = ()) -> Tuple[torch.Tensor, ...]:
        """Post-pump eviction: while the MAPPED resident set exceeds the
        budget, sweep the clock hand over the stamps: the first full pass
        gives a second chance to any extent whose stamp advanced since the
        hand last passed it, the second pass evicts unconditionally. Only
        extents the table maps are candidates (a free extent holds no live
        bytes and may be handed out by the allocator any pump; see
        ``fault_in``); extents in ``protect`` (this batch's working set) are
        never evicted. The pools are updated in place."""
        mapped = self._mapped
        over = int((self.resident & mapped).sum()) - self.device_extents
        if over <= 0:
            return pools
        stamps = self.stamps[:self.n_extents].cpu().numpy()
        victims = self._sweep(stamps, mapped, protect, over)
        if not victims:
            return pools
        like = pools[0]
        idx = torch.tensor(victims, dtype=torch.int64).to(like.device,
                                                          non_blocking=True)
        # write="all" keeps replica pools identical: one host copy serves all
        rows = like.index_select(0, idx)
        if self._cuda:
            host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            host.copy_(rows, non_blocking=True)
            self._spill_done = torch.cuda.Event()
            self._spill_done.record()
        else:
            host = rows
        for j, e in enumerate(victims):
            self.spilled[e] = host[j]
            self.resident[e] = False
        for p in pools:
            p.index_fill_(0, idx, 0.0)
        self.spills += 1
        self.extents_spilled += len(victims)
        self.bytes_spilled += rows.numel() * rows.element_size()
        return pools

    def _sweep(self, stamps: np.ndarray, mapped: np.ndarray,
               protect: Iterable[int], over: int) -> list:
        """The reference's two-pass clock sweep, one extent at a time in
        its loop, here on whole arrays with the same outcome: the same
        victims in the same order, the same ``_seen`` marks and the same
        hand. The hand visits the eligible extents (resident, mapped, not
        protected) in order from where it stands; the first pass takes
        those whose stamp has not advanced past their mark and marks every
        extent it visits; if that does not give ``over`` victims the
        second pass, from the same start, takes the rest in order. The
        hand stops just past the last victim, or where it started if the
        victims ran out."""
        n, h0 = self.n_extents, self._hand
        elig = self.resident & mapped
        shield = [e for e in protect if 0 <= e < n]
        if shield:
            elig = elig.copy()
            elig[shield] = False
        order = np.roll(np.arange(n), -h0)
        cand = order[elig[order]]               # eligible, in hand order
        fresh = stamps[cand] <= self._seen[cand]
        hits = np.flatnonzero(fresh)
        if hits.size >= over:                   # the first pass suffices
            last = int(hits[over - 1])
            visited = cand[:last + 1]
            self._seen[visited] = stamps[visited]
            self._hand = (int(cand[last]) + 1) % n
            return [int(e) for e in cand[hits[:over]]]
        self._seen[cand] = stamps[cand]         # a whole first pass
        need = over - hits.size
        rest = cand[~fresh][:need]
        self._hand = (int(rest[-1]) + 1) % n if rest.size == need else h0
        return [int(e) for e in cand[hits]] + [int(e) for e in rest]

    # ------------------------------------------------------------- side doors
    def spilled_rows(self, extents) -> Dict[int, torch.Tensor]:
        """The host rows of those ``extents`` that are spilled, readable on
        the host (waits on the last spill's copy): the bytes the device
        rows, zeroed at eviction, do not hold."""
        hit = {int(e): self.spilled[int(e)] for e in extents
               if int(e) in self.spilled}
        if hit and self._spill_done is not None:
            self._spill_done.synchronize()
        return hit

    def reset_resident(self) -> None:
        """Forget all tier state (export install replaced the pools whole);
        the next balance() re-evicts if the budget is exceeded."""
        self.resident[:] = True
        self.spilled.clear()
        self._mapped[:] = False
        self._seen[:] = 0
        self._hand = 0
        self.stamps = torch.zeros((self.n_extents + 1,), dtype=torch.int32,
                                  device=self.device)

    def to_dict(self) -> dict:
        return {
            "device_extents": self.device_extents,
            "resident": int((self.resident & self._mapped).sum()),
            "spilled": len(self.spilled),
            "fills": self.fills, "spills": self.spills,
            "extents_filled": self.extents_filled,
            "extents_spilled": self.extents_spilled,
            "bytes_filled": self.bytes_filled,
            "bytes_spilled": self.bytes_spilled,
        }

    def __repr__(self):
        return (f"ExtentTier(budget={self.device_extents}, "
                f"resident={int(self.resident.sum())}, "
                f"spilled={len(self.spilled)})")


def as_tier(tier, n_extents: int, device="cpu"):
    """Coerce an ``EngineConfig(tier=...)`` value: None | int budget |
    dict(device_extents=...) | ExtentTier."""
    if tier is None or isinstance(tier, ExtentTier):
        return tier
    if isinstance(tier, dict):
        return ExtentTier(n_extents, int(tier["device_extents"]),
                          device=device)
    return ExtentTier(n_extents, int(tier), device=device)
