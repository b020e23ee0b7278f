"""Mirrored checkpoint stores across failure domains (paper §III semantics).

Port of ``repro/checkpoint/replicated.py``. Writes go to every healthy
replica and the save completes only when all acked; restore reads from the
replica with the newest valid version (round-robin among ties); ``rebuild``
restores a lost replica by STREAMING the donor's committed volumes
block-by-block through both stores' public read/write paths
(``repro_torch.durability.export.stream_store`` — the export plane's
chunked FETCH_PAGES/PUSH_PAGES analogue, with transport-style accounting)
— the engine-level replica rebuild, applied to the checkpoint plane. The
last rebuild's traffic is kept on ``last_rebuild``.

With ``mesh=`` (the elastic path, ``store.py``'s note) the replicas are
opened on global rank 0 alone; every rank calls ``save`` (each DTensor
leaf gathered once for all replicas) and ``restore(..., mesh=,
placements=)`` together, and rank 0 picks the replica; rank 0's failure
raises on every rank.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint.store import (CheckpointStore, _agree, _gather,
                                          _is_reader, restore_on_mesh)


class ReplicatedCheckpoint:
    def __init__(self, dirs: List[str], *, capacity_bytes: int = 1 << 30,
                 mesh=None):
        self.paths = [os.path.join(d, "ckpt.dbs") for d in dirs]
        self.capacity = capacity_bytes
        self.stores: List[Optional[CheckpointStore]] = []
        self.reader = mesh is None or _is_reader()
        self.mesh = mesh
        self._rr = 0
        if not self.reader:
            self.stores = [None] * len(self.paths)
            return
        for p in self.paths:
            try:
                self.stores.append(CheckpointStore(
                    p, capacity_bytes=capacity_bytes))
            except Exception:
                self.stores.append(None)

    def healthy(self) -> List[int]:
        return [i for i, s in enumerate(self.stores) if s is not None]

    def save(self, name: str, step: int, tree: Any, keep_last: int = 2):
        """Write-to-all: completes when every healthy replica acked. With
        ``mesh``, rank 0's failure raises on every rank."""
        arrays, treedef = _gather(tree, self.reader)

        def write():
            if not self.healthy():
                raise IOError("no healthy checkpoint replica")
            for i in self.healthy():
                self.stores[i]._write(name, step, arrays, treedef, keep_last)

        if self.mesh is None:
            return write()
        return _agree(write if self.reader else None)

    def restore(self, name: str, like: Any, device=None, *, mesh=None,
                placements=None) -> Tuple[int, Any]:
        """Read from the newest valid replica, round-robin among ties.
        Raises ``IOError`` when no replica holds a valid version (with no
        healthy replica too, where the reference divides by zero). With
        ``mesh`` the leaves come back as DTensors (``store.py``'s note)."""
        if mesh is not None:
            if device is not None:
                raise ValueError("restore takes a device or a mesh, not both")
            return restore_on_mesh(
                (lambda: self._pick(name)._read_valid(name)) if self.reader
                else None, like, mesh, placements)
        return self._pick(name).restore(name, like, device)

    def _pick(self, name: str) -> CheckpointStore:
        best: Tuple[int, int] = (-1, -1)      # (step, idx)
        order = self.healthy()
        if not order:
            raise IOError("no healthy checkpoint replica")
        order = order[self._rr % len(order):] + order[:self._rr % len(order)]
        self._rr += 1
        for i in order:
            try:
                steps = self.stores[i].steps(name)
                if steps and steps[0] > best[0]:
                    best = (steps[0], i)
            except Exception:
                continue
        if best[1] < 0:
            raise IOError(f"no replica holds a valid checkpoint {name!r}")
        return self.stores[best[1]]

    def fail(self, idx: int) -> None:
        """Simulate a node loss: close and drop the replica's device."""
        if self.stores[idx] is not None:
            try:
                self.stores[idx].close()
            except Exception:
                pass
        self.stores[idx] = None
        if os.path.exists(self.paths[idx]):
            os.remove(self.paths[idx])

    def rebuild(self, idx: int) -> Dict[str, Any]:
        """Rebuild a lost replica from the first healthy donor: create a
        FRESH store at the replica's path (``fail`` removed the file) and
        stream every committed checkpoint volume into it through the public
        block paths — no device-file copying. Returns the stream summary
        ({"volumes": {name: blocks}, "counters": ...})."""
        donors = self.healthy()
        if not donors:
            raise IOError("no donor replica")
        from repro_torch.durability.export import stream_store
        donor = self.stores[donors[0]]
        donor.dev.f.flush()
        os.makedirs(os.path.dirname(self.paths[idx]) or ".", exist_ok=True)
        self.stores[idx] = CheckpointStore(self.paths[idx],
                                           capacity_bytes=self.capacity)
        self.last_rebuild = stream_store(donor, self.stores[idx])
        return self.last_rebuild

    def consistent(self) -> bool:
        revs = {self.stores[i].dev.revision for i in self.healthy()}
        return len(revs) <= 1

    def close(self):
        for s in self.stores:
            if s is not None:
                s.close()
