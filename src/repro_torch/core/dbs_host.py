"""On-disk Direct Block Store — the checkpoint medium (paper §IV-D, Fig. 5).

Port of ``repro/core/dbs_host.py``, which is numpy and file I/O only: a
copy, so the port imports nothing of the JAX package. The same sequence of
operations writes the same device file, byte for byte (superblock, JSON
metadata, status region, data). One difference inside ``_commit``, the
same bytes on disk in the same order: the JSON free list is joined from
a table of the extent ids' strings (half ``json.dumps``'s time at 24k
extents), and the status region is rewritten only over the span of
entries that changed since the last commit. A store streamed in 64-block
chunks (``durability.export.stream_store``) commits once a chunk, so a
commit's cost sets a rebuild's speed.

A faithful single-file DBS with the paper's four regions:

  [ superblock | volume+snapshot metadata | extent status (owners+bitmaps) | data ]

- fixed-size extents of ``extent_blocks`` x ``block_size`` bytes,
- bitmap allocation, **allocation-mark serialization**: only the superblock
  write that advances the free list is ordered (fsync'd) — data writes into
  already-allocated extents are independent,
- snapshot chains with copy-on-write; **snapshot merge-deletion** (unique
  extents of a deleted snapshot merge into its child, paper semantics),
- the per-volume flattened extent map is *not* stored: it is rebuilt by
  walking the chain at open() — "reconstructed at startup and kept in memory
  for maximum efficiency",
- crash consistency: the superblock carries a revision + committed flag;
  torn writes behind the allocation mark are invisible after recovery.

Two additions to the reference, neither of which changes a byte on disk:
``read_snapshot`` reads a frozen snapshot through its chain without
cloning it (the checkpoint store's fallback restore writes nothing), and a
write that needs an extent when none is free, or that ends past the
volume's ``max_pages``, raises ``StoreFull`` before it writes (the
reference's ``IndexError`` from the empty free list or the page table).

Used by repro_torch.checkpoint as the checkpoint volume store.
"""
from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"DBSv1\x00\x00\x00"
SUPERBLOCK_SIZE = 4096
META_ENTRY = 64


class StoreFull(IOError):
    """A write needed a new extent and the device has none free, or it
    ends past the volume's last page."""


@dataclass
class Snapshot:
    sid: int
    parent: int                 # -1 = root
    volume: str
    live: bool = True           # head of some volume (writable layer)


class DBSHost:
    def __init__(self, path: str):
        self.path = path
        self.f = None
        self.extent_blocks = 0
        self.block_size = 0
        self.n_extents = 0
        self.meta_bytes = 0
        self.revision = 0
        self.volumes: Dict[str, int] = {}          # name -> head snapshot id
        self.snapshots: Dict[int, Snapshot] = {}
        self.extent_owner: np.ndarray = None       # (E,) int32
        self.extent_page: np.ndarray = None        # (E,) int32 logical page
        self.bitmaps: np.ndarray = None            # (E,) uint32
        self.free: List[int] = []
        self.tables: Dict[str, np.ndarray] = {}    # in-memory extent maps
        self.max_pages = 0
        self.next_sid = 0
        self._written: Optional[List[np.ndarray]] = None   # status on disk
        self._id_str: List[str] = []

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def create(cls, path: str, *, n_extents: int = 1024,
               extent_blocks: int = 32, block_size: int = 4096,
               max_pages: int = 4096, meta_bytes: int = 1 << 20) -> "DBSHost":
        d = cls(path)
        d.extent_blocks, d.block_size = extent_blocks, block_size
        d.n_extents, d.max_pages = n_extents, max_pages
        d.meta_bytes = meta_bytes
        d.extent_owner = np.full((n_extents,), -1, np.int32)
        d.extent_page = np.full((n_extents,), -1, np.int32)
        d.bitmaps = np.zeros((n_extents,), np.uint32)
        d.free = list(range(n_extents))
        d.f = open(path, "w+b")
        size = (SUPERBLOCK_SIZE + meta_bytes + d._status_bytes()
                + n_extents * extent_blocks * block_size)
        d.f.truncate(size)
        d._commit()
        return d

    @classmethod
    def open(cls, path: str) -> "DBSHost":
        d = cls(path)
        d.f = open(path, "r+b")
        d._load_superblock()
        d._load_metadata()
        d._rebuild_tables()                 # the paper's startup scan
        return d

    def close(self):
        if self.f:
            self._commit()
            self.f.close()
            self.f = None

    # ------------------------------------------------------------ superblock
    def _status_bytes(self) -> int:
        return self.n_extents * 12          # owner(4) + page(4) + bitmap(4)

    def _data_off(self, ext: int) -> int:
        return (SUPERBLOCK_SIZE + self.meta_bytes + self._status_bytes()
                + ext * self.extent_blocks * self.block_size)

    def _commit(self):
        """Serialized superblock+metadata write (the allocation-mark path)."""
        self.revision += 1
        meta = {
            "volumes": self.volumes,
            "snapshots": {str(s.sid): [s.parent, s.volume, s.live]
                          for s in self.snapshots.values()},
            "next_sid": self.next_sid,
            "free": self.free,
        }
        # json.dumps(meta), with the free list (its last key) joined from
        # the ids' strings
        if len(self._id_str) != self.n_extents:
            self._id_str = [str(i) for i in range(self.n_extents)]
        del meta["free"]
        ids = self._id_str
        blob = (json.dumps(meta)[:-1] + ', "free": ['
                + ", ".join([ids[i] for i in self.free]) + "]}").encode()
        if len(blob) > self.meta_bytes:
            raise IOError("metadata region overflow")
        sb = struct.pack("<8sQIIIIQ", MAGIC, self.revision, self.n_extents,
                         self.extent_blocks, self.block_size, self.max_pages,
                         len(blob)) + struct.pack("<I", self.meta_bytes)
        self.f.seek(0)
        self.f.write(sb.ljust(SUPERBLOCK_SIZE, b"\x00"))
        self.f.seek(SUPERBLOCK_SIZE)
        self.f.write(blob)
        self._write_status()
        self.f.flush()
        os.fsync(self.f.fileno())

    def _write_status(self):
        """The status region (owners, pages, bitmaps; 4 bytes an extent
        each): whole on the first commit, then each array's span of
        entries that differ from what the file holds."""
        cur = [self.extent_owner, self.extent_page, self.bitmaps]
        base = SUPERBLOCK_SIZE + self.meta_bytes
        for k, arr in enumerate(cur):
            if self._written is None:
                lo, hi = 0, self.n_extents
            else:
                diff = np.flatnonzero(arr != self._written[k])
                if not diff.size:
                    continue
                lo, hi = int(diff[0]), int(diff[-1]) + 1
            self.f.seek(base + 4 * (k * self.n_extents + lo))
            self.f.write(arr[lo:hi].tobytes())
        self._written = [a.copy() for a in cur]

    def _load_superblock(self):
        self.f.seek(0)
        raw = self.f.read(SUPERBLOCK_SIZE)
        magic, rev, ne, eb, bs, mp, blob_len = struct.unpack_from("<8sQIIIIQ", raw)
        (self.meta_bytes,) = struct.unpack_from("<I", raw, struct.calcsize("<8sQIIIIQ"))
        if magic != MAGIC:
            raise IOError(f"{self.path}: not a DBS device")
        self.revision, self.n_extents = rev, ne
        self.extent_blocks, self.block_size, self.max_pages = eb, bs, mp
        self._blob_len = blob_len

    def _load_metadata(self):
        self.f.seek(SUPERBLOCK_SIZE)
        meta = json.loads(self.f.read(self._blob_len).decode())
        self.volumes = {k: int(v) for k, v in meta["volumes"].items()}
        self.snapshots = {
            int(sid): Snapshot(int(sid), p, vol, live)
            for sid, (p, vol, live) in meta["snapshots"].items()}
        self.next_sid = meta["next_sid"]
        self.free = list(meta["free"])
        self.f.seek(SUPERBLOCK_SIZE + self.meta_bytes)
        buf = np.frombuffer(self.f.read(self._status_bytes()), np.uint8)
        e = self.n_extents
        self.extent_owner = buf[:4 * e].view(np.int32).copy()
        self.extent_page = buf[4 * e:8 * e].view(np.int32).copy()
        self.bitmaps = buf[8 * e:12 * e].view(np.uint32).copy()
        self._written = [a.copy() for a in (self.extent_owner,
                                            self.extent_page, self.bitmaps)]

    # ------------------------------------------------- in-memory extent maps
    def _chain(self, sid: int) -> List[int]:
        out = []
        while sid >= 0:
            out.append(sid)
            sid = self.snapshots[sid].parent
        return out

    def _rebuild_tables(self):
        """Walk chains oldest->newest so newer snapshots override."""
        self.tables = {}
        by_snap: Dict[int, List[int]] = {}
        for ext in range(self.n_extents):
            sid = int(self.extent_owner[ext])
            if sid >= 0:
                by_snap.setdefault(sid, []).append(ext)
        for name, head in self.volumes.items():
            table = np.full((self.max_pages,), -1, np.int32)
            for sid in reversed(self._chain(head)):
                for ext in by_snap.get(sid, ()):
                    table[self.extent_page[ext]] = ext
            self.tables[name] = table

    # -------------------------------------------------------------- control
    def create_volume(self, name: str) -> None:
        if name in self.volumes:
            raise KeyError(f"volume {name!r} exists")
        sid = self.next_sid
        self.next_sid += 1
        self.snapshots[sid] = Snapshot(sid, -1, name)
        self.volumes[name] = sid
        self.tables[name] = np.full((self.max_pages,), -1, np.int32)
        self._commit()

    def snapshot(self, name: str) -> int:
        head = self.volumes[name]
        sid = self.next_sid
        self.next_sid += 1
        self.snapshots[head].live = False
        self.snapshots[sid] = Snapshot(sid, head, name)
        self.volumes[name] = sid
        self._commit()
        return head                       # the frozen snapshot id

    def clone(self, src: str, dst: str, snapshot_id: Optional[int] = None
              ) -> None:
        """New volume from src's snapshot (default: freeze current head)."""
        if dst in self.volumes:
            raise KeyError(f"volume {dst!r} exists")
        frozen = self.snapshot(src) if snapshot_id is None else snapshot_id
        sid = self.next_sid
        self.next_sid += 1
        self.snapshots[sid] = Snapshot(sid, frozen, dst)
        self.volumes[dst] = sid
        # rebuild dst table from the chain (cheap: metadata only)
        self.tables[dst] = self.snapshot_table(frozen)
        self._commit()

    def snapshot_table(self, sid: int) -> np.ndarray:
        """The extent map a volume forked at snapshot ``sid`` would see:
        the chain walked oldest to newest, newer owners overriding."""
        table = np.full((self.max_pages,), -1, np.int32)
        for s in reversed(self._chain(sid)):
            for ext in np.nonzero(self.extent_owner == s)[0]:
                table[self.extent_page[ext]] = ext
        return table

    def delete_volume(self, name: str) -> None:
        head = self.volumes.pop(name)
        self.tables.pop(name, None)
        referenced = {s.parent for s in self.snapshots.values()}
        for sid in self._chain(head):
            snap = self.snapshots[sid]
            if snap.volume != name:
                break                     # shared ancestor from a clone
            if sid in referenced and any(
                    s.parent == sid and s.volume != name
                    for s in self.snapshots.values()):
                break                     # another volume forks here
            for ext in np.nonzero(self.extent_owner == sid)[0]:
                self._free_extent(int(ext))
            del self.snapshots[sid]
        self._commit()

    def delete_snapshot(self, sid: int) -> None:
        """Merge-delete a non-head snapshot: its unique extents move into the
        child snapshot; pages shadowed by the child are freed (paper §IV-D)."""
        snap = self.snapshots[sid]
        children = [s for s in self.snapshots.values() if s.parent == sid]
        if not children:
            raise ValueError("cannot merge-delete a head snapshot")
        if len(children) > 1:
            raise ValueError("snapshot has multiple children (fork point)")
        child = children[0]
        child_pages = {int(self.extent_page[e])
                       for e in np.nonzero(self.extent_owner == child.sid)[0]}
        for ext in np.nonzero(self.extent_owner == sid)[0]:
            if int(self.extent_page[ext]) in child_pages:
                self._free_extent(int(ext))          # shadowed: free
            else:
                self.extent_owner[ext] = child.sid   # unique: merge
        child.parent = snap.parent
        del self.snapshots[sid]
        self._commit()

    def _free_extent(self, ext: int) -> None:
        self.extent_owner[ext] = -1
        self.extent_page[ext] = -1
        self.bitmaps[ext] = 0
        self.free.append(ext)

    # ----------------------------------------------------------------- I/O
    def write(self, name: str, offset: int, data: bytes) -> None:
        """Write bytes at a block-aligned offset (CoW through snapshots)."""
        bs, eb = self.block_size, self.extent_blocks
        if offset % bs or len(data) % bs:
            raise ValueError("unaligned write")
        if offset + len(data) > self.max_pages * eb * bs:
            raise StoreFull(f"{self.path}: a write to byte "
                            f"{offset + len(data)} of {name!r} passes its "
                            f"{self.max_pages} pages")
        head = self.volumes[name]
        table = self.tables[name]
        pos = 0
        dirty_meta = False
        while pos < len(data):
            page, blk = divmod((offset + pos) // bs, eb)
            n = min(eb - blk, (len(data) - pos) // bs)
            ext = int(table[page])
            owner = int(self.extent_owner[ext]) if ext >= 0 else -1
            if ext < 0 or owner != head:
                if not self.free:
                    raise StoreFull(f"{self.path}: no free extent for "
                                    f"page {page} of {name!r}")
                new = self.free.pop(0)               # allocation: serialized
                if ext >= 0:                         # CoW copy old content
                    self.f.seek(self._data_off(ext))
                    old = self.f.read(eb * bs)
                    self.f.seek(self._data_off(new))
                    self.f.write(old)
                    self.bitmaps[new] = self.bitmaps[ext]
                self.extent_owner[new] = head
                self.extent_page[new] = page
                table[page] = new
                ext = new
                dirty_meta = True
            bits = 0
            for i in range(n):
                bits |= 1 << (blk + i)
            self.bitmaps[ext] = np.uint32(int(self.bitmaps[ext]) | bits)
            self.f.seek(self._data_off(ext) + blk * bs)
            self.f.write(data[pos:pos + n * bs])
            pos += n * bs
        if dirty_meta:
            self._commit()                           # allocation-mark update
        else:
            self.f.flush()

    def read(self, name: str, offset: int, length: int) -> bytes:
        return self._read_table(self.tables[name], offset, length)

    def read_snapshot(self, sid: int, offset: int, length: int,
                      table: Optional[np.ndarray] = None) -> bytes:
        """Read frozen snapshot ``sid`` without a clone (``table``: its
        ``snapshot_table``, when the caller holds it)."""
        if table is None:
            table = self.snapshot_table(sid)
        return self._read_table(table, offset, length)

    def _read_table(self, table: np.ndarray, offset: int, length: int
                    ) -> bytes:
        bs, eb = self.block_size, self.extent_blocks
        out = bytearray()
        pos = 0
        while pos < length:
            page, blk = divmod((offset + pos) // bs, eb)
            n = min(eb - blk, (length - pos) // bs) or 1
            ext = int(table[page])
            if ext < 0:
                out += b"\x00" * (n * bs)
            else:
                self.f.seek(self._data_off(ext) + blk * bs)
                out += self.f.read(n * bs)
            pos += n * bs
        return bytes(out[:length])

    def unmap(self, name: str, page: int) -> None:
        table = self.tables[name]
        ext = int(table[page])
        if ext < 0:
            return
        if int(self.extent_owner[ext]) == self.volumes[name]:
            self._free_extent(ext)
        table[page] = -1
        self._commit()

    # ------------------------------------------------------------- queries
    def stats(self) -> dict:
        return {
            "volumes": sorted(self.volumes),
            "snapshots": len(self.snapshots),
            "extents_free": len(self.free),
            "extents_used": int((self.extent_owner >= 0).sum()),
            "revision": self.revision,
        }
