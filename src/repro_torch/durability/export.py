"""Incremental snapshot export on the ``page_rev`` watermarks (pillar 3).

Port of ``repro/durability/export.py``. The file is the reference's: the
same framing, the replica state leaves in the reference's leaf order and
dtypes (the block bitmap, int64 in the port, goes on disk as uint32), so
either package installs the other's sections. Only the copies across the
bus differ: an export gathers the delta rows on the device and fetches
those alone, then overlays the spill tier's rows; an install zero-fills
the device pools and ``index_copy_``s each section's rows into them.

A ``SnapshotExport`` is one versioned on-disk file of append-only
*sections*. Each ``export(mgr)`` call ships

- the full (small) metadata: the replica ``DBSState`` leaves, the volume
  table, the ``page_rev`` watermark array and the manager's open volume
  ids — a section is self-describing for control state, and
- ONLY the delta of the (large) payload pool: the extents backing pages
  whose ``page_rev`` is newer than the *previous section's* watermark row —
  exactly the selection the streamed delta rebuild computes
  (``transport._delta_extents``: ``np.unique`` of
  ``table[(page_rev > target) & (table >= 0)]``).

Content an extent carried at an older watermark was shipped by the section
that covered that watermark, so replaying the sections in order (later
rows win) reconstructs every live extent; freed-but-unshipped extents
restore as zeros, which is what the hole-masked read path serves anyway.

**Commit ordering** mirrors the reference's checkpoint/store.py: section
bytes are appended and flushed FIRST, then the fixed-size file header
(which holds the committed section count) is rewritten — a torn append
leaves the header pointing at the old, consistent prefix.

``ExportCounters`` mirrors the transport counters (``ReplicaTransport``'s
``sent`` / ``pages_moved``) so tests assert "this export moved exactly the
post-watermark extents" the same way the rebuild tests assert streamed
page counts.

``stream_store`` is the checkpoint replica rebuild over this surface
(``checkpoint/replicated.py``): it streams a donor ``CheckpointStore``'s
committed volumes into a target store through both stores' block paths,
with the same counters as the reference's.
"""
from __future__ import annotations

import collections
import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.compute.functions import np_blocksum

_FILE_MAGIC = b"DBSXPRT1"
_HEADER_BYTES = 512              # fixed header block, rewritten last
_SEC_MAGIC = 0x54435853          # "SXCT"
_FRAME = struct.Struct("<II")    # magic, body_len
_SUM = struct.Struct("<i")


class ExportCounters:
    """Transport-style accounting for the export plane: one ``sent``
    counter per verb plus the extents/bytes actually moved."""

    def __init__(self):
        self.sent = collections.Counter()    # EXPORT / INSTALL / STREAM
        self.extents_moved = 0               # delta extents shipped
        self.pages_moved = 0                 # == extents_moved (one page per
                                             # extent — transport naming)
        self.bytes_moved = 0

    def account(self, verb: str, extents: int, nbytes: int) -> None:
        self.sent[verb] += 1
        self.extents_moved += extents
        self.pages_moved += extents
        self.bytes_moved += nbytes

    def to_dict(self) -> Dict[str, Any]:
        return {"sent": dict(self.sent), "extents_moved": self.extents_moved,
                "pages_moved": self.pages_moved,
                "bytes_moved": self.bytes_moved}


def _pack_section(scalars: Dict[str, Any],
                  arrays: Dict[str, np.ndarray]) -> bytes:
    """One checksummed section frame: json meta + concatenated raw arrays."""
    metas, blobs, off = [], [], 0
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        raw = arr.tobytes()
        metas.append({"name": name, "dtype": str(arr.dtype),
                      "shape": list(arr.shape), "offset": off,
                      "nbytes": len(raw)})
        blobs.append(raw)
        off += len(raw)
    head = json.dumps({"scalars": scalars, "arrays": metas}).encode()
    body = struct.pack("<I", len(head)) + head + b"".join(blobs)
    return _FRAME.pack(_SEC_MAGIC, len(body)) + body + _SUM.pack(
        np_blocksum(body))


def _unpack_section(body: bytes) -> Tuple[Dict[str, Any],
                                          Dict[str, np.ndarray]]:
    (hlen, ) = struct.unpack_from("<I", body, 0)
    meta = json.loads(body[4:4 + hlen])
    base = 4 + hlen
    arrays = {}
    for ent in meta["arrays"]:
        off = base + ent["offset"]
        arr = np.frombuffer(body, np.dtype(ent["dtype"]),
                            count=int(np.prod(ent["shape"], dtype=np.int64))
                            if ent["shape"] else 1,
                            offset=off)
        arrays[ent["name"]] = arr.reshape(ent["shape"]).copy()
    return meta["scalars"], arrays


def _flat_group(mgr):
    """The flat ``ReplicaGroup`` behind a slots/loop/fused manager — the
    backends whose device state installs wholesale. Raises on the rest
    (host/sharded/ring recover via full-journal replay instead)."""
    storage = mgr.engine.backend
    if (storage is None or not hasattr(storage, "device_page_revs")
            or hasattr(storage, "states")):       # sharded: stacked axis
        raise ValueError(
            f"backend {mgr.backend_name!r} has no installable flat replica "
            "plane; recovery falls back to full-journal replay")
    if getattr(storage, "null_storage", False):
        raise ValueError("null_storage holds no pool to export")
    return storage


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _state_leaves(state) -> List[np.ndarray]:
    """A replica ``DBSState``'s leaves as host numpy, in the reference's
    leaf order and dtypes (the bitmap as uint32)."""
    return [leaf.cpu().numpy().astype(np.uint32) if leaf is state.bitmap
            else leaf.cpu().numpy() for leaf in pytree.tree_leaves(state)]


class SnapshotExport:
    """One versioned incremental-export file (module docstring)."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self.counters = ExportCounters()
        self._sections: List[Tuple[Dict[str, Any],
                                   Dict[str, np.ndarray]]] = []
        if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
            self._load()

    # ------------------------------------------------------------ file I/O
    def _load(self) -> None:
        with open(self.path, "rb") as f:
            blob = f.read()
        if blob[:len(_FILE_MAGIC)] != _FILE_MAGIC:
            raise IOError(f"{self.path}: not an export file")
        hdr = json.loads(
            blob[len(_FILE_MAGIC):_HEADER_BYTES].split(b"\x00")[0])
        off = _HEADER_BYTES
        self._sections = []
        for _ in range(hdr["sections"]):          # only the committed count
            magic, blen = _FRAME.unpack_from(blob, off)
            end = off + _FRAME.size + blen + _SUM.size
            if magic != _SEC_MAGIC or end > len(blob):
                raise IOError(f"{self.path}: committed section torn")
            body = blob[off + _FRAME.size:end - _SUM.size]
            (want, ) = _SUM.unpack_from(blob, end - _SUM.size)
            if np_blocksum(body) != want:
                raise IOError(f"{self.path}: committed section checksum "
                              "mismatch")
            self._sections.append(_unpack_section(body))
            off = end

    def _commit(self, frame: bytes) -> None:
        """Append the section, flush, THEN rewrite the header: the torn-
        append-safe ordering (a crash between the two keeps the old count)."""
        new = not os.path.exists(self.path) or os.path.getsize(self.path) == 0
        mode = "r+b" if not new else "wb"
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, mode) as f:
            if new:
                f.write(_FILE_MAGIC.ljust(_HEADER_BYTES, b"\x00"))
            f.seek(0, os.SEEK_END)
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
            hdr = json.dumps({"sections": len(self._sections)}).encode()
            f.seek(0)
            f.write((_FILE_MAGIC + hdr).ljust(_HEADER_BYTES, b"\x00"))
            f.flush()
            os.fsync(f.fileno())

    # ------------------------------------------------------------ export
    @property
    def sections(self) -> int:
        return len(self._sections)

    @property
    def journal_seq(self) -> int:
        """Journal position the newest section covers (0 = none): recovery
        replays only records sealed after this."""
        return (int(self._sections[-1][0]["journal_seq"])
                if self._sections else 0)

    def _last_watermark(self) -> Optional[np.ndarray]:
        return (self._sections[-1][1]["page_rev"]
                if self._sections else None)

    def export(self, mgr, *, journal=None) -> Dict[str, Any]:
        """Ship one incremental section from a flat-replica-plane manager.
        Flushes first (the section covers every acked op), selects the
        post-watermark extents, appends, commits. Returns the section
        summary (``extents_moved`` is THE exactness assertion handle;
        ``bytes_copied`` counts what came off the device: the metadata and
        the delta rows)."""
        mgr.flush()
        storage = _flat_group(mgr)
        rep = storage.replicas[storage.healthy_indices()[0]]
        leaves = _state_leaves(rep.state)
        table = rep.state.table.cpu().numpy()
        page_rev = rep.page_rev.cpu().numpy()
        last = self._last_watermark()
        target = (np.zeros_like(page_rev) if last is None else last)
        newer = (page_rev > target) & (table >= 0)
        delta = np.unique(table[newer]).astype(np.int32)
        rows = self._delta_rows(mgr, rep.pool, delta)
        scalars = {
            "journal_seq": int(journal.seq) if journal is not None else 0,
            "version": len(self._sections) + 1,
            "vids": sorted(int(v) for v in mgr.volumes),
            "pool_rows": int(rep.pool.shape[0]),
        }
        arrays = {"page_rev": page_rev, "delta_extents": delta,
                  "delta_rows": rows}
        for i, leaf in enumerate(leaves):
            arrays[f"state_{i}"] = leaf
        frame = _pack_section(scalars, arrays)
        self._sections.append((scalars, arrays))
        self._commit(frame)
        self.counters.account("EXPORT", int(delta.size), rows.nbytes)
        return {"version": scalars["version"],
                "extents_moved": int(delta.size),
                "bytes_moved": int(rows.nbytes),
                "bytes_copied": int(rows.nbytes + page_rev.nbytes
                                    + sum(x.nbytes for x in leaves)),
                "journal_seq": scalars["journal_seq"]}

    @staticmethod
    def _delta_rows(mgr, pool: torch.Tensor, delta: np.ndarray) -> np.ndarray:
        """The pool rows of ``delta`` as host numpy: gathered on the device
        and fetched alone. On a tiered fused backend the spilled rows are
        zeros ON DEVICE; their bytes live in the tier's host store, which
        is overlaid."""
        if not delta.size:
            return np.zeros((0,) + tuple(pool.shape[1:]), np.float32)
        idx = torch.from_numpy(delta.astype(np.int64)).to(pool.device)
        rows = pool.index_select(0, idx).cpu().numpy()
        tier = getattr(mgr.engine.impl, "tier", None)
        if tier is not None:
            pos = {int(e): j for j, e in enumerate(delta)}
            for e, row in tier.spilled_rows(delta).items():
                rows[pos[e]] = row.numpy()
        return rows

    # ------------------------------------------------------------ install
    def install(self, mgr) -> Dict[str, Any]:
        """Reconstruct device state on a FRESH manager of the same geometry:
        metadata from the newest section, pool rows replayed section-by-
        section (later rows win) into every healthy replica's zero-filled
        pool, in place."""
        if not self._sections:
            raise ValueError(f"{self.path}: no committed section to install")
        storage = _flat_group(mgr)
        idx = storage.healthy_indices()
        rep0 = storage.replicas[idx[0]]
        cur_leaves, spec = pytree.tree_flatten(rep0.state)
        scalars, arrays = self._sections[-1]
        leaves_np = []
        for i, like in enumerate(cur_leaves):
            got = arrays[f"state_{i}"]
            # compare sizes, not shapes: scalar leaves are () or (1,)
            # depending on the path that last wrote them
            if got.size != like.numel():
                raise ValueError(
                    f"export geometry mismatch: state leaf {i} is "
                    f"{tuple(got.shape)} on disk, {tuple(like.shape)} here")
            leaves_np.append(got.astype(_np_dtype(like)).reshape(
                tuple(like.shape)))
        pools = tuple(storage.replicas[i].pool for i in idx)
        row_shape = tuple(rep0.pool.shape[1:])
        if int(scalars["pool_rows"]) != rep0.pool.shape[0] or any(
                tuple(ar["delta_rows"].shape[1:]) != row_shape
                for _, ar in self._sections if ar["delta_extents"].size):
            raise ValueError("export geometry mismatch: pool rows")
        dev = rep0.pool.device
        for p in pools:
            p.zero_()
        moved = copied = 0
        for _sc, ar in self._sections:
            d, r = ar["delta_extents"], ar["delta_rows"]
            if d.size:
                di = torch.from_numpy(d.astype(np.int64)).to(dev)
                rd = torch.from_numpy(np.ascontiguousarray(r)).to(dev)
                for p in pools:
                    p.index_copy_(0, di, rd)
                moved += int(d.size)
                copied += r.nbytes
        # one DISTINCT tensor per replica: replicas must not alias
        pr = rep0.page_rev
        storage.set_device_state(
            tuple(pytree.tree_unflatten(
                [torch.from_numpy(x.copy()).to(dev) for x in leaves_np],
                spec) for _ in idx),
            pools)
        storage.set_device_page_revs(
            tuple(torch.from_numpy(arrays["page_rev"].astype(
                _np_dtype(pr))).to(dev) for _ in idx))
        tier = getattr(mgr.engine.impl, "tier", None)
        if tier is not None:
            tier.reset_resident()        # everything device-resident again
        from repro_torch.core.blockdev import Volume
        for vid in scalars["vids"]:
            mgr.volumes.setdefault(int(vid), Volume(mgr, int(vid)))
        self.counters.account("INSTALL", moved,
                              rep0.pool.numel() * rep0.pool.element_size())
        return {"version": int(scalars["version"]),
                "journal_seq": int(scalars["journal_seq"]),
                "extents_replayed": moved, "vids": list(scalars["vids"]),
                "bytes_copied": int(copied)}


def stream_store(donor, target, *, chunk_blocks: int = 64,
                 counters: Optional[ExportCounters] = None
                 ) -> Dict[str, Any]:
    """Rebuild a checkpoint replica by STREAMING the donor's committed
    volumes through both stores' public block paths — the export-plane
    analogue of the engine's chunked FETCH_PAGES/PUSH_PAGES rebuild — with
    transport-style accounting.

    For every donor volume, the valid manifest (header + digest walk,
    ``CheckpointStore._read_valid``, which reads a snapshot through its
    chain and writes nothing to the donor) picks the committed version; a
    ``__restore_<sid>`` clone that a reference store left behind is not
    streamed. Its data blocks are read in ``chunk_blocks`` chunks and
    written into the target store, and the target freezes a snapshot — the same commit ordering
    ``save`` uses, so a crash mid-stream leaves the target's head torn but
    never a frozen version. Returns ``{"volumes": {name: blocks},
    "counters": ...}``."""
    from repro_torch.checkpoint.store import BS
    counters = counters or ExportCounters()
    streamed: Dict[str, int] = {}
    for name in list(donor.dev.volumes):
        if name.startswith("__restore_"):
            continue
        try:
            blob = donor._read_valid(name)
        except IOError:
            continue
        man = blob["manifest"]
        data_end = (1 + blob["manifest_blocks"]) * BS + man["total"]
        total_blocks = data_end // BS
        if name not in target.dev.volumes:
            target.dev.create_volume(name)
        moved = 0
        for b0 in range(0, total_blocks, chunk_blocks):
            nb = min(chunk_blocks, total_blocks - b0)
            raw = blob["read"](b0 * BS, nb * BS)
            target.dev.write(name, b0 * BS, raw)
            moved += nb
            counters.account("STREAM", nb, nb * BS)
        target.dev.snapshot(name)                 # version committed
        streamed[name] = moved
    return {"volumes": streamed, "counters": counters.to_dict()}
