"""The crash-consistent write-ahead journal (durability pillar 1).

Port of ``repro/durability/journal.py``: the record format is numpy and
``struct``, so a journal written here is byte for byte the one the
reference writes for the same op stream, and either package reads the
other's.

One ``Journal`` is an append-only binary file of ``WireMsg`` records — the
SAME record vocabulary the controller<->replica transport speaks
(core/transport.py): volume control ops reuse ``MSG_CREATE`` /
``MSG_SNAPSHOT`` / ``MSG_CLONE`` / ``MSG_UNMAP`` / ``MSG_DELETE``, data
writes are ``MSG_WRITE`` records of post-RMW block-aligned bytes — replay
applies them directly, no re-merge — with adjacent same-volume writes
coalesced into one record at group commit (``coalesce_writes``), and two
journal-local opcodes extend the range: ``OP_COMPUTE`` (a *mutating*
storage-function call — ``compare_and_write``; read-only functions don't
change state and are not journaled) and ``OP_SEAL`` (the batch commit
record).

**Group commit.** ``VolumeManager`` buffers records as ops are submitted
and appends the whole buffer — records + one seal — as ONE file write at
every pump boundary, *before* the engine applies the batch (write-ahead).
Per-op appends would put a file write on the hot path; the seal makes the
batch the atomicity unit: a crash mid-append tears at most the unsealed
tail, and recovery drops exactly the ops the engine never acked.

**Torn-tail detection.** Every record carries an int32 checksum of its
body computed with the compute registry's rotate/XOR algebra
(``repro_torch.compute.functions.np_blocksum`` — the vectorized twin of the
fold ``checksum`` / ``compare_and_write`` run in-band; bit-identical to
``py_blocksum``, numpy-speed on the group-commit path). The reader stops
at the first short,
mis-tagged or mis-summed record and discards any records after the last
seal; ``Journal.__init__`` truncates that torn tail so the journal is
append-clean after recovery.

Record frame (little-endian)::

    | u32 magic "JRNL" | u32 seq | u32 body_len | body | i32 blocksum(body) |

Body::

    | u8 op | i32 volume | i32 shard | i64 meta0 | i64 meta1 | u16 name_len
    | name | u32 n_pages | pages i32[] | u32 n_blocks | blocks i32[]
    | u32 payload_len | payload bytes |

``Journal.sync()`` is the ``Volume.flush(durable=True)`` barrier: fsync.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.compute.functions import np_blocksum, np_blocksum_many
from repro_torch.core.transport import MSG_WRITE, WireMsg

# journal-local opcodes, outside the transport's MSG_ range (0..12)
OP_COMPUTE = 32    # a mutating storage-function call (volume, page, block,
                   # meta=(arg, scope_is_range), fn name, payload=data bytes)
OP_SEAL = 33       # batch commit record (meta0 = records in the batch)

_FILE_MAGIC = b"DBSJRNL1"
_REC_MAGIC = 0x4C4E524A          # "JRNL"
_FRAME = struct.Struct("<III")   # magic, seq, body_len
_HEAD = struct.Struct("<biiqqH")  # op, volume, shard, meta0, meta1, name_len
_SUM = struct.Struct("<i")


_U32_0 = struct.pack("<I", 0)


def _pack_i32(a) -> bytes:
    """u32 count + i32[] — pure struct on the list-valued capture path (a
    numpy round-trip per tiny array would dominate the encode cost)."""
    if a is None:
        return _U32_0
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a.astype(np.int32, copy=False).reshape(-1))
        return struct.pack("<I", a.size) + a.tobytes()
    return struct.pack(f"<I{len(a)}i", len(a), *a)


def encode_body(msg: WireMsg) -> bytes:
    """The record body alone (no frame, no checksum): ``append_batch``
    checksums a whole batch of bodies in one vectorized pass."""
    meta = tuple(msg.meta) if msg.meta else ()
    meta0 = int(meta[0]) if len(meta) > 0 else 0
    meta1 = int(meta[1]) if len(meta) > 1 else 0
    name = getattr(msg, "extents", None)
    name_b = bytes(name) if isinstance(name, (bytes, bytearray)) else b""
    pages = _pack_i32(msg.pages)
    blocks = _pack_i32(msg.blocks)
    if msg.payload is None:
        pay = b""
    elif isinstance(msg.payload, (bytes, bytearray)):
        pay = bytes(msg.payload)
    else:
        # write lanes hold exact byte values (0..255 — engine payload
        # convention), so they journal as ONE uint8 per lane: 4x smaller
        # records, and the common capture path hands us bytes directly
        pay = np.asarray(msg.payload).astype(np.uint8).tobytes()
    vol = -1 if msg.volume is None else int(msg.volume)
    shard = -1 if msg.shard is None else int(msg.shard)
    return b"".join([
        _HEAD.pack(int(msg.op), vol, shard, meta0, meta1, len(name_b)),
        name_b, pages, blocks,
        struct.pack("<I", len(pay)), pay,
    ])


def encode_record(seq: int, msg: WireMsg) -> bytes:
    """One framed record: header + checksummed body (module docstring)."""
    body = encode_body(msg)
    return (_FRAME.pack(_REC_MAGIC, seq, len(body)) + body
            + _SUM.pack(np_blocksum(body)))


def decode_record(body: bytes) -> WireMsg:
    """Inverse of ``encode_body`` (the frame/checksum are checked by the
    reader). Write payloads come back as (n_pages, -1) float32 lanes
    rebuilt from the journaled uint8 bytes; compute payloads as raw
    bytes."""
    op, vol, shard, meta0, meta1, nlen = _HEAD.unpack_from(body, 0)
    off = _HEAD.size
    name = body[off:off + nlen]
    off += nlen
    (np_, ) = struct.unpack_from("<I", body, off)
    off += 4
    pages = np.frombuffer(body, np.int32, np_, off).copy()
    off += 4 * np_
    (nb, ) = struct.unpack_from("<I", body, off)
    off += 4
    blocks = np.frombuffer(body, np.int32, nb, off).copy()
    off += 4 * nb
    (pl, ) = struct.unpack_from("<I", body, off)
    off += 4
    raw = body[off:off + pl]
    if op == OP_COMPUTE:
        payload = raw
    elif pl and np_:
        payload = np.frombuffer(raw, np.uint8).astype(
            np.float32).reshape(np_, -1)
    else:
        payload = None
    return WireMsg(op=op, volume=vol, pages=pages if np_ else None,
                   blocks=blocks if nb else None, payload=payload,
                   extents=name or None, meta=(meta0, meta1),
                   shard=None if shard < 0 else shard)


@dataclass
class JournalView:
    """What a journal file holds: the sealed records (in append order),
    whether a torn tail was discarded, how many unsealed records it held,
    and the byte offset appends may resume at."""
    records: List[Tuple[int, WireMsg]]
    torn: bool
    dropped: int
    valid_bytes: int
    last_seq: int


def read_journal(path: str) -> JournalView:
    """Parse a journal file, committing records batch-by-batch at each seal
    and DROPPING everything after the last intact seal (torn-tail rule)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:len(_FILE_MAGIC)] != _FILE_MAGIC:
        raise IOError(f"{path}: not a journal (bad file magic)")
    off = len(_FILE_MAGIC)
    committed: List[Tuple[int, WireMsg]] = []
    pending: List[Tuple[int, WireMsg]] = []
    valid = off
    torn = False
    last_seq = 0
    while True:
        if off + _FRAME.size > len(blob):
            torn = torn or off < len(blob)
            break
        magic, seq, blen = _FRAME.unpack_from(blob, off)
        end = off + _FRAME.size + blen + _SUM.size
        if magic != _REC_MAGIC or end > len(blob):
            torn = True
            break
        body = blob[off + _FRAME.size:end - _SUM.size]
        (want_sum, ) = _SUM.unpack_from(blob, end - _SUM.size)
        if np_blocksum(body) != want_sum:
            torn = True
            break
        msg = decode_record(body)
        if msg.op == OP_SEAL:
            committed.extend(pending)
            pending.clear()
            valid = end
            last_seq = seq
        else:
            pending.append((seq, msg))
        off = end
    return JournalView(records=committed, torn=torn, dropped=len(pending),
                       valid_bytes=valid, last_seq=last_seq)


def coalesce_writes(msgs: Sequence[WireMsg]) -> List[WireMsg]:
    """Merge ADJACENT same-volume ``MSG_WRITE`` records into one.

    The capture path journals one record per ``pwrite`` with list-valued
    pages/blocks and a bytes payload whose k-th block-size chunk belongs
    to the k-th (page, block) pair — so a run of writes to one volume
    concatenates into a single record with identical replay semantics
    (replay applies a record's blocks in order, exactly as the separate
    records would have applied in sequence). A whole 32-write pump then
    encodes as ~one record instead of 32, which is where the group-commit
    encode cost goes. Records in any other shape (ndarray fields, control
    ops, computes) pass through unmerged, in order."""
    out: List[WireMsg] = []
    vol = pages = blocks = pays = None

    def _close():
        nonlocal pages
        if pages is not None:
            out.append(WireMsg(op=MSG_WRITE, volume=vol, pages=pages,
                               blocks=blocks, payload=b"".join(pays)))
            pages = None

    for m in msgs:
        if (m.op == MSG_WRITE and isinstance(m.pages, list)
                and isinstance(m.blocks, list)
                and isinstance(m.payload, (bytes, bytearray))):
            if pages is not None and vol == m.volume:
                pages.extend(m.pages)
                blocks.extend(m.blocks)
                pays.append(m.payload)
                continue
            _close()
            vol, pages = m.volume, list(m.pages)
            blocks, pays = list(m.blocks), [m.payload]
        else:
            _close()
            out.append(m)
    _close()
    return out


class Journal:
    """Append handle over one journal file (module docstring).

    Opening an existing file scans it, truncates any torn tail, and resumes
    the sequence numbering after the last sealed record — so a recovered
    manager reattaches to the same file and keeps appending."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._seq = 0
        if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
            view = read_journal(self.path)
            self._seq = view.last_seq
            with open(self.path, "r+b") as f:
                f.truncate(view.valid_bytes)
            self._f = open(self.path, "ab")
        else:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "wb")
            self._f.write(_FILE_MAGIC)
            self._f.flush()
        self.appends = 0          # group commits (ONE per pump with traffic)
        self.records = 0          # records sealed

    @property
    def seq(self) -> int:
        """Sequence number of the last sealed record (the export cursor)."""
        return self._seq

    @property
    def closed(self) -> bool:
        return self._f.closed

    def append_batch(self, msgs: Sequence[WireMsg]) -> int:
        """Group-commit: encode every buffered record plus ONE seal and
        write them with a single file append. Returns the seal's seq."""
        if not msgs:
            return self._seq
        msgs = coalesce_writes(msgs)
        bodies = [encode_body(m) for m in msgs]
        bodies.append(encode_body(WireMsg(op=OP_SEAL, meta=(len(msgs), 0))))
        sums = np_blocksum_many(bodies)
        first = self._seq + 1
        self._seq += len(bodies)
        self._f.write(b"".join(
            _FRAME.pack(_REC_MAGIC, first + i, len(b)) + b + _SUM.pack(c)
            for i, (b, c) in enumerate(zip(bodies, sums))))
        self._f.flush()
        self.appends += 1
        self.records += len(msgs)
        return self._seq

    def sync(self) -> None:
        """The durable barrier (``Volume.flush(durable=True)``): fsync."""
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __repr__(self):
        return (f"Journal({self.path!r}, seq={self._seq}, "
                f"appends={self.appends})")


def as_journal(journal) -> Optional[Journal]:
    """Coerce a ``journal=`` config value: None | path | Journal."""
    if journal is None or isinstance(journal, Journal):
        return journal
    return Journal(journal)
