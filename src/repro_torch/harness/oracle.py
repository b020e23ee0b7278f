"""The shadow byte oracle: ground truth for every acked read and replica.

Port of ``repro/harness/oracle.py`` (pure Python).

One ``bytearray`` per volume mirrors what the engine is REQUIRED to serve:
the ``VolumeManager`` contract makes per-volume submission order execution
order, so the oracle applies each write at *submission* time and captures
each read's expected bytes at submission time too — a read submitted
between two overlapping writes must observe exactly the first. Discards
zero their span (TRIM reads back as zeros); clones copy the source shadow
(``VolumeManager.clone`` flushes before forking, so the shadow at the
clone point is the exact CoW image).

Mismatches are collected as strings (not raised mid-run) so one corrupted
read doesn't hide the next hundred; ``OracleMismatch`` is what strict
callers (``run(strict=True)``, the default) raise at the end of the run
with every failure attached.
"""
from __future__ import annotations

from typing import Dict, List


class OracleMismatch(AssertionError):
    """A harness run observed bytes diverging from the shadow oracle."""


class ByteOracle:
    """Shadow bytearrays, one per volume id (module docstring)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.shadow: Dict[int, bytearray] = {}
        self.failures: List[str] = []
        self.checked_reads = 0

    def add_volume(self, vid: int) -> None:
        self.shadow[vid] = bytearray(self.capacity)

    def clone(self, src_vid: int, dst_vid: int) -> None:
        self.shadow[dst_vid] = bytearray(self.shadow[src_vid])

    def delete(self, vid: int) -> None:
        self.shadow.pop(vid, None)

    def write(self, vid: int, off: int, data: bytes) -> None:
        self.shadow[vid][off:off + len(data)] = data

    def discard(self, vid: int, off: int, nbytes: int) -> None:
        self.shadow[vid][off:off + nbytes] = bytes(nbytes)

    def expected(self, vid: int, off: int, nbytes: int) -> bytes:
        """The bytes a read of this span must return, as of NOW (call at
        submission time — that is the ordering point the API guarantees)."""
        return bytes(self.shadow[vid][off:off + nbytes])

    def check(self, got: bytes, expected: bytes, context: str) -> bool:
        """Record one comparison; returns True when it matched."""
        self.checked_reads += 1
        if got == expected:
            return True
        diff = next((i for i, (g, e) in enumerate(zip(got, expected))
                     if g != e), min(len(got), len(expected)))
        self.failures.append(
            f"{context}: first divergence at byte {diff} "
            f"(got {got[diff:diff + 8].hex()!r}, "
            f"expected {expected[diff:diff + 8].hex()!r}, "
            f"lengths {len(got)}/{len(expected)})")
        return False

    @property
    def ok(self) -> bool:
        return not self.failures

    def raise_if_failed(self) -> None:
        if self.failures:
            raise OracleMismatch(
                f"{len(self.failures)} oracle mismatch(es):\n  "
                + "\n  ".join(self.failures[:20]))
