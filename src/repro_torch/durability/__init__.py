"""Durability subsystem: journal, crash recovery, incremental export, tiering.

Port of ``repro/durability``. Everything the engine stores lives in device
pools, so a process crash loses every volume; this package is the
durability plane, four cooperating modules riding existing surfaces:

- ``journal``: a crash-consistent write-ahead journal. Every mutating op
  the public API accepts is captured as a ``WireMsg`` record (the
  controller<->replica transport's vocabulary) and group-committed, ONE
  append per pump, with per-record checksums from the compute package's
  rotate/XOR fold for torn-tail detection. Exposed as
  ``EngineConfig(journal=...)`` / ``VolumeManager(journal=...)`` and the
  ``Volume.flush(durable=True)`` barrier. The file is byte for byte the
  reference's.
- ``recovery``: ``recover(...)`` rebuilds a ``VolumeManager`` after a
  crash by installing the last export (when one exists) and replaying the
  journal tail through the same public submission path.
- ``export``: ``SnapshotExport``, incremental snapshot export on the
  ``page_rev`` watermarks: each section ships only the extents backing
  pages newer than the previous section's watermark row, into a versioned
  file with header-commits-last ordering; ``stream_store``, the checkpoint
  replica rebuild streamed through the stores' block paths.
- ``tier``: ``ExtentTier``, a capacity tier for the fused engine that
  spills cold extents to (pinned) host memory and keeps a bounded
  device-resident hot set (clock/second-chance over per-extent access
  stamps kept IN the fused step), faulting spilled extents back in at the
  pump boundary.
"""
from repro_torch.durability.export import (ExportCounters, SnapshotExport,
                                           stream_store)
from repro_torch.durability.journal import (OP_COMPUTE, OP_SEAL, Journal,
                                            JournalView, read_journal)
from repro_torch.durability.recovery import recover
from repro_torch.durability.tier import ExtentTier

__all__ = [
    "Journal", "JournalView", "read_journal", "OP_COMPUTE", "OP_SEAL",
    "SnapshotExport", "ExportCounters", "stream_store",
    "recover",
    "ExtentTier",
]
