"""Crash recovery: replay the journal tail on top of the last export.

Port of ``repro/durability/recovery.py``; replayed writes run the same
fused step, so on the card every replayed write pump launches the
``dbs_rw_write`` kernel and every read-back the ``dbs_rw_read`` kernel.

``recover(journal, ...)`` rebuilds a ``VolumeManager`` after a crash:

1. construct a FRESH manager with the same geometry (journaling detached —
   replay must not re-journal itself),
2. if an export file is given and the backend has an installable flat
   replica plane (slots/loop/fused), install its newest committed section
   — tables, extent pools, ``page_rev`` watermarks, snapshot chains and
   the open volume handles — and remember the journal position it covers;
   backends without wholesale device-state install (host/sharded/ring) or
   a geometry-mismatched export fall back to FULL journal replay,
3. replay every sealed record after that position **through the same
   public submission path the original ops took**: ``MSG_WRITE`` records
   apply their post-RMW block lanes directly (the manager's overlapping-
   block hazard fence re-serializes exactly the spans the original run
   fenced), control records re-execute and ASSERT the engine hands back
   the recorded volume/snapshot ids (allocation is deterministic in
   control order), mutating ``OP_COMPUTE`` records re-run in place,
4. flush and reattach the journal (truncating any torn tail) so the
   recovered manager keeps appending to the same file.

Byte-identity, not extent-identity: replicas re-allocate extents in replay
order, so the recovered *tables* may differ from the crashed run's while
every volume's **bytes** are identical — which is the contract the shadow
oracle checks (tests/test_torch_durability*.py run this at every pump
boundary on host/fused/sharded/ring).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core.transport import (MSG_CLONE, MSG_CREATE, MSG_DELETE,
                                  MSG_SNAPSHOT, MSG_UNMAP, MSG_WRITE)
from repro_torch.durability.journal import (OP_COMPUTE, Journal, JournalView,
                                      read_journal)


class RecoveryError(RuntimeError):
    """Replay diverged from the journal (id mismatch / undecodable op)."""


def _replay_control(mgr, msg) -> None:
    meta0 = int(msg.meta[0]) if msg.meta else -1
    if msg.op == MSG_CREATE:
        vid = mgr.create().vid
        if vid != meta0:
            raise RecoveryError(
                f"create replayed to volume {vid}, journal says {meta0}")
    elif msg.op == MSG_SNAPSHOT:
        sid = mgr.snapshot(int(msg.volume))
        got = -1 if sid is None else int(sid)
        if got != meta0:
            raise RecoveryError(
                f"snapshot(vol {msg.volume}) replayed to {got}, journal "
                f"says {meta0}")
    elif msg.op == MSG_CLONE:
        child = mgr.clone(int(msg.volume))
        got = -1 if child is None else child.vid
        if got != meta0:
            raise RecoveryError(
                f"clone(vol {msg.volume}) replayed to {got}, journal "
                f"says {meta0}")
    elif msg.op == MSG_DELETE:
        mgr.delete(int(msg.volume))
    elif msg.op == MSG_UNMAP:
        mgr._unmap_pages(int(msg.volume), [int(p) for p in msg.pages])
    else:
        raise RecoveryError(f"journal holds unknown opcode {msg.op}")


def _replay_compute(mgr, msg) -> None:
    fn = bytes(msg.extents).decode()
    arg = int(msg.meta[0])
    is_range = bool(msg.meta[1])
    page = int(msg.pages[0])
    cnt_or_block = int(msg.blocks[0])
    if is_range:
        off = page * mgr.page_bytes
        nbytes = cnt_or_block * mgr.page_bytes
    else:
        off = (page * mgr.page_blocks + cnt_or_block) * mgr.block_bytes
        nbytes = mgr.block_bytes
    data = bytes(msg.payload) if msg.payload else None
    mgr.compute(int(msg.volume), fn, off, nbytes, arg=arg, data=data)


def replay(mgr, view: JournalView, *, after_seq: int = 0) -> int:
    """Apply every sealed record with ``seq > after_seq`` to ``mgr``;
    returns the record count applied. ``mgr`` must have no journal attached
    (replay would re-log itself)."""
    if mgr._journal is not None:
        raise ValueError("detach the journal before replaying into a "
                         "manager (recovery would re-journal the replay)")
    applied = 0
    for seq, msg in view.records:
        if seq <= after_seq:
            continue
        if msg.op == MSG_WRITE:
            mgr._replay_write(int(msg.volume), np.asarray(msg.pages),
                              np.asarray(msg.blocks),
                              np.asarray(msg.payload, np.float32))
        elif msg.op == OP_COMPUTE:
            _replay_compute(mgr, msg)
        else:
            _replay_control(mgr, msg)
        applied += 1
    mgr.flush()
    return applied


def recover(journal, *, export=None, manager=None, reattach: bool = True,
            **manager_kwargs) -> Any:
    """Rebuild a ``VolumeManager`` from its journal (module docstring).

    ``journal``: the journal path (or an open ``Journal`` — its path is
    read). ``export``: optional export path / ``SnapshotExport`` to install
    first. ``manager``: a pre-built fresh manager to replay into; otherwise
    one is constructed as ``VolumeManager(**manager_kwargs)``. With
    ``reattach`` (default) the recovered manager continues journaling to
    the same file — torn tail truncated, sequence numbers resumed.

    The recovery summary is left on the manager as ``.recovery_info``."""
    from repro_torch.core.blockdev import VolumeManager
    path = journal.path if isinstance(journal, Journal) else os.fspath(
        journal)
    mgr = manager
    if mgr is None:
        manager_kwargs.pop("journal", None)
        mgr = VolumeManager(**manager_kwargs)
    after_seq = 0
    installed: Optional[Dict[str, Any]] = None
    if export is not None:
        from repro_torch.durability.export import SnapshotExport
        exp = (export if isinstance(export, SnapshotExport)
               else SnapshotExport(export))
        if exp.sections:
            try:
                installed = exp.install(mgr)
                after_seq = installed["journal_seq"]
            except ValueError:
                installed = None         # full-replay fallback
                after_seq = 0
    view = read_journal(path)
    applied = replay(mgr, view, after_seq=after_seq)
    if reattach:
        j = journal if isinstance(journal, Journal) else Journal(path)
        mgr.attach_journal(j)
    mgr.recovery_info = {
        "replayed": applied, "after_seq": after_seq,
        "sealed_records": len(view.records), "torn_tail": view.torn,
        "dropped_records": view.dropped, "installed": installed,
    }
    return mgr
