"""Port parity: the durability package (``repro_torch/durability``).

Twins of tests/test_durability.py, run on the port with ``device="cpu"``
at the same geometry (``BB=16``, ``PB=4``, ``PAGES=8``), plus the cases
that hold the two packages against each other:

1. **journal format**: the record encode/decode round trip; the bytes of
   a record, and of a whole group-committed file, equal the JAX
   package's; the reader's seal, unsealed-drop and torn-tail rules.
2. **crash at every pump boundary** on host/fused/sharded(2)/ring(2):
   the JAX manager takes the same op stream in lockstep, and after every
   durable flush (and torn tail) the two journal files are equal byte for
   byte; the port recovers from its own file each time and serves the
   bytearray shadow oracle; at the end each package recovers from the
   OTHER package's journal to the same oracle.
3. **incremental export**: the watermark delta, install plus tail replay,
   the full-replay fallback and reload from disk; a JAX-written export of
   a fused manager installs in the port and the reverse, with equal state
   leaves (the bitmap compared after the uint32/int64 conversion).
4. **the spill tier**: 2x over-subscription, CoW under spills,
   discard-and-reallocate, the config errors; and the tiered step against
   the untiered one on the same trace (byte-equal reads, stamps equal to
   the JAX ``_stamp_tier``'s, spills and fills both above 0).

The checkpoint stream rebuild (``test_checkpoint_rebuild_streams_blocks``)
has its twin in tests/test_torch_system.py; here ``stream_store`` runs
straight between two checkpoint stores against the reference's. The
harness crash scenario (``test_harness_crash_scenario``) has its twin in
tests/test_torch_harness_scenarios.py.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core.blockdev import VolumeManager as JManager  # noqa: E402
from repro.durability import Journal as JJournal  # noqa: E402
from repro.durability import SnapshotExport as JExport  # noqa: E402
from repro.durability import recover as jrecover  # noqa: E402
from repro.durability.journal import \
    encode_record as jencode_record  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core.blockdev import VolumeManager  # noqa: E402
from repro_torch.core.transport import (MSG_SNAPSHOT, MSG_UNMAP,  # noqa: E402
                                        MSG_WRITE, WireMsg)
from repro_torch.durability import (OP_COMPUTE, ExtentTier,  # noqa: E402
                                    Journal, SnapshotExport, read_journal,
                                    recover)
from repro_torch.durability.journal import (decode_record,  # noqa: E402
                                            encode_record)

BB = 16         # block_bytes
PB = 4          # page_blocks -> page_bytes = 64
PAGES = 8       # capacity = 512 bytes per volume

# the recovery acceptance matrix: flat replica plane (fused installs
# exports wholesale) and the full-replay fallbacks (host/sharded/ring)
MATRIX = [("host", 1), ("fused", 1), ("sharded", 2), ("ring", 2)]


def _kw(backend: str, n_shards: int = 1, **kw) -> dict:
    base = dict(backend=backend, n_shards=n_shards, payload_elems=BB,
                page_blocks=PB, max_pages=PAGES, n_extents=256,
                max_volumes=16, batch=16, n_replicas=2, device="cpu")
    base.update(kw)
    return base


def _jkw(backend: str, n_shards: int = 1, **kw) -> dict:
    out = _kw(backend, n_shards, **kw)
    del out["device"]
    return out


def _pat(seed: int, n: int) -> bytes:
    return bytes((seed * 37 + i * 11) % 251 for i in range(n))


def _torn(volume: int = 0) -> bytes:
    rec = encode_record(10 ** 9, WireMsg(
        op=MSG_WRITE, volume=volume, pages=np.asarray([0], np.int32),
        blocks=np.asarray([0], np.int32),
        payload=np.zeros((1, BB), np.float32)))
    return rec[:len(rec) // 2]


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# 1. journal format
# ---------------------------------------------------------------------------
def test_np_blocksum_matches_py_blocksum():
    """The journal's vectorized record checksum is the SAME rotate/XOR
    fold the compute package runs in-band, and the reference's."""
    from repro.compute.functions import py_blocksum as jpy_blocksum
    from repro_torch.compute.functions import (np_blocksum, np_blocksum_many,
                                               py_blocksum)
    rng = np.random.default_rng(7)
    for n in (0, 1, 30, 31, 32, 63, 257, 4096):
        blob = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert np_blocksum(blob) == py_blocksum(blob) == jpy_blocksum(blob)
    blobs = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
             for n in (27, 1, 31, 32, 100, 313)]
    assert np_blocksum_many(blobs) == [py_blocksum(b) for b in blobs]


def test_np_blocksum_chunks_match_py_blocksum(monkeypatch):
    """The residue-class fold gives ``py_blocksum`` under any chunking
    (sections of gigabytes fold a chunk at a time)."""
    from repro_torch.compute import functions
    rng = np.random.default_rng(11)
    for chunk in (functions._FOLD_CHUNK, 31, 31 * 4):
        monkeypatch.setattr(functions, "_FOLD_CHUNK", chunk)
        for n in (0, 1, 30, 31, 32, 61, 62, 124, 125, 1000, 4097):
            blob = bytes(rng.integers(0, 256, n, dtype=np.uint8))
            assert functions.np_blocksum(blob) == functions.py_blocksum(
                blob), (chunk, n)


def test_coalesce_writes_merges_adjacent_same_volume():
    from repro_torch.durability.journal import coalesce_writes
    w = [WireMsg(op=MSG_WRITE, volume=0, pages=[i], blocks=[i % PB],
                 payload=bytes([i] * BB)) for i in range(3)]
    other = WireMsg(op=MSG_WRITE, volume=1, pages=[5], blocks=[0],
                    payload=bytes(BB))
    ctl = WireMsg(op=MSG_SNAPSHOT, volume=0, meta=(1, 0))
    out = coalesce_writes([w[0], w[1], other, ctl, w[2]])
    assert [m.op for m in out] == [MSG_WRITE, MSG_WRITE, MSG_SNAPSHOT,
                                   MSG_WRITE]
    merged = out[0]                   # w0+w1: one record, order preserved
    assert merged.pages == [0, 1] and merged.blocks == [0, 1]
    assert merged.payload == w[0].payload + w[1].payload
    assert out[1].volume == 1 and out[3].pages == [2]
    # ndarray-shaped records pass through unmerged
    nd = WireMsg(op=MSG_WRITE, volume=0, pages=np.asarray([0], np.int32),
                 blocks=np.asarray([0], np.int32),
                 payload=np.zeros((1, BB), np.float32))
    assert len(coalesce_writes([nd, nd])) == 2


def _jmsg(msg: WireMsg):
    """The same message in the JAX package's WireMsg."""
    from repro.core.transport import WireMsg as JWireMsg
    return JWireMsg(**{f.name: getattr(msg, f.name)
                       for f in dataclasses.fields(msg)})


def test_record_roundtrip_write():
    lanes = np.arange(2 * BB, dtype=np.float32).reshape(2, BB)
    msg = WireMsg(op=MSG_WRITE, volume=3, pages=np.asarray([1, 2], np.int32),
                  blocks=np.asarray([0, 3], np.int32), payload=lanes)
    rec = encode_record(7, msg)
    assert rec == jencode_record(7, _jmsg(msg))     # the reference's bytes
    back = decode_record(rec[12:-4])          # strip frame + checksum
    assert back.op == MSG_WRITE and back.volume == 3
    np.testing.assert_array_equal(back.pages, [1, 2])
    np.testing.assert_array_equal(back.blocks, [0, 3])
    np.testing.assert_array_equal(back.payload, lanes)


def test_record_roundtrip_control_and_compute():
    m_ctl = WireMsg(op=MSG_SNAPSHOT, volume=2, meta=(9, 0))
    ctl = decode_record(encode_record(1, m_ctl)[12:-4])
    assert (ctl.op, ctl.volume, ctl.meta[0]) == (MSG_SNAPSHOT, 2, 9)
    m_comp = WireMsg(
        op=OP_COMPUTE, volume=1, pages=np.asarray([4], np.int32),
        blocks=np.asarray([2], np.int32), extents=b"compare_and_write",
        meta=(123, 0), payload=b"\x01\x02\x03")
    comp = decode_record(encode_record(2, m_comp)[12:-4])
    assert comp.op == OP_COMPUTE
    assert bytes(comp.extents) == b"compare_and_write"
    assert comp.meta == (123, 0)
    assert bytes(comp.payload) == b"\x01\x02\x03"
    for seq, m in ((1, m_ctl), (2, m_comp)):
        assert encode_record(seq, m) == jencode_record(seq, _jmsg(m))


def test_journal_group_commit_and_resume(tmp_path):
    path = str(tmp_path / "wal.dbsj")
    jpath = str(tmp_path / "jax.dbsj")
    j, jj = Journal(path), JJournal(jpath)
    msgs = [WireMsg(op=MSG_WRITE, volume=0,
                    pages=np.asarray([i], np.int32),
                    blocks=np.asarray([0], np.int32),
                    payload=np.full((1, BB), i, np.float32))
            for i in range(3)]
    for jn, conv in ((j, lambda m: m), (jj, _jmsg)):
        jn.append_batch([conv(m) for m in msgs])   # ONE append: 3 + seal
        jn.append_batch([conv(msgs[0])])
    assert (j.appends, j.records) == (2, 4)
    j.sync()
    j.close()
    jj.close()
    assert _read(path) == _read(jpath)        # the reference's file
    view = read_journal(path)
    assert len(view.records) == 4 and not view.torn and view.dropped == 0
    assert [s for s, _ in view.records] == [1, 2, 3, 5]   # 4 is the seal
    j2 = Journal(path)                        # resume: seq continues
    assert j2.seq == view.last_seq
    j2.append_batch(msgs[:1])
    assert j2.seq == view.last_seq + 2
    j2.close()


def test_torn_tail_detected_and_truncated(tmp_path):
    path = str(tmp_path / "wal.dbsj")
    j = Journal(path)
    j.append_batch([WireMsg(op=MSG_UNMAP, volume=0,
                            pages=np.asarray([1], np.int32))])
    j.close()
    good = os.path.getsize(path)
    rec = encode_record(99, WireMsg(op=MSG_UNMAP, volume=1,
                                    pages=np.asarray([2], np.int32)))
    with open(path, "ab") as f:               # crash mid-append
        f.write(rec[:len(rec) // 2])
    view = read_journal(path)
    assert view.torn and len(view.records) == 1
    assert view.valid_bytes == good
    j2 = Journal(path)                        # reopen truncates the tail
    j2.close()
    assert os.path.getsize(path) == good
    assert not read_journal(path).torn


def test_unsealed_records_dropped(tmp_path):
    path = str(tmp_path / "wal.dbsj")
    j = Journal(path)
    j.append_batch([WireMsg(op=MSG_UNMAP, volume=0,
                            pages=np.asarray([1], np.int32))])
    j.close()
    with open(path, "ab") as f:               # two intact but UNSEALED recs
        f.write(encode_record(50, WireMsg(op=MSG_UNMAP, volume=1,
                                          pages=np.asarray([2], np.int32))))
        f.write(encode_record(51, WireMsg(op=MSG_UNMAP, volume=1,
                                          pages=np.asarray([3], np.int32))))
    view = read_journal(path)
    assert len(view.records) == 1 and view.dropped == 2 and not view.torn


def test_corrupt_checksum_tears(tmp_path):
    path = str(tmp_path / "wal.dbsj")
    j = Journal(path)
    j.append_batch([WireMsg(op=MSG_UNMAP, volume=0,
                            pages=np.asarray([1], np.int32))])
    j.append_batch([WireMsg(op=MSG_UNMAP, volume=0,
                            pages=np.asarray([2], np.int32))])
    j.close()
    view0 = read_journal(path)
    with open(path, "r+b") as f:              # flip one body byte of the
        f.seek(os.path.getsize(path) - 20)    # last batch
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    view = read_journal(path)
    assert view.torn and len(view.records) < len(view0.records)


# ---------------------------------------------------------------------------
# 2. crash-at-every-pump-boundary recovery vs the shadow oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend,n_shards", MATRIX)
def test_crash_at_every_pump_boundary(tmp_path, backend, n_shards):
    """The reference's crash matrix on the port, with the JAX manager in
    lockstep: the journal files are equal byte for byte at every crash;
    the port recovers from its file at every crash; and at the end each
    package recovers from the other's file to the shadow oracle."""
    kw, jkw = _kw(backend, n_shards), _jkw(backend, n_shards)
    jp, jjp = str(tmp_path / "wal.dbsj"), str(tmp_path / "jax.dbsj")
    mgr = VolumeManager(journal=jp, **kw)
    jm = JManager(journal=jjp, **jkw)
    cap = mgr.capacity
    shadow = {}
    for _ in range(2):
        vid = mgr.create().vid
        assert jm.create().vid == vid
        shadow[vid] = bytearray(cap)
    vids = sorted(shadow)
    try:
        for burst in range(6):
            for i in range(3):
                vid = vids[(burst + i) % len(vids)]
                off = ((burst * 37 + i * 13) * 7) % (cap - 64)
                n = 9 + (burst * 11 + i * 5) % 48      # unaligned spans too
                data = _pat(burst * 10 + i, n)
                for m in (mgr, jm):
                    m.pwrite(vid, off, data)
                shadow[vid][off:off + n] = data
            if burst == 2:
                for m in (mgr, jm):
                    m.snapshot(vids[0])
            if burst == 3:
                child = mgr.clone(vids[0])
                assert child is not None
                assert jm.clone(vids[0]).vid == child.vid
                shadow[child.vid] = bytearray(shadow[vids[0]])
                vids.append(child.vid)
            if burst == 4:
                for m in (mgr, jm):
                    m.discard(vids[1], 32, 3 * m.page_bytes)
                shadow[vids[1]][32:32 + 3 * mgr.page_bytes] = bytes(
                    3 * mgr.page_bytes)
            for m in (mgr, jm):
                m.flush(durable=True)
            if burst % 2 == 1:                # every 2nd crash mid-append
                for p in (jp, jjp):
                    with open(p, "ab") as f:
                        f.write(_torn())
            assert _read(jp) == _read(jjp), f"{backend}: journals differ"
            mgr = recover(jp, **kw)           # dead mgr abandoned, not closed
            # the JAX side reopens its file (torn tail truncated) and goes
            # on: its journal bytes are what its own recovery would append
            jm.attach_journal(JJournal(jjp))
            info = mgr.recovery_info
            assert info["replayed"] == info["sealed_records"] > 0
            assert info["torn_tail"] == (burst % 2 == 1)
            for vid in vids:
                got = mgr.open(vid).read(0, cap)
                assert got == bytes(shadow[vid]), (
                    f"{backend}: vol {vid} diverged after crash {burst}")
        # across packages: each recovers from the other's journal
        mgr.close()
        jm.close()
        mgr = recover(jjp, reattach=False, **kw)
        jm = jrecover(jp, reattach=False, **jkw)
        for vid in vids:
            for m in (mgr, jm):
                assert m.open(vid).read(0, cap) == bytes(shadow[vid]), (
                    f"{backend}: vol {vid} diverged across packages")
    finally:
        mgr.close()
        jm.close()


def test_recovered_manager_keeps_journaling(tmp_path):
    """Reattach: the recovered manager appends to the same file, and a
    SECOND crash+recovery replays both generations of records."""
    kw = _kw("fused")
    jp = str(tmp_path / "wal.dbsj")
    mgr = VolumeManager(journal=jp, **kw)
    vid = mgr.create().vid
    mgr.pwrite(vid, 0, _pat(1, 100))
    mgr.flush(durable=True)
    mgr = recover(jp, **kw)
    mgr.pwrite(vid, 50, _pat(2, 100))         # journaled via the reattached
    mgr.flush(durable=True)                   # handle
    mgr = recover(jp, **kw)
    want = bytearray(mgr.capacity)
    want[0:100] = _pat(1, 100)
    want[50:150] = _pat(2, 100)
    assert mgr.open(vid).read(0, mgr.capacity) == bytes(want)
    assert mgr.recovery_info["replayed"] >= 3  # create + both writes
    mgr.close()


def test_replay_refuses_attached_journal(tmp_path):
    from repro_torch.durability.recovery import replay
    jp = str(tmp_path / "wal.dbsj")
    mgr = VolumeManager(journal=jp, **_kw("host"))
    mgr.create()
    mgr.flush(durable=True)
    with pytest.raises(ValueError, match="detach"):
        replay(mgr, read_journal(jp))
    mgr.close()


def test_mutating_compute_journaled_and_replayed(tmp_path):
    """compare_and_write is write-ahead logged (OP_COMPUTE) and re-runs on
    replay; read-only functions leave no record."""
    from repro_torch.compute.functions import py_blocksum
    kw = _kw("ring", 2)
    jp = str(tmp_path / "wal.dbsj")
    mgr = VolumeManager(journal=jp, **kw)
    vid = mgr.create().vid
    old = _pat(3, BB)
    mgr.pwrite(vid, 0, old)
    mgr.flush()
    new = _pat(4, BB)
    res = mgr.compute(vid, "compare_and_write", 0, BB,
                      arg=py_blocksum(old), data=new).result()
    assert res.ok
    mgr.compute(vid, "checksum").result()     # read-only: not journaled
    mgr.flush(durable=True)
    ops = [m.op for _, m in read_journal(jp).records]
    assert ops.count(OP_COMPUTE) == 1
    mgr = recover(jp, **kw)
    assert mgr.open(vid).read(0, BB) == new
    mgr.close()


# ---------------------------------------------------------------------------
# 3. incremental export: watermark exactness, install + tail replay
# ---------------------------------------------------------------------------
def test_export_ships_exactly_the_delta(tmp_path):
    kw = _kw("fused")
    mgr = VolumeManager(**kw)
    vid = mgr.create().vid
    pby = mgr.page_bytes
    for p in range(4):                        # map 4 extents
        mgr.pwrite(vid, p * pby, _pat(p, pby))
    mgr.flush()
    exp = SnapshotExport(str(tmp_path / "inc.dbsx"))
    first = exp.export(mgr)
    assert first["extents_moved"] == 4
    mgr.pwrite(vid, 1 * pby, _pat(9, pby))    # touch exactly 2 pages
    mgr.pwrite(vid, 3 * pby, _pat(8, pby))
    mgr.flush()
    second = exp.export(mgr)
    assert second["extents_moved"] == 2       # the post-watermark extents
    third = exp.export(mgr)                   # nothing moved since
    assert third["extents_moved"] == 0
    assert exp.counters.sent["EXPORT"] == 3
    assert exp.counters.extents_moved == 6
    mgr.close()


def test_export_install_plus_tail_replay(tmp_path):
    kw = _kw("fused")
    jp = str(tmp_path / "wal.dbsj")
    xp = str(tmp_path / "inc.dbsx")
    mgr = VolumeManager(journal=jp, **kw)
    vid = mgr.create().vid
    mgr.pwrite(vid, 0, _pat(1, 200))
    mgr.flush(durable=True)
    SnapshotExport(xp).export(mgr, journal=mgr._journal)
    mgr.pwrite(vid, 100, _pat(2, 200))        # the tail past the export
    mgr.flush(durable=True)
    mgr = recover(jp, export=xp, **kw)
    info = mgr.recovery_info
    assert info["installed"] is not None and info["after_seq"] > 0
    assert 0 < info["replayed"] < info["sealed_records"]   # tail only
    want = bytearray(mgr.capacity)
    want[0:200] = _pat(1, 200)
    want[100:300] = _pat(2, 200)
    assert mgr.open(vid).read(0, mgr.capacity) == bytes(want)
    mgr.close()


def test_export_fallback_to_full_replay(tmp_path):
    """A backend without a flat replica plane ignores the export and
    replays the whole journal."""
    kw = _kw("sharded", 2)
    jp = str(tmp_path / "wal.dbsj")
    xp = str(tmp_path / "inc.dbsx")
    donor = VolumeManager(**_kw("fused"))     # export from a fused twin
    donor.create()
    donor.flush()
    SnapshotExport(xp).export(donor)
    donor.close()
    mgr = VolumeManager(journal=jp, **kw)
    vid = mgr.create().vid
    mgr.pwrite(vid, 0, _pat(5, 300))
    mgr.flush(durable=True)
    mgr = recover(jp, export=xp, **kw)
    info = mgr.recovery_info
    assert info["installed"] is None and info["after_seq"] == 0
    assert mgr.open(vid).read(0, 300) == _pat(5, 300)
    mgr.close()


def test_export_reload_from_disk(tmp_path):
    """A reopened export file sees the committed sections (header count),
    and install replays sections in order: later rows win."""
    kw = _kw("fused")
    xp = str(tmp_path / "inc.dbsx")
    mgr = VolumeManager(**kw)
    vid = mgr.create().vid
    pby = mgr.page_bytes
    exp = SnapshotExport(xp)
    mgr.pwrite(vid, 0, _pat(1, pby))
    mgr.flush()
    exp.export(mgr)
    mgr.pwrite(vid, 0, _pat(2, pby))          # same page, newer content
    mgr.flush()
    exp.export(mgr)
    mgr.close()
    exp2 = SnapshotExport(xp)                 # reload
    assert exp2.sections == 2
    fresh = VolumeManager(**kw)
    try:
        exp2.install(fresh)
        assert fresh.open(vid).read(0, pby) == _pat(2, pby)
    finally:
        fresh.close()


def _replica_state(m, port: bool):
    """Replica 0's state leaves (reference names, bitmap uint32), pool and
    watermarks as numpy."""
    r = m.engine.backend.replicas[0]
    if port:
        return (convert.to_numpy(r.state), r.pool.numpy(),
                r.page_rev.numpy())
    return (jax.device_get(dataclasses.asdict(r.state)),
            np.asarray(r.pool), np.asarray(r.page_rev))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_export_installs_across_packages(tmp_path, writer):
    """A fused manager's export and journal, written by one package,
    recover in the other (install plus tail replay): the installed state
    leaves, pools and watermarks equal the writer's, and the volumes equal
    the writer's bytes."""
    jp = str(tmp_path / "wal.dbsj")
    xp = str(tmp_path / "inc.dbsx")
    src_port = writer == "torch"
    M, X = (VolumeManager, SnapshotExport) if src_port else (JManager,
                                                             JExport)
    kw = _kw("fused") if src_port else _jkw("fused")
    src = M(journal=jp, **kw)
    pby = src.page_bytes
    vids = [src.create().vid for _ in range(2)]
    for p in range(PAGES):
        src.pwrite(vids[p % 2], p * pby + 3, _pat(p, pby - 7))
    src.snapshot(vids[0])
    src.pwrite(vids[0], 5, _pat(40, 90))      # CoW after the snapshot
    src.flush(durable=True)
    exp = X(xp)
    exp.export(src, journal=src._journal)
    src.pwrite(vids[1], 70, _pat(41, 150))    # a second, smaller section
    src.flush()
    exp.export(src, journal=src._journal)
    at_export = _replica_state(src, src_port)
    src.pwrite(vids[0], 200, _pat(42, 60))    # the tail past the export
    src.discard(vids[1], pby, 2 * pby)
    src.flush(durable=True)
    want = {v: src.open(v).read(0, src.capacity) for v in vids}
    src.close()
    # install alone: the writer's state at its last export
    dst = (JManager(**_jkw("fused")) if src_port
           else VolumeManager(**_kw("fused")))
    (JExport if src_port else SnapshotExport)(xp).install(dst)
    got = _replica_state(dst, not src_port)
    for k in at_export[0]:
        if k == "free":
            for kk in at_export[0][k]:
                np.testing.assert_array_equal(
                    np.asarray(got[0][k][kk]).reshape(-1),
                    np.asarray(at_export[0][k][kk]).reshape(-1))
            continue
        np.testing.assert_array_equal(np.asarray(got[0][k]).reshape(-1),
                                      np.asarray(at_export[0][k]).reshape(-1),
                                      err_msg=k)
    # the rows an export ships: those the volumes map (snapshot-only and
    # free rows install as zeros, as in the reference)
    table = np.asarray(at_export[0]["table"])
    mapped = np.unique(table[table >= 0])
    np.testing.assert_array_equal(got[1][mapped], at_export[1][mapped])
    np.testing.assert_array_equal(got[2], at_export[2])
    dst.close()
    # install plus tail replay
    rec = (jrecover(jp, export=xp, reattach=False, **_jkw("fused"))
           if src_port else recover(jp, export=xp, reattach=False,
                                    **_kw("fused")))
    info = rec.recovery_info
    assert info["installed"] is not None and info["after_seq"] > 0
    assert 0 < info["replayed"] < info["sealed_records"]
    for v in vids:
        assert rec.open(v).read(0, rec.capacity) == want[v]
    rec.close()


# ---------------------------------------------------------------------------
# 4. the cold-extent spill tier
# ---------------------------------------------------------------------------
def test_tier_serves_reads_at_2x_over_subscription():
    # 2 volumes x PAGES pages = 16 mapped extents vs an 8-extent budget
    mgr = VolumeManager(tier=PAGES, **_kw("fused"))
    cap, pby = mgr.capacity, mgr.page_bytes
    vids = [mgr.create().vid for _ in range(2)]
    for k, vid in enumerate(vids):
        for p in range(PAGES):
            mgr.pwrite(vid, p * pby, _pat(k * 100 + p, pby))
    mgr.flush()
    st = mgr.stats()["tier"]
    assert st["device_extents"] == PAGES
    assert st["spills"] >= 1 and st["resident"] <= PAGES
    for k, vid in enumerate(vids):            # every byte served correctly
        got = mgr.open(vid).read(0, cap)
        want = b"".join(_pat(k * 100 + p, pby) for p in range(PAGES))
        assert got == want
    assert mgr.stats()["tier"]["fills"] >= 1  # reads faulted extents in
    mgr.close()


def test_tier_cow_snapshot_and_clone():
    mgr = VolumeManager(tier=PAGES, **_kw("fused"))
    pby = mgr.page_bytes
    vid = mgr.create().vid
    for p in range(PAGES):
        mgr.pwrite(vid, p * pby, _pat(p, pby))
    child = mgr.clone(vid)
    for p in range(PAGES // 2):               # CoW: child keeps the frozen
        mgr.pwrite(vid, p * pby, _pat(50 + p, pby))
    mgr.flush()
    for p in range(PAGES):
        want_v = _pat(50 + p if p < PAGES // 2 else p, pby)
        assert mgr.open(vid).read(p * pby, pby) == want_v
        assert child.read(p * pby, pby) == _pat(p, pby)
    mgr.close()


def test_tier_discard_and_reallocate():
    """A spilled-then-freed extent must NOT fault stale bytes over a fresh
    allocation (the tier's mapped-only eviction + reconcile rule)."""
    mgr = VolumeManager(tier=4, **_kw("fused"))
    pby = mgr.page_bytes
    vid = mgr.create().vid
    for p in range(PAGES):
        mgr.pwrite(vid, p * pby, _pat(p, pby))
    mgr.flush()                               # force spills (8 mapped vs 4)
    mgr.discard(vid, 0, mgr.capacity)         # free everything
    for p in range(PAGES):                    # reallocate with new content
        mgr.pwrite(vid, p * pby, _pat(70 + p, pby))
    mgr.flush()
    for p in range(PAGES):
        assert mgr.open(vid).read(p * pby, pby) == _pat(70 + p, pby)
    mgr.close()


def test_tier_requires_fused_backend():
    for kw in (_kw("ring", 2), _kw("sharded", 2), _kw("slots")):
        with pytest.raises(ValueError, match="fused"):
            VolumeManager(tier=4, **kw)


def test_tier_budget_validation():
    with pytest.raises(ValueError):
        ExtentTier(16, 0)


def _jstate(leaves):
    import jax.numpy as jnp
    from repro.core import dbs as jdbs
    from repro.core.slots import SlotRing as JRing
    return jdbs.DBSState(**{
        k: (JRing(**{kk: jnp.asarray(vv) for kk, vv in v.items()})
            if k == "free" else jnp.asarray(v))
        for k, v in leaves.items()})


@pytest.mark.parametrize("seed", range(4))
def test_clock_sweep_matches_reference(seed):
    """The port's array-at-a-time clock sweep evicts the reference's
    victims in its order, leaves its marks and hand, and zeroes the same
    pool rows, from random tier states (hands, marks, stamps, shields and
    budgets), over several balances in a row."""
    import jax.numpy as jnp
    from repro.durability import ExtentTier as JTier
    rng = np.random.default_rng(seed)
    n = 40
    pool = rng.random((n + 1, 2, 3)).astype(np.float32)
    jt, tt = JTier(n, 4), ExtentTier(n, 4)
    jpools, tpools = (jnp.asarray(pool),), (torch.from_numpy(pool.copy()),)
    for _ in range(6):
        mapped = rng.random(n) < 0.7
        stamps = rng.integers(0, 9, n + 1).astype(np.int32)
        seen = rng.integers(0, 9, n)
        hand = int(rng.integers(n))
        budget = int(rng.integers(1, 20))
        shield = set(int(e) for e in rng.choice(n, 4, replace=False))
        for t in (jt, tt):
            t._mapped, t._seen, t._hand = mapped.copy(), seen.copy(), hand
            t.device_extents = budget
        jt.stamps, tt.stamps = jnp.asarray(stamps), torch.from_numpy(stamps)
        jpools = jt.balance(jpools, protect=shield)
        tpools = tt.balance(tpools, protect=shield)
        assert list(jt.spilled) == list(tt.spilled)
        np.testing.assert_array_equal(jt.resident, tt.resident)
        np.testing.assert_array_equal(jt._seen, tt._seen)
        assert jt._hand == tt._hand
        np.testing.assert_array_equal(np.asarray(jpools[0]),
                                      tpools[0].numpy())
        for e in jt.spilled:
            np.testing.assert_array_equal(jt.spilled[e],
                                          tt.spilled[e].numpy())


def test_tiered_step_matches_untiered_step():
    """On the same trace under a budget of half the mapped extents, the
    tiered fused step reads the bytes the untiered one reads, spills and
    fills both happen, and its stamps after each pump, write and read
    pumps alike, equal the reference ``_stamp_tier``'s on the same state
    and batch."""
    import jax.numpy as jnp
    from repro.core import dbs as jdbs
    from repro.core.fused import FusedBatch as JBatch
    from repro.core.fused import _stamp_tier as jstamp
    from repro_torch.core import fused
    base = VolumeManager(**_kw("fused"))
    tiered = VolumeManager(tier=PAGES, **_kw("fused"))
    seen = []
    real_w, real_r = fused.step_core_tiered, fused.step_core_read_tiered

    def spy_w(table, states, pools, page_revs, stamps, batch, rr, **k):
        before, pre = stamps.numpy().copy(), convert.to_numpy(states[0])
        out = real_w(table, states, pools, page_revs, stamps, batch, rr, **k)
        seen.append((before, pre, convert.to_numpy(out[1][0]), batch,
                     out[5].numpy(), out[4].numpy().copy()))
        return out

    def spy_r(table, states, pools, stamps, batch, rr, **k):
        before, pre = stamps.numpy().copy(), convert.to_numpy(states[0])
        out = real_r(table, states, pools, stamps, batch, rr, **k)
        seen.append((before, None, pre, batch, out[2].numpy(),
                     out[1].numpy().copy()))
        return out

    fused.step_core_tiered, fused.step_core_read_tiered = spy_w, spy_r
    try:
        pby = base.page_bytes
        vids = []
        for m in (base, tiered):
            vids = [m.create().vid for _ in range(2)]
        for k in range(3 * PAGES):           # CoW overwrites after k=PAGES
            vid, p = vids[k % 2], (k // 2 * 3) % PAGES
            for m in (base, tiered):
                m.pwrite(vid, p * pby + 5, _pat(k, pby - 9))
            if k == PAGES:
                for m in (base, tiered):
                    m.snapshot(vid)
        for m in (base, tiered):
            m.flush()
        for _round in range(2):
            for vid in vids:
                for p in range(PAGES):
                    a = base.open(vid).read(p * pby, pby)
                    assert tiered.open(vid).read(p * pby, pby) == a
    finally:
        fused.step_core_tiered, fused.step_core_read_tiered = real_w, real_r
    st = tiered.stats()["tier"]
    assert st["spills"] > 0 and st["fills"] > 0, st
    assert {pre is None for _, pre, *_ in seen} == {True, False}
    for before, pre, post, b, ok, after in seen:
        jb = JBatch(**{f.name: jnp.asarray(getattr(b, f.name).numpy())
                       for f in dataclasses.fields(b)})
        ok = jnp.asarray(ok)
        cow_src = None
        if pre is not None:
            bits = jnp.uint32(1) << jb.block.astype(jnp.uint32)
            _st, wops = jdbs.write_pages(_jstate(pre), jb.volume, jb.page,
                                         bits, ok & jb.is_write)
            cow_src = wops.cow_src
        want = jstamp(jnp.asarray(before), _jstate(post), jb, ok, cow_src)
        np.testing.assert_array_equal(np.asarray(want), after)
    base.close()
    tiered.close()


# ---------------------------------------------------------------------------
# 5. the journal in manager stats, and what waits for later slices
# ---------------------------------------------------------------------------
def test_stats_expose_journal_counters(tmp_path):
    jp = str(tmp_path / "wal.dbsj")
    mgr = VolumeManager(journal=jp, **_kw("fused"))
    vid = mgr.create().vid
    for i in range(3):
        mgr.pwrite(vid, i * BB, _pat(i, BB))
    mgr.flush(durable=True)
    js = mgr.stats()["journal"]
    # create + the 3 adjacent same-volume writes coalesced into ONE record
    assert js["records"] == 2
    assert js["appends"] <= 2                 # group commit, not per-op
    mgr.close()


def test_stream_store_waits_for_the_checkpoint_slice(tmp_path):
    """``stream_store`` no longer waits: between two checkpoint stores (the
    donor with two versions, a torn head and a leaf of 3 chunks) it gives
    the reference's summary and target file, byte for byte."""
    from repro.checkpoint import CheckpointStore as JStore
    from repro.durability.export import stream_store as j_stream
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.durability import stream_store
    rng = np.random.default_rng(0)
    trees = [{"w": rng.normal(size=(200, 160)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
             for _ in range(2)]
    out = {}
    for pkg, store, stream in (("j", JStore, j_stream),
                               ("t", CheckpointStore, stream_store)):
        donor = store(str(tmp_path / f"{pkg}_donor.dbs"),
                      capacity_bytes=1 << 22)
        for step, tree in enumerate(trees):
            donor.save("train", step, tree)
        donor.dev.write("train", 0, b"\xff" * 4096)      # a torn head
        target = store(str(tmp_path / f"{pkg}_target.dbs"),
                       capacity_bytes=1 << 22)
        out[pkg] = stream(donor, target, chunk_blocks=16)
        step, back = target.restore("train", like=trees[1])
        assert step == 1
        np.testing.assert_array_equal(np.asarray(back["w"]), trees[1]["w"])
        donor.close()
        target.close()
    assert out["t"] == out["j"]
    assert out["t"]["counters"]["sent"]["STREAM"] >= 3
    with open(tmp_path / "t_target.dbs", "rb") as f_t, \
            open(tmp_path / "j_target.dbs", "rb") as f_j:
        assert f_t.read() == f_j.read()
