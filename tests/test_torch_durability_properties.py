"""Port parity: property tests, random traces x random crash points
through the port's durability package (``device="cpu"``).

Twins of tests/test_durability_properties.py, on the same seeds and
geometry.

Seeded-random interleavings of ``pwrite``/``discard``/``flush`` and CRASH
points — the manager abandoned mid-trace (optionally with a half-written
record torn onto the journal tail) and recovered from the WAL — must leave
every byte equal to a host bytearray oracle, (a) under plain journal
replay, (b) with crashes racing an incremental delta export (recovery
installs the newest section and replays only the sealed tail), and (c)
with the cold-extent spill tier over-subscribed, so crashes land between
spill/fill cycles and recovery rebuilds a tiered pool.

The generator is a hand-rolled ``random.Random`` walk: every trace is
reproducible from its seed parameter alone.
"""
import os
import random
import shutil
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.blockdev import VolumeManager  # noqa: E402
from repro_torch.core.transport import MSG_WRITE, WireMsg  # noqa: E402
from repro_torch.durability import SnapshotExport, recover  # noqa: E402
from repro_torch.durability.journal import encode_record  # noqa: E402

BB = 8          # block_bytes
PB = 4          # page_blocks -> page_bytes = 32
PAGES = 8       # capacity = 256 bytes
_CAP = PAGES * PB * BB


def _kw(**kw):
    base = dict(backend="fused", payload_elems=BB, page_blocks=PB,
                max_pages=PAGES, n_extents=128, max_volumes=8, batch=16,
                n_replicas=2, device="cpu")
    base.update(kw)
    return base


def _gen_ops(seed: int, n: int = 12):
    """One reproducible random trace: writes/discards/flushes with crash
    points sprinkled in, plus a guaranteed trailing crash on odd seeds so
    every other trace ends in recovery."""
    rng = random.Random(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.50:
            ops.append(("write", rng.randrange(_CAP),
                        rng.randint(1, 3 * PB * BB), rng.randrange(251)))
        elif r < 0.70:
            ops.append(("discard", rng.randrange(_CAP),
                        rng.randint(1, 3 * PB * BB)))
        elif r < 0.85:
            ops.append(("flush",))
        else:
            ops.append(("crash", rng.random() < 0.5))
    if seed % 2:
        ops.append(("crash", seed % 4 == 1))
    return ops


def _tear(jp: str) -> None:
    """Append half a valid record: a crash mid-group-commit."""
    rec = encode_record(10 ** 9, WireMsg(
        op=MSG_WRITE, volume=0, pages=np.asarray([0], np.int32),
        blocks=np.asarray([0], np.int32),
        payload=np.zeros((1, BB), np.float32)))
    with open(jp, "ab") as f:
        f.write(rec[:len(rec) // 2])


def _drive(ops, *, tier=None, export_every: int = 0) -> None:
    tmp = tempfile.mkdtemp(prefix="repro-torch-dur-prop-")
    jp = os.path.join(tmp, "wal.dbsj")
    xp = os.path.join(tmp, "inc.dbsx")
    kw = _kw(**({} if tier is None else {"tier": tier}))
    mgr = VolumeManager(journal=jp, **kw)
    exp = SnapshotExport(xp) if export_every else None
    vid = mgr.create().vid
    ref = bytearray(mgr.capacity)
    n_mut = 0
    try:
        for op in ops:
            if op[0] == "write":
                _, off, n, seed = op
                n = min(n, _CAP - off)
                data = bytes((seed + i) % 251 for i in range(n))
                mgr.pwrite(vid, off, data)
                ref[off:off + n] = data
                n_mut += 1
            elif op[0] == "discard":
                _, off, n = op
                n = min(n, _CAP - off)
                mgr.discard(vid, off, n)
                ref[off:off + n] = bytes(n)
                n_mut += 1
            elif op[0] == "flush":
                mgr.flush()
            else:                                     # crash
                mgr.flush(durable=True)
                if op[1]:
                    _tear(jp)
                use_exp = xp if exp is not None and exp.sections else None
                mgr = recover(jp, export=use_exp, **kw)
                assert mgr.open(vid).read(0, _CAP) == bytes(ref)
            if (export_every and n_mut
                    and n_mut % export_every == 0 and op[0] != "crash"):
                exp.export(mgr, journal=mgr._journal)
        mgr.flush()
        assert mgr.open(vid).read(0, _CAP) == bytes(ref)
    finally:
        mgr.close()
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("seed", range(10))
def test_property_random_crash_replay(seed):
    _drive(_gen_ops(seed))


@pytest.mark.parametrize("seed", range(10, 18))
def test_property_crash_racing_delta_export(seed):
    _drive(_gen_ops(seed), export_every=2)


@pytest.mark.parametrize("seed", range(20, 28))
def test_property_crash_between_spill_fill_cycles(seed):
    _drive(_gen_ops(seed), tier=3)                    # 3 of 8 extents hot
