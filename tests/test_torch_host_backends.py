"""Port parity: the host-dispatch backends (``loop``, ``slots``), the
sequential host backend (``host``) and ``ReplicaGroup.write``/``read``.

1. Twins of tests/test_blockdev.py's backend matrix for ``host``, ``loop``
   and ``slots``: the interleaved byte scenario against a bytearray oracle,
   and seeded byte traces through the JAX and the port managers: every read
   returns the same bytes, and at the end the replica state (``loop``,
   ``slots``: every replica's ``DBSState``, watermarks and pool; ``host``:
   its one state and pool) is equal.
2. The port's fused engine (``cuda`` and ``copy`` entries) against its
   ``slots`` engine on a mixed CoW workload (twin of tests/test_fused.py).
3. ``VolumeManager(backend="host", null_storage=True).alloc_pages``, the
   serving baseline's control plane, against the JAX package's.
4. ``ReplicaGroup.write``/``read`` under ``all``/``rr``, with a failed
   replica, then its rebuild, against the JAX group; control kinds
   rejected at submit.
5. A ``slots`` pump makes one host copy per read dispatch.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.blockdev import VolumeManager as JManager  # noqa: E402
from repro.core.replication import ReplicaGroup as JGroup  # noqa: E402
from repro_torch.core import Engine, EngineConfig, Request  # noqa: E402
from repro_torch.core import backends as tbackends  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core.blockdev import VolumeManager  # noqa: E402
from repro_torch.core.replication import ReplicaGroup  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_blockdev import (GEOM, _assert_same_replicas,  # noqa: E402
                                 _replay, _trace, interleaved_scenario)

BACKENDS = ["host", "loop", "slots"]
BB, PB = GEOM["payload_elems"], GEOM["page_blocks"]


def _mgr(backend, **kw) -> VolumeManager:
    return VolumeManager(**{"backend": backend, "device": "cpu", **GEOM,
                            "n_extents": 256, **kw})


def _same_state(jm, tm):
    """Equal engine state at the end of a trace: the host backend's one
    state and pool, else every replica's state, watermarks and pool."""
    if tm.backend_name != "host":
        _assert_same_replicas(jm, tm)
        return
    ji, ti = jm.engine.impl, tm.engine.impl
    jst = jax.device_get(dataclasses.asdict(ji.state))
    tst = convert.to_numpy(ti.state)

    def cmp(a, b, path):
        if isinstance(a, dict):
            for k in a:
                cmp(a[k], b[k], f"{path}.{k}")
            return
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    cmp(jst, tst, "state")
    assert np.array_equal(np.asarray(ji.pool), ti.pool.numpy()), "pool"


@pytest.mark.parametrize("backend", BACKENDS)
def test_byte_equivalence_interleaved(backend):
    interleaved_scenario(_mgr(backend))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", BACKENDS)
def test_seeded_trace_matches_jax(backend, seed):
    jm = JManager(backend=backend, **GEOM)
    tm = VolumeManager(backend=backend, device="cpu", **GEOM)
    ops = _trace(seed, 70, jm.capacity)
    outs = ([], [])
    for m, out in zip((jm, tm), outs):
        vols = [m.create(), m.create()]
        _replay(m, ops, vols, out)
    assert outs[0] == outs[1]
    assert len(outs[1]) > 10
    _same_state(jm, tm)


def _engine(comm, **kw):
    return Engine(EngineConfig(comm=comm, payload_shape=(8,), n_extents=256,
                               max_pages=128, batch=16, n_replicas=2,
                               device="cpu", **kw))


@pytest.mark.parametrize("kernel", ["cuda", "copy"])
def test_fused_matches_slots_volume_contents(kernel):
    engs = [_engine("slots"), _engine("fused", kernel=kernel)]
    vols = [e.create_volume() for e in engs]
    for i in range(60):                       # base data
        pay = np.full((8,), float(i + 1), np.float32)
        for e, v in zip(engs, vols):
            e.submit(Request(req_id=i, kind="write", volume=v, page=i % 48,
                             block=i % 8, payload=pay))
    for e in engs:
        assert e.drain() == 60
    for e, v in zip(engs, vols):
        e.snapshot(v)
    for i in range(30):                       # CoW overwrites, reads mixed in
        pay = np.full((8,), float(1000 + i), np.float32)
        for e, v in zip(engs, vols):
            e.submit(Request(req_id=i, kind="write", volume=v, page=i % 24,
                             block=(i * 3) % 8, payload=pay))
            e.submit(Request(req_id=i + 500, kind="read", volume=v,
                             page=i % 24, block=0))
    done = [e.drain() for e in engs]
    assert done[0] == done[1] == 60
    pages = torch.arange(48)
    for blk in range(8):
        offs = torch.full((48,), blk, dtype=torch.int32)
        a = engs[0].backend.read(vols[0], pages, offs)
        b = engs[1].backend.read(vols[1], pages, offs)
        assert torch.equal(a, b), f"block {blk}"
    assert all(e.backend.consistent() for e in engs)
    for e in engs:                            # identical replica state
        st = [convert.to_numpy(r.state) for r in e.backend.replicas]
        assert all(np.array_equal(st[0]["table"], s["table"]) for s in st)


def test_serving_allocates_pages_through_volumemanager():
    """The copy-based serving baseline's control plane: a host-backend
    manager with no pool returns the same WriteOps as the JAX package's."""
    kw = dict(backend="host", null_storage=True, n_extents=64,
              max_volumes=8, max_pages=4, page_blocks=4, payload_elems=1)
    jm, tm = JManager(**kw), VolumeManager(device="cpu", **kw)
    assert tm.engine.impl.pool is None
    jv, tv = jm.create(), tm.create()
    assert jv.vid == tv.vid
    jops = jm.alloc_pages(jnp.asarray([jv.vid], jnp.int32),
                          jnp.asarray([0], jnp.int32),
                          mask=jnp.asarray([True]))
    tops = tm.alloc_pages(torch.tensor([tv.vid]), torch.tensor([0]),
                          mask=torch.tensor([True]))
    assert bool(tops.ok[0]) and int(tops.dst[0]) >= 0
    assert int(tm.state.table[tv.vid, 0]) == int(tops.dst[0])
    for f in ("dst", "cow_src", "ok"):
        assert np.array_equal(np.asarray(getattr(jops, f)),
                              getattr(tops, f).numpy()), f
    # a clone shares the page; both sides' next allocation CoWs it
    jc, tc = jm.clone(jv), tm.clone(tv)
    assert jc.vid == tc.vid != tv.vid
    jops = jm.alloc_pages(jnp.asarray([jv.vid, jc.vid, jv.vid], jnp.int32),
                          jnp.asarray([0, 0, 1], jnp.int32),
                          mask=jnp.asarray([True, True, False]))
    tops = tm.alloc_pages(torch.tensor([tv.vid, tc.vid, tv.vid]),
                          torch.tensor([0, 0, 1]),
                          mask=torch.tensor([True, True, False]))
    assert int((tops.cow_src >= 0).sum()) == 2
    for f in ("dst", "cow_src", "ok"):
        assert np.array_equal(np.asarray(getattr(jops, f)),
                              getattr(tops, f).numpy()), f
    assert np.array_equal(np.asarray(jm.state.table),
                          tm.device_extent_map().numpy())
    tm.delete(tc)
    tm.delete(tv)
    stats = tm.stats()
    assert stats["backend"] == "host" and "slots_active" not in stats
    from repro_torch.core import dbs
    assert dbs.stats(tm.state)["extents_used"] == 0


def test_replica_group_write_and_read_all_rr():
    """Mirror-to-all writes and round-robin reads through the transport,
    with a replica failed mid-stream: the same reads, states and cursor as
    the JAX group."""
    kw = dict(n_replicas=3, n_extents=32, max_volumes=4, max_pages=16,
              page_blocks=8, payload_shape=(4,))
    jg, tg = JGroup(**kw), ReplicaGroup(**kw, device=torch.device("cpu"))
    assert jg.create_volume() == tg.create_volume() == 0
    pages = np.arange(4, dtype=np.int32)
    offs = np.zeros(4, np.int32)
    payload = np.arange(16, dtype=np.float32).reshape(4, 4)

    def both(fn, *a, mask=None):
        jout = getattr(jg, fn)(0, *(jnp.asarray(x) for x in a),
                               **({} if mask is None
                                  else {"mask": jnp.asarray(mask)}))
        tout = getattr(tg, fn)(0, *(torch.from_numpy(x) for x in a),
                               **({} if mask is None
                                  else {"mask": torch.from_numpy(mask)}))
        assert jg._rr == tg._rr
        if fn == "read":
            assert np.array_equal(np.asarray(jout), tout.numpy())
            return tout.numpy()

    both("write", pages, offs, payload)
    assert tg.consistent()
    for _ in range(3):                        # one read per replica
        assert np.array_equal(both("read", pages, offs), payload)
    tg.fail(1)
    jg.fail(1)
    for _ in range(3):                        # replica 1's turn passes on
        assert np.array_equal(both("read", pages, offs), payload)
    both("write", pages, offs + 1, payload * 2,
         mask=np.array([True, False, True, True]))   # writes while degraded
    got = both("read", pages, offs + 1)
    assert np.array_equal(got[[0, 2, 3]], (payload * 2)[[0, 2, 3]])
    assert not got[1].any()                   # the masked lane: a hole
    assert both("read", pages + 8, offs).sum() == 0   # unwritten: zeros
    for j, t in zip(jg.replicas, tg.replicas):
        jst = jax.device_get(dataclasses.asdict(j.state))
        tst = convert.to_numpy(t.state)
        for k in jst:
            if k != "free":
                assert np.array_equal(np.asarray(jst[k]), tst[k]), k
        assert np.array_equal(np.asarray(j.pool), t.pool.numpy())
        assert np.array_equal(np.asarray(j.page_rev), t.page_rev.numpy())
    assert tg.consistent()
    jg.rebuild(1)                             # the streamed delta rebuild
    tg.rebuild(1)
    assert tg.transports[1].pages_moved == jg.transports[1].pages_moved > 0
    for j, t in zip(jg.replicas, tg.replicas):
        jst = jax.device_get(dataclasses.asdict(j.state))
        tst = convert.to_numpy(t.state)
        for k in jst:
            if k != "free":
                assert np.array_equal(np.asarray(jst[k]), tst[k]), k
        assert np.array_equal(np.asarray(j.pool), t.pool.numpy())
        assert np.array_equal(np.asarray(j.page_rev), t.page_rev.numpy())
    assert tg.consistent()
    tg.fail(0)
    tg.fail(2)
    jg.fail(0)
    jg.fail(2)                                # the rebuilt replica serves
    got = both("read", pages, offs + 1)
    assert np.array_equal(got[[0, 2, 3]], (payload * 2)[[0, 2, 3]])


@pytest.mark.parametrize("backend", BACKENDS)
def test_control_rejected_at_submit_data_survives(backend):
    mgr = _mgr(backend)
    v = mgr.create()
    eng = mgr.engine
    w = Request(req_id=0, kind="write", volume=v.vid, page=0, block=0,
                payload=np.full((BB,), 7.0, np.float32))
    eng.submit(w)
    for kind in ("snapshot", "clone", "unmap", "noop"):
        with pytest.raises(ValueError):
            eng.submit(Request(req_id=1, kind=kind, volume=v.vid))
    if backend != "host":                     # the host oracle takes compute
        with pytest.raises(ValueError):
            eng.submit(Request(req_id=1, kind="compute", volume=v.vid,
                               fn="checksum"))
    assert eng.depth() == 1                   # the data request is intact
    assert eng.drain() == 1 and w.status == 0
    mgr.snapshot(v)
    assert v.read(0, BB) == bytes(bytearray([7] * BB))
    if backend == "host":
        # a compute request rides the oracle's FIFO behind the data and
        # returns what the JAX package's host oracle returns for the same
        # bytes
        jm = JManager(**{"backend": "host", **GEOM, "n_extents": 256})
        jv = jm.create()
        jv.write(0, bytes([7] * BB))
        outs = []
        for m, vol in ((jm, jv), (mgr, v)):
            r = vol.compute("verify_on_read", 0).result()
            c = vol.compute("checksum").result()
            outs.append((r.value, r.status, r.data(), c.value, c.status))
        assert outs[0] == outs[1]
        assert outs[1][2] == bytes([7] * BB)


def test_slots_pump_fetches_once_per_read_dispatch(monkeypatch):
    """Reads are padded to the admission batch and dispatched a batch at a
    time; each dispatch makes ONE host copy of its results (no per-lane
    device indexing). The loop backend dispatches each read alone."""
    for comm, n_reads, want in (("slots", 20, 2), ("loop", 3, 3)):
        eng = Engine(EngineConfig(comm=comm, payload_shape=(4,), batch=16,
                                  n_slots=64, n_extents=64, max_pages=32,
                                  device="cpu"))
        vol = eng.create_volume()
        eng.submit(Request(req_id=0, kind="write", volume=vol, page=1,
                           block=2, payload=np.full(4, 5.0, np.float32)))
        eng.drain()
        eng.frontend.batch = 32               # one admission for all reads
        calls = []
        real = tbackends.fetch_to_host
        monkeypatch.setattr(tbackends, "fetch_to_host",
                            lambda *t: calls.append(len(t)) or real(*t))
        rs = [Request(req_id=1 + i, kind="read", volume=vol, page=i % 3,
                      block=2) for i in range(n_reads)]
        for r in rs:
            eng.submit(r)
        assert eng.pump() == n_reads
        monkeypatch.setattr(tbackends, "fetch_to_host", real)
        assert calls == [1] * want, (comm, calls)
        for r in rs:
            assert isinstance(r.result, np.ndarray)
            assert r.result.tolist() == ([5.0] * 4 if r.page == 1
                                         else [0.0] * 4)
