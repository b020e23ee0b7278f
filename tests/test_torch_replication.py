"""Port parity: ``ReplicaGroup`` contracts (tests/test_replication.py), the
fused engine's null layer cuts (tests/test_fused.py
``test_fused_null_rows_complete``) and the host backend under either cut.

Each test feeds the same inputs to the JAX package's group or engine and to
the port's (``device="cpu"``) and requires the same results: read values,
cursor, health marks, and at the end every replica's state, pool and
watermarks bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import Engine as JEngine  # noqa: E402
from repro.core import EngineConfig as JConfig  # noqa: E402
from repro.core import Request as JRequest  # noqa: E402
from repro.core.replication import ReplicaGroup as JGroup  # noqa: E402
from repro_torch.core import Engine, EngineConfig, Request  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import dbs as tdbs  # noqa: E402
from repro_torch.core.replication import ReplicaGroup  # noqa: E402

GEOM = dict(n_replicas=2, n_extents=64, max_volumes=4, max_pages=32,
            page_blocks=8, payload_shape=(4,))


def _groups(**kw):
    return (JGroup(**{**GEOM, **kw}),
            ReplicaGroup(**{**GEOM, **kw}, device=torch.device("cpu")))


def _lanes(n):
    return (np.arange(n, dtype=np.int32), np.zeros(n, np.int32))


def _both(jg, tg, fn, vol, *arrays):
    """Call ``fn`` on both groups with the same numpy lanes; returns the
    two results as numpy (None where there is none)."""
    j = getattr(jg, fn)(vol, *(jnp.asarray(a) for a in arrays))
    t = getattr(tg, fn)(vol, *(torch.from_numpy(np.asarray(a))
                               for a in arrays))
    assert jg._rr == tg._rr
    return (None if j is None else np.asarray(jax.device_get(j)),
            None if t is None else t.numpy())


def _same_replicas(jg, tg):
    for i, (j, t) in enumerate(zip(jg.replicas, tg.replicas)):
        assert j.healthy == t.healthy, i
        jst = jax.device_get(dataclasses.asdict(j.state))
        tst = convert.to_numpy(t.state)
        for k in jst:
            if k != "free":
                assert np.array_equal(np.asarray(jst[k]), tst[k]), (i, k)
        assert np.array_equal(np.asarray(j.pool), t.pool.numpy()), i
        assert np.array_equal(np.asarray(j.page_rev), t.page_rev.numpy()), i


def test_null_storage_read_dispatches_nothing(monkeypatch):
    """The null-storage read resolves nothing on the device (the layer cut
    measures the stack without storage work) and returns zeros of the real
    read's shape, as the reference does."""
    jg, tg = _groups(null_storage=True)
    assert jg.create_volume() == tg.create_volume() == 0
    calls = []
    real = tdbs.read_resolve
    monkeypatch.setattr(tdbs, "read_resolve",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    j, t = _both(jg, tg, "read", 0, *_lanes(8))
    assert t.shape == j.shape == (8, 4)
    assert np.array_equal(j, t) and not t.any()
    assert calls == [], f"null-storage read dispatched {len(calls)} resolves"


def test_null_storage_read_leaves_rr_alone():
    jg, tg = _groups(null_storage=True)
    jg.create_volume(), tg.create_volume()
    before = tg._rr
    for _ in range(2):
        _both(jg, tg, "read", 0, *_lanes(4))
    assert tg._rr == before == jg._rr


def test_null_storage_read_matches_real_read_shape():
    outs = []
    for kw in ({}, dict(null_storage=True)):
        jg, tg = _groups(**kw)
        for g, mk in ((jg, jnp.asarray), (tg, torch.from_numpy)):
            vol = g.create_volume()
            pages, offs = _lanes(4)
            g.write(vol, mk(pages), mk(offs), mk(np.ones((4, 4), np.float32)))
        outs.append(_both(jg, tg, "read", 0, *_lanes(4)))
        _same_replicas(jg, tg)      # null_storage: metadata, no pool write
    (ja, ta), (jb, tb) = outs
    assert ta.shape == tb.shape == ja.shape == jb.shape
    assert ta.dtype == tb.dtype == np.float32
    assert ta.all() and not tb.any()


def test_fail_validates_index():
    for g in _groups():
        with pytest.raises(IndexError):
            g.fail(2)
        with pytest.raises(IndexError):
            g.fail(-1)
        g.fail(1)                                   # in range: fine
        assert not g.replicas[1].healthy


def test_rebuild_rejects_healthy_replica():
    jg, tg = _groups()
    for g in (jg, tg):
        g.create_volume()
    pages, offs = _lanes(4)
    _both(jg, tg, "write", 0, pages, offs, np.ones((4, 4), np.float32))
    for g in (jg, tg):
        with pytest.raises(ValueError):
            g.rebuild(0)                            # nothing failed
        with pytest.raises(IndexError):
            g.rebuild(9)
        g.fail(0)
    _both(jg, tg, "write", 0, pages, offs + 1,
          np.full((4, 4), 2.0, np.float32))         # replica 0 misses this
    for g in (jg, tg):
        g.rebuild(0)                                # valid: was failed
        assert g.replicas[0].healthy and g.consistent()
    assert tg.transports[0].pages_moved == jg.transports[0].pages_moved == 4
    _same_replicas(jg, tg)


def test_fail_refuses_last_healthy_replica():
    for g in _groups():
        g.fail(0)
        with pytest.raises(RuntimeError):
            g.fail(1)
        g.rebuild(0)
        g.fail(1)                                   # fine: 0 is healthy
        assert g.replicas[0].healthy and not g.replicas[1].healthy


@pytest.mark.parametrize("cut", ["null_backend", "null_storage"])
def test_fused_null_rows_complete(cut):
    """The ladder's layer cuts run through the fused path: every request
    completes in both packages, reads return zeros, and the replicas'
    metadata (null_storage) or nothing at all (null_backend) moves."""
    base = dict(comm="fused", n_replicas=2, payload_shape=(8,),
                n_extents=256, max_pages=64, batch=16, **{cut: True})
    engs = (JEngine(JConfig(**base)),
            Engine(EngineConfig(**base, device="cpu")))
    outs = []
    for eng, R in zip(engs, (JRequest, Request)):
        vol = eng.create_volume()
        rs = [R(req_id=i, kind="write" if i % 2 else "read", volume=vol,
                page=i % 64, block=0, payload=np.ones(8, np.float32))
              for i in range(40)]
        for r in rs:
            eng.submit(r)
        assert eng.drain() == 40, cut
        outs.append([None if r.result is None else np.asarray(r.result)
                     for r in rs if r.kind == "read"])
        assert all(r.status == 0 for r in rs)
    for a, b in zip(*outs):
        assert (a is None) == (b is None)
        assert a is None or (np.array_equal(a, b) and not b.any())
    if cut == "null_backend":
        assert engs[0].backend is None and engs[1].backend is None
        assert engs[1].impl.clone(0) == -1
    else:
        _same_replicas(engs[0].backend, engs[1].backend)
        assert int(engs[1].backend.replicas[0].state.revision) > 0
        assert not engs[1].backend.replicas[0].pool.any()


@pytest.mark.parametrize("cut", ["null_backend", "null_storage"])
def test_host_backend_holds_no_pool_under_a_cut(cut):
    """The sequential host backend keeps its DBS state under either cut
    but holds no pool; reads return zeros in both packages."""
    from repro.core.blockdev import VolumeManager as JManager
    from repro_torch.core.blockdev import VolumeManager
    kw = dict(backend="host", n_extents=64, max_volumes=8, max_pages=4,
              page_blocks=4, payload_elems=8, **{cut: True})
    jm, tm = JManager(**kw), VolumeManager(device="cpu", **kw)
    assert jm.engine.impl.pool is None and tm.engine.impl.pool is None
    jv, tv = jm.create(), tm.create()
    assert jv.vid == tv.vid
    for v in (jv, tv):
        v.write(3, b"payload")
    assert jv.read(0, 16) == tv.read(0, 16) == bytes(16)
    assert int(tm.state.table[tv.vid, 0]) == int(jm.state.table[jv.vid, 0])
