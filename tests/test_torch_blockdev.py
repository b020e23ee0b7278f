"""Port parity: the public block device, ``VolumeManager(backend="fused")``.

1. The tests/test_blockdev.py interleaved trace against a bytearray oracle.
2. A seeded byte trace through the JAX and the port managers: every read
   returns the same bytes, and at the end every replica's ``DBSState``,
   watermarks and pool are equal.
3. ``convert`` carries a JAX engine's state into the port mid-trace, and
   both go on identically.
4. Device choice and unported configuration raise; every configuration
   the controller and shards slices brought (the upstream baseline,
   chained storage, the transports and policies, the null cuts, the
   sharded pool, the spill tier) gives the JAX package's bytes; the package imports
   neither JAX nor ``repro``.
5. The sharded pool (``backend="sharded"``) through the byte API: the
   interleaved oracle scenario, a seeded trace against the JAX pool (every
   stacked replica leaf bit for bit), one flush completing a page-crossing
   span, and control kinds refused at submit on every backend.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core.blockdev import VolumeManager as JManager  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core.blockdev import VolumeManager  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BB, PB, PAGES = 8, 4, 8              # block bytes, page blocks, pages
GEOM = dict(payload_elems=BB, page_blocks=PB, max_pages=PAGES, n_extents=64,
            max_volumes=8, batch=16, n_replicas=3)


def _mgr(**kw) -> VolumeManager:
    return VolumeManager(**{"backend": "fused", "device": "cpu", **GEOM,
                            **kw})


def _pat(seed: int, n: int) -> bytes:
    return bytes((seed * 37 + i) % 251 for i in range(n))


def interleaved_scenario(mgr):
    """tests/test_blockdev.py's interleaved byte scenario against a
    bytearray oracle: overlapping writes in flight, a page-crossing span,
    a snapshot, CoW, a diverging clone, discards, a delete; then the
    manager is closed."""
    bufs = {}

    def new_vol():
        v = mgr.create()
        bufs[v.vid] = bytearray(mgr.capacity)
        return v

    def write(v, off, data):
        bufs[v.vid][off:off + len(data)] = data
        return v.pwrite(off, data)

    def discard(v, off, n):
        bufs[v.vid][off:off + n] = bytes(n)
        return v.discard(off, n)

    def check_all():
        mgr.flush()
        for vid, buf in bufs.items():
            assert mgr.open(vid).read(0, mgr.capacity) == bytes(buf), vid

    v1, v2 = new_vol(), new_vol()
    pending = [write(v1, 0, _pat(1, 17)), write(v2, 5, _pat(2, 11)),
               write(v1, 13, _pat(3, 9))]              # overlaps in flight
    r1, e1 = v1.pread(3, 20), bytes(bufs[v1.vid][3:23])
    pending.append(write(v1, 24, _pat(4, 48)))         # page-crossing span
    r2, e2 = v2.pread(0, 32), bytes(bufs[v2.vid][0:32])
    assert all(f.result() is not None for f in pending)
    assert r1.result() == e1 and r2.result() == e2
    check_all()
    v1.snapshot()
    write(v1, 2, _pat(5, 40))                          # CoW vs snapshot
    c1 = v1.clone()
    bufs[c1.vid] = bytearray(bufs[v1.vid])
    write(c1, 0, _pat(6, 23))                          # child diverges
    write(v1, 64, _pat(7, 16))                         # parent diverges
    check_all()
    write(v2, 32, _pat(8, 96))
    discard(v2, 34, 3)                                 # sub-block
    discard(v2, 40, 20)                                # partial page
    discard(v1, 30, 70)                                # edges + full pages
    check_all()
    mgr.delete(v2)
    del bufs[v2.vid]
    v3 = new_vol()
    write(v3, 7, _pat(9, 33))
    check_all()
    if mgr.engine.backend is not None:                 # replica storage
        assert mgr.engine.backend.consistent()
    mgr.close()
    with pytest.raises(ValueError, match="closed"):
        v1.pwrite(0, b"x")


@pytest.mark.parametrize("kernel", ["cuda", "torch", "ref"])
def test_byte_equivalence_interleaved(kernel):
    interleaved_scenario(_mgr(kernel=kernel, n_extents=256))


def _trace(seed, n_ops, cap):
    """Seeded byte ops: aligned and unaligned writes, reads, discards,
    snapshot/clone/delete, as tuples that ``_replay`` applies."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_ops):
        off = int(rng.integers(0, cap - 1))
        n = int(rng.integers(1, min(3 * BB * PB, cap - off) + 1))
        if rng.random() < 0.5:                         # block-aligned span
            off -= off % BB
            n = max(BB, n - n % BB)
            n = min(n, cap - off)
        k = rng.random()
        if k < 0.45:
            ops.append(("write", off, bytes(rng.integers(0, 256, n,
                                                         dtype=np.uint8))))
        elif k < 0.85:
            ops.append(("read", off, n))
        elif k < 0.93:
            ops.append(("discard", off, n))
        else:
            ops.append((("snapshot", "clone", "delete")[i % 3], 0, 0))
    return ops


def _replay(mgr, ops, vols, out):
    futs = []
    for j, (kind, off, arg) in enumerate(ops):
        v = vols[j % len(vols)]
        if kind == "write":
            v.pwrite(off, arg)
        elif kind == "read":
            futs.append(v.pread(off, arg))
        elif kind == "discard":
            v.discard(off, arg)
        elif kind == "snapshot":
            v.snapshot()
        elif kind == "clone":
            c = v.clone()
            if c is not None:
                vols.append(c)
        elif len(vols) > 2:                           # delete a clone
            vols.pop().delete()
    mgr.flush()
    out.extend(f.result() for f in futs)


def _replica_leaves(mgr, jax_side):
    reps = mgr.engine.backend.replicas
    if jax_side:
        return [(jax.device_get(dataclasses.asdict(r.state)),
                 np.asarray(r.page_rev), np.asarray(r.pool)) for r in reps]
    return [(convert.to_numpy(r.state), r.page_rev.numpy(), r.pool.numpy())
            for r in reps]


def _assert_same_replicas(jm, tm):
    def cmp(a, b, path):
        if isinstance(a, dict):
            for k in a:
                cmp(a[k], b[k], f"{path}.{k}")
            return
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    for i, (a, b) in enumerate(zip(_replica_leaves(jm, True),
                                   _replica_leaves(tm, False))):
        cmp(a[0], b[0], f"replica {i} state")
        assert np.array_equal(a[1], b[1]), f"replica {i} page_rev"
        assert np.array_equal(a[2], b[2]), f"replica {i} pool"


def _assert_same_stacked(jm, tm):
    """Every stacked replica leaf of two sharded pools, bit for bit."""
    jg, tg = jm.engine.backend, tm.engine.backend
    np.testing.assert_array_equal(jg.healthy, tg.healthy)
    for i in range(jg.n_replicas):
        _cmp_tree(jax.device_get(dataclasses.asdict(jg.states[i])),
                  convert.to_numpy(tg.states[i]), f"replica {i} state")
        assert np.array_equal(np.asarray(jg.pools[i]),
                              tg.pools[i].numpy()), f"replica {i} pool"
    for i, (a, b) in enumerate(zip(jg.device_page_revs(),
                                   tg.device_page_revs())):
        assert np.array_equal(np.asarray(a), b.numpy()), f"replica {i} revs"


def _cmp_tree(a, b, path):
    if isinstance(a, dict):
        for k in a:
            _cmp_tree(a[k], b[k], f"{path}.{k}")
        return
    assert np.array_equal(np.asarray(a), np.asarray(b)), path


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("jkernel,tkernel", [("pallas", "cuda"),
                                             ("xla", "torch")])
def test_seeded_trace_matches_jax(jkernel, tkernel, seed):
    jm = JManager(backend="fused", kernel=jkernel, **GEOM)
    tm = _mgr(kernel=tkernel)
    ops = _trace(seed, 70, jm.capacity)
    outs = ([], [])
    for m, out in zip((jm, tm), outs):
        vols = [m.create(), m.create()]
        _replay(m, ops, vols, out)
    assert outs[0] == outs[1]
    assert len(outs[1]) > 10
    _assert_same_replicas(jm, tm)
    assert tm.engine.backend.consistent()


def _adopt(tm, jm):
    """Carry a flushed JAX manager's engine state into the port manager."""
    jb, tb = jm.engine.impl, tm.engine.impl
    for jr, tr in zip(jb.storage.replicas, tb.storage.replicas):
        (tr.state,), (tr.pool,), (tr.page_rev,) = convert.replicas_from_numpy(
            [jax.device_get(dataclasses.asdict(jr.state))],
            [np.asarray(jr.pool)], [np.asarray(jr.page_rev)], tm.device)
    tb.frontend.table = convert.table_from_numpy(
        jax.device_get(dataclasses.asdict(jb.frontend.table)), tm.device)
    tb.frontend.step = jb.frontend.step
    tb.storage._rr = jb.storage._rr
    for vid in jm.volumes:
        tm.open(vid)


def test_convert_carries_mid_trace_state():
    ops = _trace(5, 80, PAGES * PB * BB)
    jm = JManager(backend="fused", kernel="xla", **GEOM)
    vols = [jm.create(), jm.create()]
    _replay(jm, ops[:40], vols, [])
    tm = _mgr(kernel="cuda")
    _adopt(tm, jm)
    _assert_same_replicas(jm, tm)
    outs = ([], [])
    for m, out in zip((jm, tm), outs):
        _replay(m, ops[40:], [m.open(v.vid) for v in vols], out)
    assert outs[0] == outs[1]
    _assert_same_replicas(jm, tm)


@pytest.mark.parametrize("cow,jkernel,tkernel", [("pallas", "pallas", "cuda"),
                                                 ("ref", "xla", "torch")])
def test_legacy_cow_axis_matches_jax(cow, jkernel, tkernel):
    """``cow=`` with ``kernel="auto"`` picks the entry the reference's
    picks (pallas: the hand-written kernels, ``cuda``; ref: the plain
    write, ``torch`` for the reference's ``xla``), and a seeded trace on
    it reads back what the reference's does, replica for replica."""
    jm = JManager(backend="fused", cow=cow, **GEOM)
    tm = _mgr(cow=cow)
    assert jm.engine.impl._kernel == jkernel
    assert tm.engine.impl._kernel == tkernel
    ops = _trace(3, 60, jm.capacity)
    outs = ([], [])
    for m, out in zip((jm, tm), outs):
        _replay(m, ops, [m.create(), m.create()], out)
    assert outs[0] == outs[1] and len(outs[1]) > 10
    _assert_same_replicas(jm, tm)


def test_default_device_is_cuda_without_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        VolumeManager()
    with pytest.raises(RuntimeError, match="CUDA"):
        VolumeManager(backend="fused", **GEOM)


@pytest.mark.parametrize("kw,match,jax_raises", [
    # the spill tier lives in the fused step: refused elsewhere, as the
    # reference refuses it
    (dict(backend="sharded", n_shards=2, tier=8), "needs comm='fused'",
     True),
    # the legacy data-plane axis knows auto, pallas and ref alone
    (dict(cow="bogus"), "unknown cow impl", True),
    # not a storage: the fused backend refuses it as the reference does
    (dict(storage="upstream"), "requires storage='dbs'", True),
])
def test_unported_configuration_raises(kw, match, jax_raises):
    with pytest.raises(ValueError, match=match):
        _mgr(**kw)
    if jax_raises:
        with pytest.raises(ValueError, match=match):
            JManager(**{"backend": "fused", **GEOM, **kw})


@pytest.mark.parametrize("kw", [
    dict(backend="slots", null_storage=True),
    dict(backend="upstream"),
    dict(transport="simnet"),
    dict(backend="slots", transport="simnet", write_policy="quorum",
         transport_opts=dict(latency=[1, 1, 4], window=4)),
    dict(backend="slots", read_policy="latency"),
    dict(null_backend=True),
    dict(null_storage=True),
    dict(backend="loop", storage="chained"),
    dict(backend="sharded", n_shards=2),
    dict(backend="sharded", n_shards=2, null_storage=True),
    dict(n_shards=2),
    dict(backend="ring"),
    dict(backend="ring", n_shards=2),
    dict(backend="ring", n_shards=2, null_storage=True),
    dict(backend="ring", null_backend=True),
    dict(tier=2),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()
                           if k != "transport_opts"))
def test_ported_configuration_matches_jax(kw):
    """Each configuration the controller slice brings builds in both
    packages, and a short byte round trip (unaligned writes, a snapshot,
    CoW overwrites, a discard) reads the same bytes; under the null cuts
    every read is zeros. Where the storage is DBS replicas, their states,
    watermarks and pools end equal too."""
    jm = JManager(**{"backend": "fused", **GEOM, **kw})
    tm = _mgr(**kw)
    outs = []
    for m in (jm, tm):
        v = m.create()
        v.write(5, _pat(1, 40))
        v.snapshot()
        v.write(30, _pat(2, 70))
        v.discard(40, 60)
        outs.append(v.read(0, m.capacity))
        m.close()
    assert outs[0] == outs[1]
    cut = kw.get("null_backend") or kw.get("null_storage")
    assert (outs[1] == bytes(tm.capacity)) == bool(cut)
    if hasattr(tm.engine.backend, "replicas"):
        _assert_same_replicas(jm, tm)
    if hasattr(tm.engine.backend, "states"):
        _assert_same_stacked(jm, tm)


def test_unported_calls_raise():
    mgr = _mgr()
    v = mgr.create()
    with pytest.raises(ValueError, match="unknown storage function"):
        v.compute("no_such_function")
    with pytest.raises(ValueError, match="out of range"):
        from repro_torch.core import Request
        mgr.submit(Request(req_id=0, kind="write", volume=v.vid,
                           page=PAGES, block=0))
    with pytest.raises(ValueError, match="comm='ring'|backend='ring'"):
        from repro_torch.core import Request
        mgr.submit(Request(req_id=0, kind="snapshot", volume=v.vid))


def test_port_imports_no_jax_and_no_repro():
    code = ("import sys, repro_torch.core.blockdev, "
            "repro_torch.kernels._build, repro_torch.serving.engine, "
            "repro_torch.kernels.paged_attention, "
            "repro_torch.kernels.flash_attention, repro_torch.durability, "
            "repro_torch.examples.serve_paged, "
            "repro_torch.examples.fork_sessions, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.train_lm; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)[\s.])",
                     re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        assert not pat.search(f.read_text()), f


# ---------------------------------------------------------------------------
# 5. the sharded pool through the byte API
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_byte_equivalence_interleaved_sharded(kernel):
    interleaved_scenario(_mgr(backend="sharded", n_shards=2, kernel=kernel,
                              n_extents=128))


@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_seeded_trace_matches_jax(seed):
    """The seeded byte trace over volumes spread on two shards: the same
    bytes from every read, and every stacked replica leaf of the two
    pools equal at the end."""
    kw = dict(GEOM, backend="sharded", n_shards=2)
    jm = JManager(kernel="pallas", **kw)
    tm = VolumeManager(kernel="cuda", device="cpu", **kw)
    ops = _trace(seed, 70, jm.capacity)
    outs = ([], [])
    for m, out in zip((jm, tm), outs):
        vols = [m.create(), m.create(), m.create()]
        _replay(m, ops, vols, out)
    assert outs[0] == outs[1]
    assert len(outs[1]) > 10
    _assert_same_stacked(jm, tm)
    assert tm.engine.backend.consistent()


@pytest.mark.parametrize("backend,shards", [("sharded", 2), ("fused", 1),
                                            ("ring", 2), ("ring", 1)])
def test_large_span_fans_out_and_completes_on_flush(backend, shards):
    """One call fans out to many block requests, completed by ONE flush
    (no per-block host round trip); the bytes round-trip exactly."""
    mgr = _mgr(backend=backend, n_shards=shards, n_extents=128)
    v = mgr.create()
    data = _pat(11, 5 * mgr.page_bytes + 3)             # cross-extent span
    fut = v.pwrite(3, data)
    rfut = v.pread(3, len(data))
    assert not fut.done()
    mgr.flush()
    assert fut.done() and rfut.done()
    assert fut.result() == len(data)
    assert rfut.result() == data


@pytest.mark.parametrize("backend,shards", [("upstream", 1), ("loop", 1),
                                            ("slots", 1), ("fused", 1),
                                            ("sharded", 2), ("host", 1)])
def test_control_rejected_at_submit_data_survives(backend, shards):
    """On the data-only backends a control kind is refused at submit,
    before it is queued, so the data request queued beside it survives;
    the same op then goes through the control plane."""
    from repro_torch.core import Request
    mgr = _mgr(backend=backend, n_shards=shards, n_extents=128)
    v = mgr.create()
    eng = mgr.engine
    w = Request(req_id=0, kind="write", volume=v.vid, page=0, block=0,
                payload=np.full((BB,), 7.0, np.float32))
    eng.submit(w)
    for kind in ("snapshot", "clone", "unmap", "noop"):
        with pytest.raises(ValueError):
            eng.submit(Request(req_id=1, kind=kind, volume=v.vid))
    assert eng.depth() == 1
    assert eng.drain() == 1 and w.status == 0
    mgr.snapshot(v)
    assert v.read(0, BB) == bytes([7] * BB)


# ---------------------------------------------------------------------------
# 6. the ring through the byte API (tests/test_blockdev.py's ring cases)
# ---------------------------------------------------------------------------
def test_default_backend_is_ring():
    """As in the reference, the manager's default backend is the ring, and
    with no device it targets the card (tested above)."""
    mgr = VolumeManager(device="cpu", **GEOM)
    assert mgr.backend_name == JManager(**GEOM).backend_name == "ring"
    assert mgr._inband and mgr.engine.pool is mgr.engine.impl


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("kernel", ["cuda", "torch", "copy"])
def test_byte_equivalence_interleaved_ring(kernel, shards):
    interleaved_scenario(_mgr(backend="ring", n_shards=shards, kernel=kernel,
                              n_extents=128))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shards", [1, 2])
def test_ring_seeded_trace_matches_jax(seed, shards):
    """The seeded byte trace on the ring, its snapshots, clones, discards
    and deletes in-band: the same bytes from every read, and every stacked
    replica leaf equal at the end."""
    kw = dict(GEOM, backend="ring", n_shards=shards)
    jm = JManager(kernel="pallas", **kw)
    tm = VolumeManager(kernel="cuda", device="cpu", **kw)
    ops = _trace(seed, 70, jm.capacity)
    outs = ([], [])
    for m, out in zip((jm, tm), outs):
        vols = [m.create(), m.create(), m.create()]
        _replay(m, ops, vols, out)
    assert outs[0] == outs[1]
    _assert_same_stacked(jm, tm)
    assert tm.engine.backend.consistent()


def test_api_one_program_per_class_signature():
    """Byte traffic with in-band control (a snapshot, a discard's UNMAP):
    the reference compiles one program a signature and none for more
    traffic; the port pumps the same signatures, adds none for more
    traffic, and completes a whole page span with one host fetch."""
    outs = []
    for m in (JManager(backend="ring", n_shards=2, n_queues=1, **GEOM),
              _mgr(backend="ring", n_shards=2, n_queues=1)):
        pool = m.engine.pool
        vols = [m.create() for _ in range(4)]

        def traffic():
            futs = []
            for i, v in enumerate(vols):
                futs.append(v.pwrite(0, _pat(i, m.page_bytes)))
                futs.append(v.pread(i * BB, 3 * BB))
            vols[0].snapshot()
            m.discard(vols[1], 0, m.page_bytes)
            m.flush()
            return [f.result() for f in futs]
        first = traffic()
        counts = getattr(pool, "trace_counts", None)
        before = set(pool.step_counts if counts is None else counts)
        d0 = pool.dispatches
        assert traffic() == first
        after = set(pool.step_counts if counts is None else counts)
        assert after == before and pool.dispatches > d0
        outs.append((first, sorted(before), pool.dispatches))
    assert outs[0] == outs[1]
    pool = m.engine.pool
    fut = vols[2].pwrite(0, _pat(3, m.page_bytes))
    calls = []
    real = pool._fetch
    pool._fetch = lambda p: (calls.append(1), real(p))[1]
    assert pool.pump() == PB and calls == [1]
    assert fut.result() == m.page_bytes


def test_mixed_kind_batch_inband_on_ring():
    from repro.core.frontend import Request as JRequest
    from repro_torch.core import Request
    outs = []
    ms = (JManager(backend="ring", n_shards=2, n_queues=1, **GEOM),
          _mgr(backend="ring", n_shards=2, n_queues=1))
    for m, R in zip(ms, (JRequest, Request)):
        v = m.create()
        fut = v.pwrite(0, _pat(1, 2 * BB))
        snap = R(req_id=m._rid(v.vid), kind="snapshot", volume=v.vid)
        m.engine.submit(snap)
        fut2 = v.pwrite(0, _pat(2, BB))         # CoW against the snapshot
        m.flush()
        assert fut.result() == 2 * BB and fut2.result() == BB
        assert snap.status == 0 and snap.result >= 0
        got = v.read(0, 2 * BB)
        assert got == _pat(2, BB) + _pat(1, 2 * BB)[BB:]
        outs.append((snap.result, got))
    assert outs[0] == outs[1]
    _assert_same_stacked(*ms)


def test_engine_facade_legacy_surface():
    from repro_torch.core import Engine, EngineConfig, Request
    eng = Engine(EngineConfig(comm="ring", n_shards=2, payload_shape=(BB,),
                              n_extents=128, max_pages=16, device="cpu"))
    assert eng.pool is not None and eng.pool is eng.impl
    assert eng.backend is eng.pool.backend
    assert eng.frontend is eng.pool.frontend
    unfused = Engine(EngineConfig(comm="slots", payload_shape=(BB,),
                                  device="cpu"))
    assert unfused.pool is None and unfused.backend is not None
    up = Engine(EngineConfig(comm="upstream", payload_shape=(BB,),
                             device="cpu"))
    assert up.pool is None and up.backend is None
    vol = up.create_volume()
    r = Request(req_id=0, kind="write", volume=vol, page=0, block=0,
                payload=np.ones((BB,), np.float32))
    up.submit(r)
    assert up.drain() == 1 and r.status == 0


def test_volumemanager_stats_and_bounds():
    outs = []
    for m in (JManager(backend="ring", n_shards=2, **GEOM),
              _mgr(backend="ring", n_shards=2)):
        v = m.create()
        with pytest.raises(ValueError):
            v.pread(m.capacity - 2, 4)
        with pytest.raises(ValueError):
            v.pwrite(-1, b"x")
        assert v.pwrite(0, b"").result() == 0
        assert v.pread(5, 0).result() == b""
        st_ = m.stats()
        assert st_["backend"] == "ring" and st_["queued"] == 0
        outs.append(st_)
    assert outs[0] == outs[1]
