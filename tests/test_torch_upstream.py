"""Port parity: the paper's upstream baseline, ``backend="upstream"``
(``UpstreamEngine``: ``UpstreamFrontend`` over ``ChainedStore``s), and
``storage="chained"`` behind the ``loop`` and ``slots`` backends.

1. Twins of tests/test_blockdev.py's upstream cases: the interleaved byte
   scenario against a bytearray and a ``ChainedStore`` walk (the port's
   own, as the reference keeps its own) on ``upstream``, ``loop`` +
   chained and ``slots`` + chained, the JAX manager run in lock step
   giving the same bytes; control kinds rejected at submit; the registry;
   the engine façade's surface.
2. A seeded byte trace through both packages' ``upstream``, ``loop`` +
   chained and ``slots`` + chained managers: every read returns the same
   bytes, and every store counts the same reads and ``layers_walked``.
3. ``ChainedStore`` itself: the same ops give the same reads and walk
   counts, and a stored payload owns its memory (a later change to the
   caller's tensor does not reach it). ``UpstreamFrontend`` stamps the same
   ticks and latencies as the reference's.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import Engine as JEngine  # noqa: E402
from repro.core import EngineConfig as JConfig  # noqa: E402
from repro.core import Request as JRequest  # noqa: E402
from repro.core.blockdev import VolumeManager as JManager  # noqa: E402
from repro.core.engine import ChainedStore as JChained  # noqa: E402
from repro.core.frontend import UpstreamFrontend as JFrontend  # noqa: E402
from repro_torch.core import Engine, EngineConfig, Request  # noqa: E402
from repro_torch.core import UpstreamEngine  # noqa: E402
from repro_torch.core.backends import available_backends  # noqa: E402
from repro_torch.core.blockdev import VolumeManager  # noqa: E402
from repro_torch.core.engine import ChainedStore  # noqa: E402
from repro_torch.core.frontend import UpstreamFrontend  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_blockdev import _replay, _trace  # noqa: E402

BB, PB, PAGES = 8, 4, 8          # block bytes, page blocks, pages
GEOM = dict(payload_elems=BB, page_blocks=PB, max_pages=PAGES, n_extents=256,
            max_volumes=16, batch=16, n_replicas=2)
CHAINED = [dict(backend="upstream"), dict(backend="loop", storage="chained"),
           dict(backend="slots", storage="chained")]
IDS = ["upstream", "loop-chained", "slots-chained"]


def _pat(seed: int, n: int) -> bytes:
    return bytes((seed * 37 + i) % 251 for i in range(n))


def _stores(mgr):
    impl = mgr.engine.impl
    return impl.stores if mgr.backend_name == "upstream" else \
        mgr.engine.backend.stores


class _Refs:
    """Lock-step twin of tests/test_blockdev.py's double reference: a JAX
    manager and a port manager take the same ops; a bytearray and the
    port's ``ChainedStore`` hold what every volume must read."""

    def __init__(self, jm, tm):
        self.mgrs = (jm, tm)
        self.chained = ChainedStore((BB,), device="cpu")
        self.bufs = {}          # vid -> bytearray
        self.cmap = {}          # vid -> chained volume id

    def new_vol(self):
        vs = [m.create() for m in self.mgrs]
        assert vs[0].vid == vs[1].vid
        self.bufs[vs[1].vid] = bytearray(self.mgrs[1].capacity)
        self.cmap[vs[1].vid] = self.chained.create_volume()
        return vs

    def _mirror_blocks(self, vid, off, n):
        buf = self.bufs[vid]
        for ab in range(off // BB, (off + n - 1) // BB + 1):
            blk = bytes(buf[ab * BB:(ab + 1) * BB])
            self.chained.write(self.cmap[vid], ab // PB, ab % PB,
                               np.frombuffer(blk, np.uint8)
                               .astype(np.float32))

    def write(self, vs, off, data):
        futs = [v.pwrite(off, data) for v in vs]
        self.bufs[vs[1].vid][off:off + len(data)] = data
        self._mirror_blocks(vs[1].vid, off, len(data))
        return futs

    def discard(self, vs, off, n):
        for v in vs:
            v.discard(off, n)
        self.bufs[vs[1].vid][off:off + n] = bytes(n)
        pby = self.mgrs[1].page_bytes
        ff, lf = -(-off // pby), (off + n) // pby
        edges = ([(off, ff * pby), (lf * pby, off + n)] if ff < lf
                 else [(off, off + n)])
        for p in range(ff, lf):
            self.chained.unmap(self.cmap[vs[1].vid], p)
        for a, b in edges:
            if b > a:
                self._mirror_blocks(vs[1].vid, a, b - a)

    def read_expect(self, vs, off, n):
        return ([v.pread(off, n) for v in vs],
                bytes(self.bufs[vs[1].vid][off:off + n]))

    def snapshot(self, vs):
        for v in vs:
            v.snapshot()
        self.chained.snapshot(self.cmap[vs[1].vid])

    def clone(self, vs):
        cs = [v.clone() for v in vs]
        assert cs[0].vid == cs[1].vid
        self.bufs[cs[1].vid] = bytearray(self.bufs[vs[1].vid])
        self.cmap[cs[1].vid] = self.chained.clone(self.cmap[vs[1].vid])
        return cs

    def delete(self, vs):
        self.chained.delete_volume(self.cmap.pop(vs[1].vid))
        del self.bufs[vs[1].vid]
        for m, v in zip(self.mgrs, vs):
            m.delete(v)

    def check_all(self):
        for m in self.mgrs:
            m.flush()
        for vid, buf in self.bufs.items():
            got = [m.open(vid).read(0, m.capacity) for m in self.mgrs]
            assert got[0] == got[1] == bytes(buf), f"vid {vid}"
            for ab in range(len(buf) // BB):
                w = self.chained.read(self.cmap[vid], ab // PB, ab % PB)
                w = (bytes(BB) if w is None
                     else w.numpy().astype(np.uint8).tobytes())
                assert w == bytes(buf[ab * BB:(ab + 1) * BB]), (vid, ab)


@pytest.mark.parametrize("kw", CHAINED, ids=IDS)
def test_byte_equivalence_interleaved(kw):
    jm = JManager(**{**GEOM, **kw})
    tm = VolumeManager(**{**GEOM, **kw}, device="cpu")
    refs = _Refs(jm, tm)
    v1, v2 = refs.new_vol(), refs.new_vol()
    pending = []
    pending += refs.write(v1, 0, _pat(1, 17))          # unaligned tail
    pending += refs.write(v2, 5, _pat(2, 11))          # unaligned both ends
    pending += refs.write(v1, 13, _pat(3, 9))          # overlaps in flight
    r1, e1 = refs.read_expect(v1, 3, 20)
    pending += refs.write(v1, 24, _pat(4, 48))         # page-crossing span
    r2, e2 = refs.read_expect(v2, 0, 32)
    assert all(f.result() is not None for f in pending)
    assert all(f.result() == e1 for f in r1)
    assert all(f.result() == e2 for f in r2)
    refs.check_all()
    refs.snapshot(v1)
    refs.write(v1, 2, _pat(5, 40))                     # CoW vs snapshot
    c1 = refs.clone(v1)
    refs.write(c1, 0, _pat(6, 23))                     # child diverges
    refs.write(v1, 64, _pat(7, 16))                    # parent diverges
    refs.check_all()
    refs.write(v2, 32, _pat(8, 96))
    refs.discard(v2, 34, 3)                            # sub-block
    refs.discard(v2, 40, 20)                           # partial page
    refs.discard(v1, 30, 70)                           # edges + full pages
    refs.check_all()
    refs.delete(v2)
    v3 = refs.new_vol()
    refs.write(v3, 7, _pat(9, 33))
    refs.check_all()
    for m in (jm, tm):
        m.close()


@pytest.mark.parametrize("kw", CHAINED, ids=IDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_trace_matches_jax(kw, seed):
    """Equal bytes, and every store counts the same reads and layers
    walked (the paper's chain-walk cost)."""
    jm = JManager(**{**GEOM, **kw})
    tm = VolumeManager(**{**GEOM, **kw}, device="cpu")
    ops = _trace(seed, 70, jm.capacity)
    outs = ([], [])
    for m, out in zip((jm, tm), outs):
        _replay(m, ops, [m.create(), m.create()], out)
    assert outs[0] == outs[1]
    assert len(outs[1]) > 10
    walks = [[(s.reads, s.layers_walked) for s in _stores(m)]
             for m in (jm, tm)]
    assert walks[0] == walks[1]
    assert sum(w for _, w in walks[1]) > sum(r for r, _ in walks[1]) > 0


def test_control_rejected_at_submit_data_survives():
    for M, R in ((JManager, JRequest), (VolumeManager, Request)):
        mgr = M(**{**GEOM, "backend": "upstream"},
                **({"device": "cpu"} if M is VolumeManager else {}))
        v = mgr.create()
        eng = mgr.engine
        w = R(req_id=0, kind="write", volume=v.vid, page=0, block=0,
              payload=np.full((BB,), 7.0, np.float32))
        eng.submit(w)
        for kind in ("snapshot", "clone", "unmap", "noop"):
            with pytest.raises(ValueError):
                eng.submit(R(req_id=1, kind=kind, volume=v.vid))
        assert eng.depth() == 1
        assert eng.drain() == 1 and w.status == 0 and w.latency == 1
        mgr.snapshot(v)
        assert v.read(0, BB) == bytes(bytearray([7] * BB))


def test_registry_lists_upstream():
    assert {"loop", "slots", "fused", "upstream", "host"} <= set(
        available_backends())
    with pytest.raises(ValueError, match="registered"):
        Engine(EngineConfig(comm="nope", device="cpu"))


def test_engine_facade_surface():
    """``Engine(comm="upstream")`` has no replica-group storage; requests
    complete one a pump, with the reference's statuses and latencies."""
    engs = (JEngine(JConfig(comm="upstream", payload_shape=(BB,))),
            Engine(EngineConfig(comm="upstream", payload_shape=(BB,),
                                device="cpu")))
    assert isinstance(engs[1].impl, UpstreamEngine)
    got = []
    for eng, R in zip(engs, (JRequest, Request)):
        assert eng.backend is None
        vol = eng.create_volume()
        rs = [R(req_id=i, kind="write", volume=vol, page=i, block=0,
                payload=np.full((BB,), i, np.float32)) for i in range(3)]
        rs.append(R(req_id=9, kind="read", volume=vol, page=2, block=0))
        for r in rs:
            eng.submit(r)
        assert eng.pump() == 1 and eng.depth() == 3
        assert eng.drain() == 3
        got.append([(r.status, r.latency, r.tick) for r in rs]
                   + [np.asarray(rs[-1].result).tolist()])
    assert got[0] == got[1]
    assert got[1][-1] == [2.0] * BB


def test_null_cuts_on_upstream():
    """``null_backend``: no stores, volume 0, clone -1; ``null_storage``:
    stores but no store work. Every request completes; reads carry no
    payload in either package."""
    for cut in ("null_backend", "null_storage"):
        engs = (JEngine(JConfig(comm="upstream", payload_shape=(BB,),
                                **{cut: True})),
                Engine(EngineConfig(comm="upstream", payload_shape=(BB,),
                                    device="cpu", **{cut: True})))
        for eng, R in zip(engs, (JRequest, Request)):
            vol = eng.create_volume()
            assert (eng.impl.stores is None) == (cut == "null_backend")
            if cut == "null_backend":
                assert vol == 0 and eng.clone(vol) == -1
            rs = [R(req_id=i, kind=("write", "read")[i % 2], volume=vol,
                    page=i, block=0, payload=np.ones(BB, np.float32))
                  for i in range(6)]
            for r in rs:
                eng.submit(r)
            assert eng.drain() == 6
            assert all(r.status == 0 and r.result is None for r in rs)
            if cut == "null_storage":
                assert all(s.reads == 0 for s in eng.impl.stores)


def test_chained_store_matches_and_owns_its_payloads():
    j, t = JChained((4,)), ChainedStore((4,), device="cpu")
    buf = torch.zeros(4)
    for s, mk in ((j, jnp.asarray), (t, lambda a: buf.copy_(
            torch.from_numpy(a)))):
        v = s.create_volume()
        s.write(v, 0, 1, mk(np.full(4, 1.0, np.float32)))
        s.snapshot(v)
        s.write(v, 2, 0, mk(np.full(4, 2.0, np.float32)))
        c = s.clone(v)
        s.unmap(c, 0)
        s.write(c, 2, 0, mk(np.full(4, 3.0, np.float32)))
        assert s.clone(99) == -1 and c == 1
    buf.fill_(9.0)                    # the caller's tensor changes later
    for vol, page, blk in ((0, 0, 1), (0, 2, 0), (1, 0, 1), (1, 2, 0),
                           (0, 5, 0), (7, 0, 0)):
        a, b = j.read(vol, page, blk), t.read(vol, page, blk)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(np.asarray(a), b.numpy())
    assert (j.reads, j.layers_walked) == (t.reads, t.layers_walked)
    assert t.read(0, 2, 0).tolist() == [2.0] * 4


def test_upstream_frontend_ticks_and_inflight():
    fes = (JFrontend(max_inflight=2), UpstreamFrontend(max_inflight=2))
    outs = []
    for fe, R in zip(fes, (JRequest, Request)):
        rs = [R(req_id=i, kind="read", volume=0) for i in range(4)]
        for r in rs:
            fe.submit(r)
        a, b = fe.poll_one(), fe.poll_one()
        assert fe.poll_one() is None and len(fe) == 2   # map full
        fe.complete(a[0])
        c = fe.poll_one()
        outs.append([a[0], b[0], c[0]]
                    + [(r.tick, r.latency) for r in rs])
    assert outs[0] == outs[1]
