"""Port parity: the controller<->replica transport (core/transport.py) and
the policy objects over it (core/replication.py).

Twins of tests/test_transport.py. Each test runs the same script on the
JAX package's objects and on the port's (``device="cpu"``) and requires
the same outcome, and at the end the same replica state bit for bit:
every replica's ``DBSState``, pool and watermarks, and every transport's
counters (``sent`` per opcode, ``delivered``, ``retransmits``,
``pages_moved``, ``latency_ewma``) with the group's ``wait_ticks`` and
round-robin cursor. The simnet links draw from ``np.random.default_rng``
in both, so a seed gives the same drops and reorders.

The sharded pool's per-shard rebuild (tests/test_transport.py:234) is
twinned here, and so are the ring's cases: the in-band clone before a
host delta rebuild (:163), the ring leg of the in-program policy refusal
(:399) and the ring manager's close (:460).
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
from repro.core import transport as jtransport  # noqa: E402
from repro.core.blockdev import VolumeManager as JManager  # noqa: E402
from repro.core.replication import ReplicaGroup as JGroup  # noqa: E402
from repro_torch.core import Engine, EngineConfig, Request  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import transport as ttransport  # noqa: E402
from repro_torch.core.blockdev import VolumeManager  # noqa: E402
from repro_torch.core.replication import ReplicaGroup  # noqa: E402

PAY = (4,)
CPU = torch.device("cpu")
BASE = dict(n_replicas=2, n_extents=256, max_volumes=4, max_pages=64,
            page_blocks=8, payload_shape=PAY)


class J:
    """The JAX package's side of a twin."""
    T = jtransport
    Engine, Config, Request, Manager = JEngine, JConfig, JRequest, JManager

    @staticmethod
    def group(**kw):
        return JGroup(**{**BASE, **kw})

    @staticmethod
    def w(g, vol, pages, val):
        pages = jnp.asarray(pages, jnp.int32)
        g.write(vol, pages, jnp.zeros(pages.shape, jnp.int32),
                jnp.full((pages.shape[0],) + PAY, float(val)))

    @staticmethod
    def r(g, vol, pages):
        pages = jnp.asarray(pages, jnp.int32)
        return np.asarray(jax.device_get(
            g.read(vol, pages, jnp.zeros(pages.shape, jnp.int32))))

    @staticmethod
    def leaves(rep):
        return (jax.device_get(dataclasses.asdict(rep.state)),
                np.asarray(rep.pool), np.asarray(rep.page_rev))

    @staticmethod
    def pages(xs):
        return jnp.asarray(xs, jnp.int32)

    @staticmethod
    def leaves_pool(x):
        return np.asarray(jax.device_get(x))

    @staticmethod
    def leaves_state(st):
        return jax.device_get(dataclasses.asdict(st))

    cfg = {}


class T:
    """The port's side of a twin."""
    T = ttransport
    Engine, Config, Request, Manager = Engine, EngineConfig, Request, \
        VolumeManager

    @staticmethod
    def group(**kw):
        return ReplicaGroup(**{**BASE, **kw}, device=CPU)

    @staticmethod
    def w(g, vol, pages, val):
        pages = torch.as_tensor(pages, dtype=torch.int32)
        g.write(vol, pages, torch.zeros(pages.shape, dtype=torch.int32),
                torch.full((pages.shape[0],) + PAY, float(val)))

    @staticmethod
    def r(g, vol, pages):
        pages = torch.as_tensor(pages, dtype=torch.int32)
        return g.read(vol, pages, torch.zeros(pages.shape,
                                              dtype=torch.int32)).numpy()

    @staticmethod
    def leaves(rep):
        return (convert.to_numpy(rep.state), rep.pool.numpy(),
                rep.page_rev.numpy())

    @staticmethod
    def pages(xs):
        return torch.as_tensor(xs, dtype=torch.int32)

    @staticmethod
    def leaves_pool(x):
        return x.numpy()

    @staticmethod
    def leaves_state(st):
        return convert.to_numpy(st)

    cfg = {"device": "cpu"}


def _cmp(a, b, path):
    if isinstance(a, dict):
        for k in a:
            _cmp(a[k], b[k], f"{path}.{k}")
        return
    assert np.array_equal(np.asarray(a), np.asarray(b)), path


def _same_groups(jg, tg):
    """Replica state, transport counters, wait ticks and cursor equal."""
    assert jg.wait_ticks == tg.wait_ticks
    assert jg._rr == tg._rr
    for i, (jr, tr) in enumerate(zip(jg.replicas, tg.replicas)):
        assert jr.healthy == tr.healthy
        for part, a, b in zip(("state", "pool", "page_rev"), J.leaves(jr),
                              T.leaves(tr)):
            _cmp(a, b, f"replica {i} {part}")
    for i, (jt, tt) in enumerate(zip(jg.transports, tg.transports)):
        for k in ("name", "sent", "delivered", "retransmits", "pages_moved",
                  "latency_ewma"):
            assert getattr(jt, k) == getattr(tt, k), (i, k)
        assert jt.pending() == tt.pending(), i


def _twin(scenario):
    """Run ``scenario(P)`` on both packages; every returned group (see
    ``_same_groups``) and value must agree."""
    jout, tout = scenario(J), scenario(T)
    assert len(jout) == len(tout)
    for a, b in zip(jout, tout):
        if hasattr(a, "replicas"):
            _same_groups(a, b)
        else:
            _cmp(a, b, "returned")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def test_registry_names_and_unknown():
    for P in (J, T):
        assert {"local", "device", "simnet"} <= set(
            P.T.available_transports())
        with pytest.raises(ValueError, match="unknown transport"):
            P.group(transport="carrier-pigeon")


def test_registry_custom_transport():
    def scenario(P):
        calls = []

        @P.T.register_transport("counting-local")
        class CountingLocal(P.T.LocalTransport):
            def post(self, msg):
                calls.append(msg.op)
                return super().post(msg)

        try:
            g = P.group(transport="counting-local")
            vol = g.create_volume()
            P.w(g, vol, [0, 1], 1.0)
            assert calls and P.T.MSG_WRITE in calls
            got = P.r(g, vol, [0, 1])
            np.testing.assert_allclose(got, 1.0)
            return g, calls, got
        finally:
            P.T._REGISTRY.pop("counting-local", None)
    _twin(scenario)


def test_policy_validation():
    for P in (J, T):
        with pytest.raises(ValueError, match="write_policy"):
            P.group(write_policy="most")
        with pytest.raises(ValueError, match="read_policy"):
            P.group(read_policy="nearest")


# ---------------------------------------------------------------------------
# wire accounting
# ---------------------------------------------------------------------------
def test_every_interaction_is_a_counted_message():
    def scenario(P):
        g = P.group()
        vol = g.create_volume()
        P.w(g, vol, [0, 1, 2], 1.0)
        got = P.r(g, vol, [0])
        g.snapshot(vol)
        g.unmap(vol, P.pages([2]))
        assert g.consistent()
        for t in g.transports:
            assert t.sent["CREATE"] == 1
            assert t.sent["WRITE"] == 1          # one mirrored batch each
            assert t.sent["SNAPSHOT"] == 1
            assert t.sent["UNMAP"] == 1
            assert t.sent["QUERY_REV"] == 1      # consistent()
        assert sum(t.sent["READ"] for t in g.transports) == 1
        return g, got
    _twin(scenario)


# ---------------------------------------------------------------------------
# delta rebuild
# ---------------------------------------------------------------------------
def test_delta_rebuild_moves_only_post_fail_pages():
    def scenario(P):
        g = P.group()
        vol = g.create_volume()
        P.w(g, vol, list(range(32)), 1.0)        # 32 allocated extents
        g.fail(1)
        P.w(g, vol, [3, 4, 5, 6, 40], 7.0)       # 4 overwrites + 1 new page
        moved0 = g.transports[1].pages_moved
        g.rebuild(1)
        moved = g.transports[1].pages_moved - moved0
        assert moved == 5 and moved < 33         # not a full copy
        assert g.consistent()
        g.fail(0)                                # reads on the rebuilt one
        a, b = P.r(g, vol, [3, 40]), P.r(g, vol, [0, 31])
        np.testing.assert_allclose(a, 7.0)
        np.testing.assert_allclose(b, 1.0)
        g.rebuild(0)
        return g, a, b
    _twin(scenario)


def test_delta_rebuild_covers_clone_shared_extents():
    """A clone's watermark row inherits the source's, so an extent reached
    only through the clone's table still beats the target's watermarks."""
    def scenario(P):
        g = P.group()
        vol = g.create_volume()
        P.w(g, vol, [0], 1.0)
        g.fail(1)
        P.w(g, vol, [0], 2.0)                    # replica 1 misses this
        cvol = g.clone(vol)                      # shares page 0's extent
        P.w(g, vol, [0], 3.0)                    # source CoWs away
        g.rebuild(1)
        assert g.consistent()
        g.fail(0)
        a, b = P.r(g, vol, [0]), P.r(g, cvol, [0])
        np.testing.assert_allclose(a, 3.0)
        np.testing.assert_allclose(b, 2.0)
        g.rebuild(0)
        return g, a, b
    _twin(scenario)


def test_delta_rebuild_empty_delta_moves_nothing():
    def scenario(P):
        g = P.group()
        vol = g.create_volume()
        P.w(g, vol, [0, 1], 2.0)
        g.fail(0)
        g.rebuild(0)                             # nothing written meanwhile
        assert g.transports[0].pages_moved == 0
        assert g.consistent()
        return (g,)
    _twin(scenario)


def test_delta_rebuild_after_fused_engine_traffic():
    """The fused step stamps watermarks inside the step; the host-side
    streamed rebuild sees them."""
    def scenario(P):
        eng = P.Engine(P.Config(comm="fused", storage="dbs",
                                payload_shape=PAY, n_extents=256,
                                max_pages=64, batch=16, **P.cfg))
        vol = eng.create_volume()
        pay = np.ones(PAY, np.float32)
        for i in range(24):
            eng.submit(P.Request(req_id=i, kind="write", volume=vol, page=i,
                                 block=0, payload=pay))
        eng.drain()
        eng.control("fail", replica=1)
        for i in range(6):                       # replica 1 misses these
            eng.submit(P.Request(req_id=100 + i, kind="write", volume=vol,
                                 page=i, block=0, payload=2 * pay))
        eng.drain()
        g = eng.backend
        moved0 = g.transports[1].pages_moved
        eng.control("rebuild", replica=1)
        assert g.transports[1].pages_moved - moved0 == 6
        assert g.consistent()
        st, pool0, _ = P.leaves(g.replicas[0])
        _, pool1, _ = P.leaves(g.replicas[1])
        ids = np.unique(st["table"][st["table"] >= 0])
        np.testing.assert_array_equal(pool0[ids], pool1[ids])
        return (g,)
    _twin(scenario)


def test_delta_rebuild_sharded_pool():
    """The per-shard streamed delta through the stacked device transport,
    after in-step traffic on both shards: 4 rows move, the other shard's
    slices are untouched, and every stacked leaf and transport counter
    equals the reference's."""
    def scenario(P):
        eng = P.Engine(P.Config(comm="sharded", n_shards=2, storage="dbs",
                                payload_shape=PAY, n_extents=256,
                                max_pages=64, batch=16, **P.cfg))
        vols = [eng.create_volume() for _ in range(2)]
        pay = np.ones(PAY, np.float32)
        for i in range(16):
            for v in vols:
                eng.submit(P.Request(req_id=i * 2 + v, kind="write",
                                     volume=v, page=i, block=0, payload=pay))
        eng.drain()
        pool = eng.pool
        sick = vols[0] % 2
        pool.backend.fail(sick, 1)
        for i in range(4):                   # shard 0's replica 1 misses
            eng.submit(P.Request(req_id=900 + i, kind="write",
                                 volume=vols[0], page=i, block=0,
                                 payload=3 * pay))
        eng.drain()
        t1 = pool.backend.transports[1]
        moved0 = t1.pages_moved
        pool.backend.rebuild(sick, 1)
        assert t1.pages_moved - moved0 == 4
        assert pool.backend.consistent()
        other = 1 - sick
        a, b = (np.asarray(P.leaves_pool(pool.backend.pools[r])[other])
                for r in (0, 1))
        np.testing.assert_array_equal(a, b)
        out = [dict(t.sent) for t in pool.backend.transports]
        out += [t.pages_moved for t in pool.backend.transports]
        out += [P.leaves_pool(x) for x in pool.backend.pools]
        out += [P.leaves_pool(x) for x in pool.backend.device_page_revs()]
        out += [P.leaves_state(x) for x in pool.backend.states]
        return out
    _twin(scenario)


# ---------------------------------------------------------------------------
# simnet semantics
# ---------------------------------------------------------------------------
def test_simnet_latency_and_window():
    def scenario(P):
        ep = P.group()                           # donor of a real endpoint
        t = P.T.SimNetTransport(ep.replicas[0], latency=3, window=2)
        f1 = t.post(P.T.WireMsg(op=P.T.MSG_QUERY_REV))
        f2 = t.post(P.T.WireMsg(op=P.T.MSG_QUERY_REV))
        assert not f1.done and t.pending() == 2
        t.tick(), t.tick()
        assert not f1.done                       # latency 3: not yet
        t.tick()
        assert f1.done and f2.done
        f3 = t.post(P.T.WireMsg(op=P.T.MSG_QUERY_REV))
        assert t.pending() == 1
        t.drain()
        assert f3.done and t.delivered == 3
        return ep, t.now, t.latency_ewma, int(f3.value)
    _twin(scenario)


def test_simnet_drop_retransmits_in_order():
    def scenario(P):
        g = P.group(transport="simnet",
                    transport_opts=dict(latency=1, window=4, drop=0.3,
                                        seed=7))
        vol = g.create_volume()
        for i in range(8):
            P.w(g, vol, [i], float(i + 1))       # policy "all": waits acks
        g.drain_transports()
        assert g.consistent()
        got = [P.r(g, vol, [i]) for i in range(8)]
        for i in range(8):
            np.testing.assert_allclose(got[i], float(i + 1))
        assert any(t.retransmits > 0 for t in g.transports)
        return g, got
    _twin(scenario)


def test_simnet_reorder_injection_delivers_everything():
    def scenario(P):
        g = P.group(transport="simnet", write_policy="async",
                    transport_opts=dict(latency=1, window=8, reorder=0.5,
                                        seed=3))
        vol = g.create_volume()
        for i in range(6):
            P.w(g, vol, [i], 1.0)                # async: queues build up
        g.drain_transports()
        for t in g.transports:
            assert t.pending() == 0 and t.delivered >= 7
        return (g,)
    _twin(scenario)


# ---------------------------------------------------------------------------
# write/read policies
# ---------------------------------------------------------------------------
def _straggler(P, **kw):
    return P.group(n_replicas=3, transport="simnet",
                   transport_opts=dict(latency=[1, 1, 6], window=4), **kw)


def test_quorum_acks_on_majority_then_converges():
    def scenario(P):
        g = _straggler(P, write_policy="quorum")
        vol = g.create_volume()
        P.w(g, vol, [0, 1], 5.0)
        assert g.transports[2].pending() >= 1    # the straggler holds it
        g.drain_transports()
        assert g.consistent()
        got = []
        for rep in range(3):                     # every replica converged
            g._rr = rep
            got.append(P.r(g, vol, [0, 1]))
            np.testing.assert_allclose(got[-1], 5.0)
        return g, got
    _twin(scenario)


def test_async_is_write_behind_and_fifo_read_sees_own_link():
    def scenario(P):
        g = _straggler(P, write_policy="async")
        vol = g.create_volume()
        P.w(g, vol, [0], 9.0)
        assert all(t.pending() >= 1 for t in g.transports)
        got = P.r(g, vol, [0])                   # FIFO behind the write
        np.testing.assert_allclose(got, 9.0)
        g.drain_transports()
        assert g.consistent()
        return g, got
    _twin(scenario)


def test_latency_weighted_reads_avoid_the_straggler():
    def scenario(P):
        g = _straggler(P, read_policy="latency")
        vol = g.create_volume()
        P.w(g, vol, [0], 1.0)                    # seeds every link's ewma
        before = g.transports[2].sent["READ"]
        for _ in range(12):
            P.r(g, vol, [0])
        assert g.transports[2].sent["READ"] == before
        assert g.transports[0].sent["READ"] > 0
        assert g.transports[1].sent["READ"] > 0
        return (g,)
    _twin(scenario)


def test_policies_match_all_end_state():
    """Every policy converges to the replica contents of ``all``."""
    def scenario(P):
        ref = P.group(n_replicas=3)
        pools = {}
        groups = []
        for policy in ("all", "quorum", "async"):
            g = _straggler(P, write_policy=policy)
            for grp in ((ref,) if policy == "all" else ()) + (g,):
                vol = grp.create_volume()
                for i in range(6):
                    P.w(grp, vol, [i % 4], float(i))
                grp.drain_transports()
            pools[policy] = [P.leaves(r)[1] for r in g.replicas]
            assert g.consistent()
            groups.append(g)
        for policy in ("quorum", "async"):
            for a, b in zip(pools["all"], pools[policy]):
                np.testing.assert_array_equal(a, b)
        return (ref, *groups)
    _twin(scenario)


# ---------------------------------------------------------------------------
# config threading
# ---------------------------------------------------------------------------
def test_engineconfig_threads_transport_to_the_group():
    def scenario(P):
        eng = P.Engine(P.Config(comm="slots", storage="dbs",
                                payload_shape=PAY, transport="simnet",
                                write_policy="quorum",
                                read_policy="latency", n_replicas=3,
                                transport_opts=dict(latency=2, window=16),
                                **P.cfg))
        g = eng.backend
        assert all(isinstance(t, P.T.SimNetTransport) for t in g.transports)
        assert g.write_policy == "quorum" and g.read_policy == "latency"
        vol = eng.create_volume()
        pay = np.ones(PAY, np.float32)
        rs = []
        for i in range(8):
            eng.submit(P.Request(req_id=i, kind="write", volume=vol, page=i,
                                 block=0, payload=pay))
            rs.append(P.Request(req_id=100 + i, kind="read", volume=vol,
                                page=i, block=0))
            eng.submit(rs[-1])
        assert eng.drain() == 16
        return g, [np.asarray(r.result) for r in rs]
    _twin(scenario)


def test_inprogram_backends_reject_host_policies():
    """The fused, sharded and ring legs. The JAX package's sharded group
    (behind ``sharded`` and ``ring``) says INSIDE where the others say
    IN-PROGRAM."""
    for P in (J, T):
        for comm in ("fused", "sharded", "ring"):
            word = "INSIDE" if (P is J and comm != "fused") else \
                "IN-PROGRAM"
            with pytest.raises(ValueError, match=f"write_policy|{word}"):
                P.Engine(P.Config(comm=comm, storage="dbs",
                                  write_policy="quorum", **P.cfg))
            with pytest.raises(ValueError, match=word):
                P.Engine(P.Config(comm=comm, storage="dbs",
                                  read_policy="latency", **P.cfg))


def test_inband_clone_then_host_delta_rebuild():
    """The clone hazard through the ring's in-band CLONE: the control tail
    copies the source's watermark row, so the host-side streamed delta
    rebuild after it moves the extents the clone still shares, and the
    rebuilt replica alone serves both volumes."""
    def scenario(P):
        eng = P.Engine(P.Config(comm="ring", n_shards=1, storage="dbs",
                                payload_shape=PAY, n_extents=256,
                                max_pages=64, batch=16, **P.cfg))
        vol = eng.create_volume()
        pay = np.ones(PAY, np.float32)

        def write(page, val):
            eng.submit(P.Request(req_id=page, kind="write", volume=vol,
                                 page=page, block=0, payload=val * pay))
            eng.drain()
        write(0, 1.0)
        b = eng.pool.backend
        b.fail(0, 1)
        write(0, 2.0)                        # replica 1 misses this
        cvol = eng.clone(vol)                # in-band CLONE
        assert cvol >= 0
        write(0, 3.0)                        # the source CoWs away
        b.rebuild(0, 1)                      # host-side streamed delta
        assert b.consistent()
        b.fail(0, 0)                         # the rebuilt replica serves
        got = [P.leaves_pool(eng.pool.read_volume(v, P.pages([0]),
                                                  P.pages([0])))[:, 0]
               for v in (vol, cvol)]
        np.testing.assert_allclose(got, [[3.0], [2.0]])
        b.rebuild(0, 0)
        out = [dict(t.sent) for t in b.transports]
        out += [t.pages_moved for t in b.transports]
        out += [P.leaves_pool(x) for x in b.pools]
        out += [P.leaves_pool(x) for x in b.device_page_revs()]
        out += [P.leaves_state(x) for x in b.states]
        return out + got
    _twin(scenario)


def test_volumemanager_close_drains_inflight():
    """Context-manager exit drains in-flight I/O on the ring; the closed
    manager rejects new submissions and keeps its futures resolvable."""
    def scenario(P):
        with P.Manager(backend="ring", payload_elems=8, page_blocks=4,
                       max_pages=16, **P.cfg) as vm:
            v = vm.create()
            fut = v.pwrite(0, b"bye")
            rfut = v.pread(0, 3)
            assert not fut.done()            # still queued, no flush yet
        assert vm.closed and fut.done() and rfut.done()
        assert rfut.result() == b"bye"
        assert vm.close() == 0               # idempotent
        for call in (lambda: v.pwrite(0, b"nope"),
                     lambda: vm.pread(v, 0, 1), vm.create):
            with pytest.raises(ValueError, match="closed"):
                call()
        assert vm.flush() == 0
        return [P.leaves_pool(x) for x in vm.engine.backend.pools]
    _twin(scenario)


def test_volumemanager_threads_transport():
    def scenario(P):
        with P.Manager(backend="slots", transport="simnet",
                       write_policy="quorum", n_replicas=3,
                       payload_elems=8, page_blocks=4, max_pages=16,
                       transport_opts=dict(latency=1), **P.cfg) as vm:
            g = vm.engine.backend
            assert all(isinstance(t, P.T.SimNetTransport)
                       for t in g.transports)
            v = vm.create()
            v.write(10, b"over the wire")
            got = v.read(10, 13)
            assert got == b"over the wire"
        return g, got
    _twin(scenario)


# ---------------------------------------------------------------------------
# satellites
# ---------------------------------------------------------------------------
def test_iofuture_result_is_cached(monkeypatch):
    """Repeated ``result()`` returns the cached assembly: no re-assembly,
    no re-flush."""
    vm = VolumeManager(backend="slots", payload_elems=8, page_blocks=4,
                       max_pages=16, device="cpu")
    v = vm.create()
    v.write(0, b"cache me")
    fut = v.pread(0, 8)
    first = fut.result()
    assert first == b"cache me"
    flushes = []
    monkeypatch.setattr(vm, "flush", lambda: (flushes.append(1), 0)[1])
    for r in fut._reqs:
        r.result = None                      # a re-assembly would differ
    assert fut.result() is first
    assert fut.result() == b"cache me"
    assert flushes == []
    assert fut.done()


def test_consistent_batches_revision_fetch(monkeypatch):
    """One host fetch for the whole group, not one per healthy replica."""
    g = T.group(n_replicas=4)
    vol = g.create_volume()
    T.w(g, vol, [0, 1], 1.0)
    fetches = []
    for name in ("tolist", "item", "cpu", "numpy", "__int__"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(
            torch.Tensor, name,
            lambda self, *a, _real=real, _n=name, **k: (
                fetches.append(_n), _real(self, *a, **k))[1])
    assert g.consistent()
    assert fetches == ["tolist"], fetches


def test_close_drains_write_behind_transports():
    def scenario(P):
        vm = P.Manager(backend="slots", transport="simnet",
                       write_policy="async", payload_elems=8, page_blocks=4,
                       max_pages=16, transport_opts=dict(latency=3), **P.cfg)
        v = vm.create()
        v.pwrite(0, b"straggler")
        vm.close()
        g = vm.engine.backend
        assert all(t.pending() == 0 for t in g.transports)
        assert g.consistent()
        return (g,)
    _twin(scenario)
