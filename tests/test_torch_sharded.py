"""Port parity: the sharded engine pool, ``EnginePool`` (core/sharded.py).

Twins of tests/test_sharded.py. Each case feeds the same seeded requests to
the JAX package's ``EnginePool`` and to the port's (``device="cpu"``: the
kernel wrappers run their plain versions) and requires, bit for bit:

- the same completions and read payloads,
- every stacked replica leaf: each replica's (S, ...) ``DBSState``, its
  (S, E+1, page, *payload) pool (the dump rows included) and its (S, V, P)
  watermarks,
- the same ``dispatches`` and (S, R) health mask.

The reference pins "one compiled program per pump" with jit trace counts;
eager PyTorch has no program, so the port's counterpart is that the ops a
pump dispatches and the kernel-entry calls it makes are the same at S=2
and S=4, and at S=1, which runs the step unmapped as the reference does,
a fixed count of its own and the same calls (``test_one_step_per_pump``),
counted under
``warnings.simplefilter("error")``, which catches a vmap batching rule that
falls back to a loop over the shards.
"""
import collections
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import Engine as JEngine  # noqa: E402
from repro.core import EngineConfig as JConfig  # noqa: E402
from repro.core import Request as JRequest  # noqa: E402
from repro_torch.core import Engine, EngineConfig, Request  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.kernels.dbs import rw_kernel  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

PAY = (8,)


def _cfg(**kw):
    base = dict(comm="sharded", storage="dbs", payload_shape=PAY,
                n_extents=128, max_pages=64, batch=16, n_replicas=2,
                n_shards=3, max_volumes=8)
    base.update(kw)
    return base


class J:
    Request = JRequest

    @staticmethod
    def engine(**kw):
        return JEngine(JConfig(**_cfg(kernel="pallas", **kw)))

    @staticmethod
    def pay(v):
        return jnp.full(PAY, float(v))

    @staticmethod
    def ids(xs):
        return jnp.asarray(xs, jnp.int32)

    @staticmethod
    def host(x):
        return np.asarray(jax.device_get(x))

    @staticmethod
    def state(st):
        return jax.device_get(dataclasses.asdict(st))


class T:
    Request = Request

    @staticmethod
    def engine(**kw):
        return Engine(EngineConfig(**_cfg(kernel="cuda", device="cpu", **kw)))

    @staticmethod
    def pay(v):
        return np.full(PAY, float(v), np.float32)

    @staticmethod
    def ids(xs):
        return torch.as_tensor(xs, dtype=torch.int32)

    @staticmethod
    def host(x):
        return x.numpy()

    @staticmethod
    def state(st):
        return convert.to_numpy(st)


def _cmp(a, b, path):
    if isinstance(a, dict):
        for k in a:
            _cmp(a[k], b[k], f"{path}.{k}")
        return
    assert np.array_equal(np.asarray(a), np.asarray(b)), path


def _same_pools(jp, tp):
    """Every stacked replica leaf, the health mask and the dispatches."""
    jb, tb = jp.backend, tp.backend
    assert jp.dispatches == tp.dispatches
    np.testing.assert_array_equal(jb.healthy, tb.healthy)
    for r in range(jb.n_replicas):
        _cmp(J.state(jb.states[r]), T.state(tb.states[r]), f"r{r} state")
        assert np.array_equal(J.host(jb.pools[r]), T.host(tb.pools[r])), r
    jrevs, trevs = jb.device_page_revs(), tb.device_page_revs()
    assert len(jrevs) == len(trevs)        # none under null_storage
    for r, (a, b) in enumerate(zip(jrevs, trevs)):
        assert np.array_equal(J.host(a), T.host(b)), r


def _twin(scenario):
    """Run ``scenario(P)`` on both packages: the returned pools agree leaf
    for leaf, and every other returned value is equal."""
    jout, tout = scenario(J), scenario(T)
    for a, b in zip(jout, tout):
        if hasattr(a, "is_pool"):
            _same_pools(a, b)
        else:
            _cmp(a, b, "returned")


def _mixed_traffic(P, n, vols, pages=48, base=0):
    reqs = []
    for i in range(n):
        v = vols[i % len(vols)]
        if i % 2:
            reqs.append(P.Request(req_id=base + i, kind="write", volume=v,
                                  page=i % pages, block=(i * 3) % 8,
                                  payload=P.pay(i + 1)))
        else:
            reqs.append(P.Request(req_id=base + i, kind="read", volume=v,
                                  page=(i // 2) % pages, block=0))
    return reqs


def _read_all(P, pool, vols, pages):
    return [P.host(pool.read_volume(v, P.ids(np.arange(pages)),
                                    P.ids(np.full(pages, blk))))
            for v in vols for blk in range(8)]


# ---------------------------------------------------------------------------
# 1. the pool equals the reference pool and S independent fused engines
# ---------------------------------------------------------------------------
def test_pool_matches_independent_engines():
    """The reference's pool-vs-loop scenario (writes on every shard, a
    snapshot, CoW overwrites with reads) on both pools: every stacked leaf
    equal, every read equal; and the port's pool equals three independent
    port ``fused`` engines fed the same per-volume streams, volume contents
    and each shard's replica states."""
    S = 3

    def scenario(P):
        eng = P.engine(n_shards=S)
        pool = eng.pool
        vols = [pool.create_volume() for _ in range(S)]
        assert sorted(g % S for g in vols) == list(range(S))
        for i in range(90):
            pool.submit(P.Request(req_id=i, kind="write", volume=vols[i % S],
                                  page=i % 48, block=i % 8,
                                  payload=P.pay(i + 1)))
        assert pool.drain() == 90
        for v in vols:
            pool.snapshot(v)
        reads = []
        for i in range(45):
            pool.submit(P.Request(req_id=i, kind="write", volume=vols[i % S],
                                  page=i % 24, block=(i * 5) % 8,
                                  payload=P.pay(1000 + i)))
            reads.append(P.Request(req_id=500 + i, kind="read",
                                   volume=vols[i % S], page=i % 24, block=0))
            pool.submit(reads[-1])
        assert pool.drain() == 90
        assert pool.backend.consistent()
        return (pool, [np.asarray(r.result) for r in reads],
                _read_all(P, pool, vols, 48))
    _twin(scenario)

    # the port's pool against S independent port engines
    eng = T.engine(n_shards=S)
    singles = [Engine(EngineConfig(**{**_cfg(kernel="cuda", device="cpu"),
                                      "comm": "fused", "n_shards": 1}))
               for _ in range(S)]
    gvols = [eng.create_volume() for _ in range(S)]
    svols = [e.create_volume() for e in singles]
    for i in range(60):
        s = i % S
        eng.submit(Request(req_id=i, kind="write", volume=gvols[s],
                           page=i % 40, block=i % 8, payload=T.pay(i + 1)))
        singles[s].submit(Request(req_id=i, kind="write", volume=svols[s],
                                  page=i % 40, block=i % 8,
                                  payload=T.pay(i + 1)))
    assert eng.drain() == 60 and sum(e.drain() for e in singles) == 60
    pages = T.ids(np.arange(40))
    for s in range(S):
        for blk in range(8):
            offs = T.ids(np.full(40, blk))
            assert torch.equal(eng.pool.read_volume(gvols[s], pages, offs),
                               singles[s].backend.read(svols[s], pages, offs))
        for r in range(2):
            stacked = T.state(eng.pool.backend.states[r])
            _cmp({k: (v[gvols[s] % S] if not isinstance(v, dict) else
                      {kk: vv[gvols[s] % S] for kk, vv in v.items()})
                  for k, v in stacked.items()},
                 T.state(singles[s].backend.replicas[r].state),
                 f"shard {s} replica {r}")


# ---------------------------------------------------------------------------
# 2. one step a pump: the same ops and kernel calls at every S
# ---------------------------------------------------------------------------
class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _pump_profile(n_shards):
    """Per pump kind: the aten ops dispatched and the DBS kernel-entry
    calls of each ``pump_async``, over a drain of mixed traffic (and one
    of reads only). The health mask crosses to the device once, on the
    first pump after a fail or rebuild: it is made before counting."""
    eng = T.engine(n_shards=n_shards)
    pool = eng.pool
    vols = [pool.create_volume() for _ in range(8)]
    pool.backend.device_state()     # the health mask's one copy, cached
    seen = collections.defaultdict(set)
    real = pool.pump_async

    def counted():
        before = dict(rw_kernel.PLAIN_CALLS)
        kind = dict(pool.step_counts)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with _CountOps() as c:
                p = real()
        if p is not None:
            step = next(k for k in kind if pool.step_counts[k] != kind[k])
            calls = tuple(rw_kernel.PLAIN_CALLS[k] - before[k]
                          for k in sorted(before))
            seen[step].add((sum(c.ops.values()), tuple(sorted(c.ops.items())),
                            calls))
        return p
    pool.pump_async = counted
    for r in _mixed_traffic(T, 160, vols):
        pool.submit(r)
    assert pool.drain() == 160
    for i in range(40):
        pool.submit(Request(req_id=900 + i, kind="read", volume=vols[i % 8],
                            page=i, block=0))
    assert pool.drain() == 40
    return seen, pool


def test_one_step_per_pump():
    one, pool1 = _pump_profile(1)
    two, _ = _pump_profile(2)
    four, pool4 = _pump_profile(4)
    assert set(one) == set(two) == set(four) == {"step", "step_read"}
    for kind in one:
        # every mapped pump of a kind dispatches the same ops, at either S
        assert len(two[kind]) == 1 and two[kind] == four[kind], kind
        # S=1 runs the step unmapped: its own fixed ops, the same calls
        (_, _, c1), = one[kind]
        (_, _, c4), = four[kind]
        assert c1 == c4, kind
    (n_ops, _, calls), = four["step"]
    assert n_ops > 100
    assert calls == (2, 2)            # dbs_rw_read, dbs_rw_write: R each
    assert next(iter(four["step_read"]))[2] == (2, 0)
    assert pool4.kernel_calls == {"write": 2 * pool4.step_counts["step"],
                                  "read": 2 * pool4.dispatches}
    assert pool4.dispatches < pool1.dispatches    # S shards a pump
    # the pool dispatches as often as the reference's
    jeng = J.engine(n_shards=4)
    jvols = [jeng.pool.create_volume() for _ in range(8)]
    for r in _mixed_traffic(J, 160, jvols):
        jeng.pool.submit(r)
    assert jeng.pool.drain() == 160
    for i in range(40):
        jeng.pool.submit(JRequest(req_id=900 + i, kind="read",
                                  volume=jvols[i % 8], page=i, block=0))
    assert jeng.pool.drain() == 40
    assert jeng.pool.dispatches == pool4.dispatches
    assert jeng.pool.trace_counts["step"] == 1


# ---------------------------------------------------------------------------
# 3. the pipelined drain
# ---------------------------------------------------------------------------
def test_pipelined_drain_completes_exact_set_with_requeues():
    """More requests than slots on every shard: the pipelined drain
    completes exactly the submitted set, reads included, as the
    reference's does."""
    def scenario(P):
        pool = P.engine(n_shards=2, n_slots=8, batch=8).pool
        vols = [pool.create_volume() for _ in range(4)]
        reads = []
        for i in range(200):
            v = vols[i % 4]
            if i % 3 == 0:
                r = P.Request(req_id=i, kind="read", volume=v, page=i % 32,
                              block=0)
                reads.append(r)
                pool.submit(r)
            else:
                pool.submit(P.Request(req_id=i, kind="write", volume=v,
                                      page=i % 32, block=i % 8,
                                      payload=P.pay(i)))
        assert pool.drain() == 200
        assert pool.completed == 200 and pool.frontend.depth() == 0
        assert all(r.result is not None for r in reads)
        return pool, [np.asarray(r.result) for r in reads]
    _twin(scenario)


def test_pump_async_overlaps_completion():
    """``pump_async`` returns a handle without waiting; a second pump is
    admitted while the first is in flight, and each completes later with
    its own lanes' results."""
    def scenario(P):
        pool = P.engine(n_shards=2).pool
        vols = [pool.create_volume() for _ in range(2)]
        for i in range(10):
            pool.submit(P.Request(req_id=i, kind="write", volume=vols[i % 2],
                                  page=i, block=0, payload=P.pay(i + 1)))
        p1 = pool.pump_async()
        assert p1 is not None and pool.completed == 0
        rd = P.Request(req_id=90, kind="read", volume=vols[0], page=0,
                       block=0)
        pool.submit(rd)
        p2 = pool.pump_async()
        assert pool._complete(p1) == 10
        assert pool._complete(p2) == 1
        np.testing.assert_array_equal(np.asarray(rd.result),
                                      np.full(PAY, 1.0))
        return pool, np.asarray(rd.result)
    _twin(scenario)


# ---------------------------------------------------------------------------
# 4. per-shard failover
# ---------------------------------------------------------------------------
def test_per_shard_failover_mid_drain():
    """One replica of one shard fails mid-drain: every shard's data stays
    intact, the survivors stay consistent, the per-shard rebuild restores
    consistency and moves rows of the sick shard only, and the rebuilt
    replica serves the writes it missed."""
    def scenario(P):
        pool = P.engine(n_shards=3).pool
        vols = [pool.create_volume() for _ in range(3)]
        for i in range(60):
            pool.submit(P.Request(req_id=i, kind="write", volume=vols[i % 3],
                                  page=i % 20, block=0, payload=P.pay(i + 1)))
        assert pool.drain() == 60
        pages, zeros = P.ids(np.arange(20)), P.ids(np.zeros(20))
        base = [P.host(pool.read_volume(v, pages, zeros)) for v in vols]
        sick = vols[1] % 3
        pool.backend.fail(sick, 0)
        reads = []
        for i in range(30):
            pool.submit(P.Request(req_id=100 + i, kind="write",
                                  volume=vols[i % 3], page=20 + (i % 10),
                                  block=0, payload=P.pay(200 + i)))
            reads.append(P.Request(req_id=500 + i, kind="read",
                                   volume=vols[i % 3], page=i % 20, block=0))
            pool.submit(reads[-1])
        assert pool.drain() == 60
        for s in range(3):
            if s != sick:
                assert pool.backend.consistent(s)
        for v, want in zip(vols, base):
            np.testing.assert_array_equal(
                P.host(pool.read_volume(v, pages, zeros)), want)
        moved = [t.pages_moved for t in pool.backend.transports]
        pool.backend.rebuild(sick, 0)
        assert pool.backend.consistent()
        delta = [t.pages_moved - m
                 for t, m in zip(pool.backend.transports, moved)]
        before = dict(rebuilt=np.asarray(pool.backend.healthy).copy())
        pool.backend.fail(sick, 1)             # reads from the rebuilt one
        got = P.host(pool.read_volume(vols[1], P.ids([20]), P.ids([0])))
        assert got[0][0] >= 200.0
        pool.backend.rebuild(sick, 1)
        np.testing.assert_array_equal(pool.backend.healthy,
                                      before["rebuilt"])
        return (pool, [np.asarray(r.result) for r in reads], got, delta,
                [dict(t.sent) for t in pool.backend.transports])
    _twin(scenario)
    # the port counts rows and messages per shard: only the sick shard's
    pool = T.engine(n_shards=3).pool
    vols = [pool.create_volume() for _ in range(3)]
    for i in range(30):
        pool.submit(Request(req_id=i, kind="write", volume=vols[i % 3],
                            page=i, block=0, payload=T.pay(i)))
    pool.drain()
    pool.backend.fail(1, 1)
    for i in range(6):
        pool.submit(Request(req_id=100 + i, kind="write", volume=vols[1],
                            page=i, block=0, payload=T.pay(7)))
    pool.drain()
    t1 = pool.backend.transports[1]
    sent = dict(t1.sent_by_shard)
    pool.backend.rebuild(1, 1)
    assert t1.pages_moved_by_shard == {1: 6}
    assert {s for s, n in t1.sent_by_shard.items() if n != sent.get(s, 0)} \
        == {1}


def test_shard_failover_validation():
    def scenario(P):
        backend = P.engine(n_shards=2).pool.backend
        with pytest.raises(IndexError):
            backend.fail(5, 0)
        with pytest.raises(IndexError):
            backend.fail(0, 7)
        with pytest.raises(ValueError):
            backend.rebuild(0, 0)                # healthy: nothing to do
        backend.fail(0, 0)
        with pytest.raises(RuntimeError):
            backend.fail(0, 1)                   # shard 0's last healthy
        backend.fail(1, 1)                       # other shard: independent
        with pytest.raises(IndexError):
            backend.rebuild(3, 0)
        mask = np.asarray(backend.healthy).copy()
        backend.rebuild(0, 0)
        backend.rebuild(1, 1)
        assert backend.healthy.all()
        return (mask,)
    _twin(scenario)


# ---------------------------------------------------------------------------
# engine routing and the null rows
# ---------------------------------------------------------------------------
def test_engine_routes_sharded_comm():
    def scenario(P):
        eng = P.engine(n_shards=2)
        assert eng.pool is not None and eng.backend is eng.pool.backend
        vols = [eng.create_volume() for _ in range(2)]
        reads = _mixed_traffic(P, 40, vols, pages=32)
        for r in reads:
            eng.submit(r)
        assert eng.drain() == 40 and eng.completed == 40
        eng.completed = 0                        # the ladder's reset idiom
        assert eng.pool.completed == 0
        return eng.pool, [np.asarray(r.result) for r in reads[::2]]
    _twin(scenario)
    with pytest.raises(ValueError, match="shard="):
        T.engine(n_shards=2).control("fail", replica=0)


@pytest.mark.parametrize("kw", [dict(null_backend=True),
                                dict(null_storage=True)])
def test_sharded_null_rows_complete(kw):
    def scenario(P):
        eng = P.engine(n_shards=2, **kw)
        vol = eng.create_volume()
        reads = []
        for i in range(40):
            r = P.Request(req_id=i, kind="write" if i % 2 else "read",
                          volume=vol, page=i % 64, block=0,
                          payload=P.pay(1))
            reads += [r] if i % 2 == 0 else []
            eng.submit(r)
        assert eng.drain() == 40
        out = [np.asarray(r.result) for r in reads]
        assert all(not o.any() for o in out)     # the cuts read zeros
        return ([eng.pool] if eng.pool.backend is not None else []) + [out]
    _twin(scenario)
