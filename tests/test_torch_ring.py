"""Port parity: the SQ/CQ ring (``RingEngine``, ``backend="ring"``).

Twins of tests/test_ring.py. Each case feeds the same seeded requests to
the JAX package's ring engine and to the port's (``device="cpu"``: the
kernel wrappers run their plain versions) and requires, bit for bit:

- the same completions, statuses, latencies and results on every request
  (read payloads, snapshot ids, clone volumes),
- every stacked replica leaf: each replica's (S, ...) ``DBSState`` (the
  revision counter included, which ``_assert_states_equal`` in
  tests/test_ring.py excepts against the sequential reference), its
  (S, E+1, page, *payload) pool (dump rows included) and its (S, V, P)
  watermarks,
- the (S, R) health mask, the dispatches, the completion queue (status,
  value, latency, payload a slot) and the slot table's opcode, function-id
  and status lanes,
- the same step signatures: the reference's compiled programs
  (``trace_counts``) and the port's pumps by signature (``step_counts``).

Eager PyTorch has no compiled program: "one program per signature" becomes
"at most seven signatures, none added by more control traffic", and "one
``device_get`` a pump" becomes one call of the engine's ``_fetch`` a pump
(the card's count of host syncs is in tests/test_torch_kernels_gpu.py).
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
from repro.core import UpstreamEngine as JUpstream  # noqa: E402
from repro.core import dbs as jdbs  # noqa: E402
from repro_torch.core import Engine, EngineConfig, Request  # noqa: E402
from repro_torch.core import UpstreamEngine, convert, dbs  # noqa: E402
from repro_torch.core.engine import ChainedStore  # noqa: E402
from repro_torch.core.ring import (ST_ERR, ST_HEALTHY, ST_LAST,  # noqa: E402
                                   ST_OK, RingEngine)

PAY = (8,)
KERNELS = [("pallas", "cuda"), ("xla", "torch"), ("xla", "copy")]


def _cfg(**kw):
    base = dict(comm="ring", storage="dbs", payload_shape=PAY, n_extents=256,
                max_pages=64, batch=16, n_replicas=2, n_shards=1,
                max_volumes=16)
    base.update(kw)
    return base


class J:
    Request = JRequest
    kernel = "pallas"

    @classmethod
    def engine(cls, **kw):
        kw.setdefault("kernel", cls.kernel)
        return JEngine(JConfig(**_cfg(**kw)))

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
    kernel = "cuda"

    @classmethod
    def engine(cls, **kw):
        kw.setdefault("kernel", cls.kernel)
        return Engine(EngineConfig(**_cfg(device="cpu", **kw)))

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


def _cmp(a, b, path, skip=()):
    if isinstance(a, dict):
        for k in a:
            if k not in skip:
                _cmp(a[k], b[k], f"{path}.{k}", skip)
        return
    assert np.array_equal(np.asarray(a), np.asarray(b)), path


def _same_rings(jp, tp):
    """Every stacked replica leaf, the health mask,
    the dispatches, the completion queue, the slot table's ring lanes and
    the step signatures."""
    assert jp.dispatches == tp.dispatches
    jsig = {k for k in jp.trace_counts if not str(k[-1]).startswith("sfns")}
    jsig |= {k[:-1] for k in jp.trace_counts if str(k[-1]).startswith("sfns")}
    assert jsig == set(tp.step_counts), (jsig, tp.step_counts)
    for f in ("status", "value", "latency", "payload"):
        assert np.array_equal(J.host(getattr(jp.cq, f)),
                              T.host(getattr(tp.cq, f))), f"cq.{f}"
    for f in ("opcode", "fnid", "status", "active"):
        assert np.array_equal(J.host(getattr(jp.frontend.table, f)),
                              T.host(getattr(tp.frontend.table, f))), f
    jb, tb = jp.backend, tp.backend
    if jb is None:
        assert tb is None
        return
    np.testing.assert_array_equal(jb.healthy, tb.healthy)
    for r in range(jb.n_replicas):
        _cmp(J.state(jb.states[r]), T.state(tb.states[r]), f"r{r} state")
        assert np.array_equal(J.host(jb.pools[r]), T.host(tb.pools[r])), r
    jrevs, trevs = jb.device_page_revs(), tb.device_page_revs()
    assert len(jrevs) == len(trevs)
    for r, (a, b) in enumerate(zip(jrevs, trevs)):
        assert np.array_equal(J.host(a), T.host(b)), r


def _req_out(reqs):
    """What a request list completed with, as comparable host values."""
    out = []
    for r in reqs:
        res = r.result
        if res is not None and not isinstance(res, (int, np.integer)):
            res = np.asarray(res).tolist()
        out.append((r.kind, r.status, r.latency, res))
    return out


def _twin(scenario, kernels=("pallas", "cuda")):
    """Run ``scenario(P)`` on both packages: ring engines (``is_pool``)
    agree leaf for leaf, request lists on their completions, and every
    other returned value is equal."""
    J.kernel, T.kernel = kernels
    try:
        jout, tout = scenario(J), scenario(T)
    finally:
        J.kernel, T.kernel = "pallas", "cuda"
    assert len(jout) == len(tout)
    for a, b in zip(jout, tout):
        if isinstance(a, JEngine):
            a, b = a.pool, b.pool
        if isinstance(a, type(None)) or not hasattr(a, "is_pool"):
            if isinstance(a, list) and a and hasattr(a[0], "req_id"):
                assert _req_out(a) == _req_out(b)
            else:
                _cmp(a, b, "returned")
        else:
            _same_rings(a, b)


# ---------------------------------------------------------------------------
# 1. data path: ring == fused, results delivered from the CQ
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernels", KERNELS, ids=lambda k: k[1])
def test_ring_matches_fused_volume_contents(kernels):
    def scenario(P):
        engs = [P.engine(comm="fused"), P.engine()]
        vols = [e.create_volume() for e in engs]
        for i in range(60):
            for e, v in zip(engs, vols):
                e.submit(P.Request(req_id=i, kind="write", volume=v,
                                   page=i % 48, block=i % 8,
                                   payload=P.pay(i + 1)))
        assert [e.drain() for e in engs] == [60, 60]
        for e, v in zip(engs, vols):
            e.snapshot(v)
        reads = []
        for i in range(30):
            for e, v in zip(engs, vols):
                e.submit(P.Request(req_id=i, kind="write", volume=v,
                                   page=i % 24, block=(i * 3) % 8,
                                   payload=P.pay(1000 + i)))
                r = P.Request(req_id=i + 500, kind="read", volume=v,
                              page=i % 24, block=0)
                e.submit(r)
                reads.append(r)
        assert [e.drain() for e in engs] == [60, 60]
        pages = P.ids(np.arange(48))
        for blk in range(8):
            offs = P.ids(np.full(48, blk))
            np.testing.assert_array_equal(
                P.host(engs[0].backend.read(vols[0], pages, offs)),
                P.host(engs[1].pool.read_volume(vols[1], pages, offs)))
        assert engs[1].pool.backend.consistent()
        return engs[1], reads
    _twin(scenario, kernels)


def test_ring_read_results_status_latency():
    def scenario(P):
        eng = P.engine()
        vol = eng.create_volume()
        w = P.Request(req_id=0, kind="write", volume=vol, page=3, block=2,
                      payload=P.pay(7))
        eng.submit(w)
        eng.drain()
        r = P.Request(req_id=1, kind="read", volume=vol, page=3, block=2)
        eng.submit(r)
        eng.drain()
        np.testing.assert_allclose(np.asarray(r.result), np.full(PAY, 7.0))
        assert w.status == ST_OK and r.status == ST_OK
        assert w.latency == 1 and r.latency == 1
        return eng, [w, r]
    _twin(scenario)


def test_ring_latency_counts_queueing_ticks():
    def scenario(P):
        eng = P.engine(n_slots=4, batch=8)
        vol = eng.create_volume()
        reqs = [P.Request(req_id=i, kind="write", volume=vol, page=i,
                          block=0, payload=P.pay(i)) for i in range(8)]
        for r in reqs:
            eng.submit(r)
        assert eng.drain() == 8
        lats = sorted(r.latency for r in reqs)
        assert lats[0] == 1 and lats[-1] > 1
        return eng, reqs
    _twin(scenario)


def test_requeue_preserves_queue_order():
    def scenario(P):
        eng = P.engine(n_queues=1, n_slots=4, batch=8)
        reqs = [P.Request(req_id=i, kind="noop") for i in range(8)]
        for r in reqs:
            eng.submit(r)
        assert eng.pool.pump() == 4
        q = eng.pool.frontend.queues[0][0]
        order = [r.req_id for r in q]
        assert eng.drain() == 4
        eng.pool.frontend.requeue_all(reqs[:3])
        return eng, order, [r.req_id for r in q]
    _twin(scenario)


def test_overwrite_order_survives_slot_pressure():
    def scenario(P):
        eng = P.engine(n_queues=1, n_slots=4, batch=8)
        vol = eng.create_volume()
        for i in range(8):
            eng.submit(P.Request(req_id=i, kind="write", volume=vol, page=i,
                                 block=0, payload=P.pay(100 + i)))
        for i in range(4):
            eng.submit(P.Request(req_id=8 + i, kind="write", volume=vol,
                                 page=4 + i, block=0, payload=P.pay(200 + i)))
        assert eng.drain() == 12
        got = P.host(eng.pool.read_volume(vol, P.ids(np.arange(8)),
                                          P.ids(np.zeros(8))))
        np.testing.assert_allclose(
            got[:, 0], [100, 101, 102, 103, 200, 201, 202, 203])
        return eng, got
    _twin(scenario)


def test_ring_noop_barrier_completes():
    def scenario(P):
        eng = P.engine()
        r = P.Request(req_id=0, kind="noop")
        eng.submit(r)
        assert eng.drain() == 1 and r.status == ST_OK
        return eng, [r]
    _twin(scenario)


@pytest.mark.parametrize("cut", ["null_backend", "null_storage"])
def test_ring_null_rows_complete(cut):
    def scenario(P):
        eng = P.engine(**{cut: True})
        vol = eng.create_volume()
        reqs = [P.Request(req_id=i, kind="write" if i % 2 else "read",
                          volume=vol, page=i % 64, block=0,
                          payload=P.pay(1)) for i in range(40)]
        for r in reqs:
            eng.submit(r)
        assert eng.drain() == 40
        return eng, reqs
    _twin(scenario)


# ---------------------------------------------------------------------------
# 2. in-band control == the host-side sequence == the chained-store walk
# ---------------------------------------------------------------------------
def _interleaving(seed, n_ops, n_base=3, pages=48):
    """The reference's op stream: writes draw pages from a per-volume
    permutation (no (vol, page) repeats within a batch window)."""
    rng = np.random.default_rng(seed)
    perm = {v: rng.permutation(pages) for v in range(n_base)}
    counters = {v: 0 for v in range(n_base)}
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        vol = int(rng.integers(0, n_base))
        if r < 0.72:
            page = int(perm[vol][counters[vol] % pages])
            counters[vol] += 1
            ops.append(("write", vol, page, int(rng.integers(0, 8))))
        elif r < 0.84:
            ops.append(("snapshot", vol))
        elif r < 0.92:
            ops.append(("clone", vol))
        else:
            ops.append(("unmap", vol, int(perm[vol][rng.integers(0, pages)])))
    return ops


class _HostRef:
    """The port's sequential reference: one state and pool, op by op."""

    def __init__(self, max_pages):
        self.st = dbs.make_state(256, 16, max_pages, device="cpu")
        self.pool = torch.zeros((257, 32) + PAY)

    def write(self, vol, page, block, payload):
        i64 = lambda x: torch.tensor([x], dtype=torch.int64)
        self.st, ops = dbs.write_pages(self.st, vol, i64(page),
                                       i64(1 << block),
                                       torch.ones((1,), dtype=torch.bool))
        self.pool = dbs.apply_write_ops(self.pool, ops,
                                        torch.as_tensor(payload)[None],
                                        torch.tensor([block],
                                                     dtype=torch.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inband_control_matches_host_sequence_and_chained_walk(seed):
    pages = 48
    ops = _interleaving(seed, 110, 3, pages)

    def scenario(P):
        eng = P.engine(n_queues=1, n_slots=256, max_pages=pages)
        assert [eng.create_volume() for _ in range(3)] == [0, 1, 2]
        reqs = []
        for i, op in enumerate(ops):
            if op[0] == "write":
                _, vol, page, block = op
                r = P.Request(req_id=i, kind="write", volume=vol, page=page,
                              block=block, payload=P.pay(i + 1))
            else:
                r = P.Request(req_id=i, kind=op[0], volume=op[1],
                              page=op[2] if op[0] == "unmap" else 0)
            reqs.append(r)
            eng.submit(r)
        assert eng.drain() == len(ops)
        return eng, reqs
    _twin(scenario)

    # the port's ring against the port's own sequential reference and its
    # chained-store walk (content-identical, holes zero)
    eng = scenario(T)[0]
    ref, chained = _HostRef(pages), ChainedStore(PAY, device="cpu")
    cmap = {}
    for v in range(3):
        ref.st, _ = dbs.create_volume(ref.st)
        cmap[v] = chained.create_volume()
    for i, op in enumerate(ops):
        if op[0] == "write":
            ref.write(op[1], op[2], op[3], T.pay(i + 1))
            chained.write(cmap[op[1]], op[2], op[3], T.pay(i + 1))
        elif op[0] == "snapshot":
            ref.st, _ = dbs.snapshot(ref.st, op[1])
            chained.snapshot(cmap[op[1]])
        elif op[0] == "clone":
            ref.st, vid = dbs.clone(ref.st, op[1])
            if int(vid) >= 0:
                cmap[int(vid)] = chained.clone(cmap[op[1]])
        else:
            ref.st = dbs.unmap(ref.st, op[1], torch.tensor([op[2]]))
            chained.unmap(cmap[op[1]], op[2])
    b = eng.pool.backend
    for rep in range(2):
        st = T.state(b.states[rep])
        # the sequential reference bumps the revision once an op, the ring
        # once a batched phase: excepted, as in tests/test_ring.py
        _cmp({k: (v[0] if not isinstance(v, dict) else
                  {kk: vv[0] for kk, vv in v.items()})
              for k, v in st.items()}, T.state(ref.st), f"replica {rep}",
             skip=("revision",))
        assert torch.equal(b.pools[rep][0], ref.pool)
    table, pool0 = b.states[0].table[0], b.pools[0][0]
    for vol, cv in cmap.items():
        for page in range(pages):
            for block in range(0, 8, 3):
                ext = int(table[vol, page])
                got = pool0[ext, block] if ext >= 0 else torch.zeros(PAY)
                want = chained.read(cv, page, block)
                want = torch.zeros(PAY) if want is None else want
                assert torch.equal(got, want), (vol, page, block)


def test_inband_delete_matches_host_sequence():
    def scenario(P):
        eng = P.engine(n_queues=1)
        va, vb = eng.create_volume(), eng.create_volume()
        for i in range(12):
            eng.submit(P.Request(req_id=i, kind="write",
                                 volume=va if i % 2 else vb, page=i,
                                 block=0, payload=P.pay(i + 1)))
        eng.drain()
        eng.delete_volume(va)
        vc = eng.create_volume()
        assert vc == va
        for i in range(6):
            eng.submit(P.Request(req_id=100 + i, kind="write", volume=vc,
                                 page=i, block=1, payload=P.pay(50 + i)))
        eng.drain()
        return eng, vc
    _twin(scenario)


def test_inband_control_error_statuses():
    def scenario(P):
        eng = P.engine()
        r = P.Request(req_id=0, kind="snapshot", volume=9)   # never created
        eng.submit(r)
        eng.drain()
        assert r.status == ST_ERR and r.result == -1
        return eng, [r]
    _twin(scenario)


def test_control_failure_surface_matches_host_modes():
    def scenario(P):
        out = []
        for comm in ("ring", "sharded"):
            eng = P.engine(comm=comm, n_shards=2)
            eng.create_volume()
            snap = eng.snapshot(9)
            assert snap == -1 or snap is None
            out.append(eng.clone(9))
        assert out == [-1, -1]
        return (out,)
    _twin(scenario)


# ---------------------------------------------------------------------------
# 3. in-band FAIL/REBUILD on the sharded ring, mid-drain
# ---------------------------------------------------------------------------
def test_inband_fail_rebuild_mid_drain_sharded():
    def scenario(P):
        eng = P.engine(n_shards=3)
        pool = eng.pool
        vols = [eng.create_volume() for _ in range(3)]
        for i in range(60):
            eng.submit(P.Request(req_id=i, kind="write", volume=vols[i % 3],
                                 page=i % 20, block=0, payload=P.pay(i + 1)))
        assert eng.drain() == 60
        read = lambda v: P.host(pool.read_volume(v, P.ids(np.arange(20)),
                                                 P.ids(np.zeros(20))))
        baseline = {v: read(v) for v in vols}
        sick = vols[1] % 3
        fail_req = P.Request(req_id=99, kind="fail", shard=sick, block=0)
        reqs = []
        for i in range(30):
            if i == 11:
                reqs.append(fail_req)
            reqs.append(P.Request(req_id=100 + i, kind="write",
                                  volume=vols[i % 3], page=20 + (i % 10),
                                  block=0, payload=P.pay(200 + i)))
            reqs.append(P.Request(req_id=500 + i, kind="read",
                                  volume=vols[i % 3], page=i % 20, block=0))
        for r in reqs:
            eng.submit(r)
        assert eng.drain() == 61
        assert fail_req.status == ST_OK
        assert not pool.backend.healthy[sick, 0]
        for v in vols:
            np.testing.assert_array_equal(read(v), baseline[v])
        reb = P.Request(req_id=600, kind="rebuild", shard=sick, block=0)
        eng.submit(reb)
        assert eng.drain() == 1
        assert reb.status == ST_OK and pool.backend.consistent()
        pool.fail(sick, 1)
        got = P.host(pool.read_volume(vols[1], P.ids([25]), P.ids([0])))
        assert got[0][0] >= 200.0
        pool.rebuild(sick, 1)
        assert pool.backend.healthy.all()
        return eng, reqs + [reb], got
    _twin(scenario)


def test_inband_fail_rebuild_protocol_errors():
    def scenario(P):
        eng = P.engine(n_shards=2)
        pool = eng.pool
        eng.create_volume()
        r = P.Request(req_id=0, kind="rebuild", shard=0, block=0)
        eng.submit(r)
        eng.drain()
        assert r.status == ST_HEALTHY and pool.backend.healthy.all()
        pool.fail(0, 0)
        r2 = P.Request(req_id=1, kind="fail", shard=0, block=1)
        eng.submit(r2)
        eng.drain()
        assert r2.status == ST_LAST and pool.backend.healthy[0, 1]
        with pytest.raises(RuntimeError):
            pool.fail(0, 1)
        with pytest.raises(ValueError):
            pool.rebuild(0, 1)
        with pytest.raises(IndexError):
            pool.fail(9, 0)
        bad = P.Request(req_id=2, kind="fail", shard=1, block=7)
        eng.submit(bad)                      # replica out of range: ST_ERR
        eng.drain()
        assert bad.status == ST_ERR
        pool.rebuild(0, 0)
        assert pool.backend.healthy.all()
        return eng, [r, r2, bad]
    _twin(scenario)


# ---------------------------------------------------------------------------
# 4. dispatch accounting: in-band means in the step
# ---------------------------------------------------------------------------
def test_one_program_per_class_signature_no_control_retrace():
    """The reference: one compiled program a signature, none added by more
    control traffic. The port: the same signatures (``_same_rings``), each
    pumped, at most seven of them, none added by more control traffic;
    one dispatch a pump."""
    def scenario(P):
        eng = P.engine(n_shards=2)
        vols = [eng.create_volume() for _ in range(4)]

        def traffic(base):
            for i in range(40):
                v = vols[i % 4]
                if i % 3 == 0:
                    eng.submit(P.Request(req_id=base + i, kind="read",
                                         volume=v, page=i % 32, block=0))
                else:
                    eng.submit(P.Request(req_id=base + i, kind="write",
                                         volume=v, page=i % 32, block=i % 8,
                                         payload=P.pay(i)))
            eng.submit(P.Request(req_id=base + 90, kind="snapshot",
                                 volume=vols[0]))
            eng.submit(P.Request(req_id=base + 91, kind="unmap",
                                 volume=vols[1], page=2))
        traffic(0)
        assert eng.drain() == 42
        counts = getattr(eng.pool, "trace_counts", None) or \
            eng.pool.step_counts
        before = set(counts)
        d0 = eng.pool.dispatches
        traffic(1000)
        assert eng.drain() == 42
        assert set(counts) == before and eng.pool.dispatches > d0
        return eng, str(sorted(before))
    _twin(scenario)
    eng = T.engine(n_shards=2)
    assert len({RingEngine._canon(set(c)) for c in (
        [], ["write"], ["compute"], ["vol"], ["repl"], ["vol", "compute"],
        ["repl", "compute"], ["read", "write", "vol"])}) == 7
    assert eng.pool.step_counts == {}


def test_ring_pump_is_single_host_hop_with_control_aboard():
    eng = T.engine(n_queues=1)
    vol = eng.create_volume()
    eng.submit(Request(req_id=0, kind="write", volume=vol, page=0, block=0,
                       payload=T.pay(1)))
    eng.submit(Request(req_id=1, kind="snapshot", volume=vol))
    eng.drain()
    for i in range(6):
        eng.submit(Request(req_id=10 + i, kind="write", volume=vol,
                           page=1 + i, block=0, payload=T.pay(i)))
    eng.submit(Request(req_id=20, kind="snapshot", volume=vol))
    eng.submit(Request(req_id=21, kind="compute", volume=vol, fn="checksum",
                       page=0, block=8))
    pool = eng.pool
    calls = []
    real = pool._fetch
    pool._fetch = lambda p: (calls.append(1), real(p))[1]
    assert pool.pump() == 7          # data + the control tail: one batch
    assert pool.pump() == 1          # the compute (rank cut)
    assert calls == [1, 1], calls


# ---------------------------------------------------------------------------
# 5. result/status/latency unified across every comm mode
# ---------------------------------------------------------------------------
_COMMS = [("loop", "chained", 1), ("loop", "dbs", 1),
          ("slots", "chained", 1), ("slots", "dbs", 1),
          ("fused", "dbs", 1), ("sharded", "dbs", 2), ("ring", "dbs", 2),
          ("ring", "dbs", 1)]


def _eng(P, comm, storage, shards, **kw):
    cfg = {**dict(comm=comm, storage=storage, payload_shape=PAY,
                  n_extents=256, max_pages=64, batch=16, n_replicas=2,
                  n_shards=shards, max_volumes=16), **kw}
    if P is T:
        return Engine(EngineConfig(device="cpu", **cfg))
    return JEngine(JConfig(**cfg))


@pytest.mark.parametrize("comm,storage,shards", _COMMS)
def test_result_status_unified_across_comms(comm, storage, shards):
    def scenario(P):
        eng = _eng(P, comm, storage, shards)
        vol = eng.create_volume()
        w = P.Request(req_id=0, kind="write", volume=vol, page=1, block=2,
                      payload=P.pay(7))
        eng.submit(w)
        assert eng.drain() == 1
        r = P.Request(req_id=1, kind="read", volume=vol, page=1, block=2)
        eng.submit(r)
        assert eng.drain() == 1
        assert w.status == 0 and r.status == 0
        np.testing.assert_allclose(np.asarray(r.result), np.full(PAY, 7.0))
        return ([w, r],)
    _twin(scenario)


@pytest.mark.parametrize("comm,storage,shards", _COMMS + [
    ("upstream", "dbs", 1), ("host", "dbs", 1)])
def test_latency_unified_across_comms(comm, storage, shards):
    def scenario(P):
        eng = _eng(P, comm, storage, shards, n_slots=4, batch=8)
        vol = eng.create_volume()
        w = P.Request(req_id=0, kind="write", volume=vol, page=1, block=2,
                      payload=P.pay(7))
        eng.submit(w)
        assert eng.drain() == 1 and w.latency == 1
        reqs = [P.Request(req_id=i, kind="write", volume=vol, page=2 + i,
                          block=0, payload=P.pay(i)) for i in range(8)]
        for r in reqs:
            eng.submit(r)
        assert eng.drain() == 8
        lats = sorted(r.latency for r in reqs)
        assert lats[0] >= 1 and lats[-1] > lats[0]
        rd = P.Request(req_id=100, kind="read", volume=vol, page=1, block=2)
        eng.submit(rd)
        assert eng.drain() == 1 and rd.latency >= 1
        return ([w] + reqs + [rd],)
    _twin(scenario)


def test_result_status_upstream_engine():
    def scenario(P):
        cls, cfg = ((JUpstream, JConfig) if P is J else
                    (UpstreamEngine, EngineConfig))
        kw = {} if P is J else dict(device="cpu")
        eng = cls(cfg(payload_shape=PAY, **kw))
        vol = eng.create_volume()
        w = P.Request(req_id=0, kind="write", volume=vol, page=1, block=2,
                      payload=P.pay(7))
        eng.submit(w)
        eng.drain()
        r = P.Request(req_id=1, kind="read", volume=vol, page=1, block=2)
        eng.submit(r)
        eng.drain()
        assert w.status == 0 and r.status == 0
        return ([w, r],)
    _twin(scenario)


def test_control_kinds_rejected_off_ring():
    def scenario(P):
        eng = P.engine(comm="fused")
        eng.create_volume()
        with pytest.raises(ValueError):
            eng.submit(P.Request(req_id=0, kind="snapshot", volume=0))
        pool = P.engine(comm="sharded", n_shards=2)
        vol = pool.create_volume()
        pool.frontend.submit(P.Request(req_id=1, kind="write", volume=vol,
                                       page=0, payload=P.pay(1)))
        with pytest.raises(ValueError):
            pool.frontend.submit(P.Request(req_id=2, kind="snapshot",
                                           volume=vol))
        assert pool.frontend.depth() == 1
        assert pool.drain() == 1
        return (pool.frontend.depth(),)
    _twin(scenario)


def test_ring_submit_rejects_out_of_range():
    """The port refuses ids past the device tables at submit (JAX clamps
    or drops them; a CUDA gather faults), before anything is queued."""
    eng = T.engine(n_shards=2)
    eng.create_volume()
    for kw in (dict(kind="read", volume=2 * 16), dict(kind="write", volume=0,
                                                      page=64),
               dict(kind="snapshot", volume=-1),
               dict(kind="unmap", volume=0, page=99)):
        with pytest.raises(ValueError, match="out of range"):
            eng.submit(Request(req_id=0, payload=T.pay(1), **kw))
    assert eng.depth() == 0


# ---------------------------------------------------------------------------
# ladder integration (the reference's benchmarks/ladder.py column map is
# copied into chip_smoke.py, which imports no JAX)
# ---------------------------------------------------------------------------
def test_ladder_has_ring_column():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    assert "+ring" in chip_smoke.LAYER_COLUMNS

    class Args:
        max_pages, n_extents = 64, 256
    eng = chip_smoke.ladder_engine(torch, "+ring", "full_engine", "cpu",
                                   Args, payload_shape=PAY, n_shards=2)
    assert eng.cfg.comm == "ring" and isinstance(eng.pool, RingEngine)
    vols = [eng.create_volume() for _ in range(2)]
    for i in range(24):
        eng.submit(Request(req_id=i, kind="write" if i % 2 else "read",
                           volume=vols[i % 2], page=i % 32, block=i % 8,
                           payload=np.ones(PAY, np.float32)))
    assert eng.drain() == 24
