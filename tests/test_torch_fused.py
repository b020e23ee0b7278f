"""Port parity: the fused step and the fused backend's pump.

1. ``fused_step``/``fused_step_read`` run on the same slot table, replica
   states, pools, watermarks, batch and round-robin cursor in both
   packages (the port's copies carried over by ``convert``), step after
   step with snapshots and clones between them: every output equals.
2. A replica fails mid-stream: writes keep mirroring to the survivors,
   reads stay right and equal to the JAX engine's, and the survivors stay
   consistent. The streamed delta rebuild then leaves every replica's
   state, pool and watermarks equal to the JAX engine's, and the rebuilt
   replica alone serves every block.
3. One pump makes exactly one host fetch, and the step itself reads
   nothing back to the host.
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
from repro.core import dbs as jdbs  # noqa: E402
from repro.core import fused as jfused  # noqa: E402
from repro.core import slots as jslots  # noqa: E402
from repro_torch.core import Engine, EngineConfig, Request  # noqa: E402
from repro_torch.core import backends as tbackends  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import dbs as tdbs  # noqa: E402
from repro_torch.core import fused as tfused  # noqa: E402

CPU = torch.device("cpu")
N_E, N_V, N_P, PAGE, D, B, N_SLOTS = 20, 3, 6, 4, 8, 12, 16


def _np(x):
    return jax.device_get(dataclasses.asdict(x)) if dataclasses.is_dataclass(
        x) else np.asarray(jax.device_get(x))


def _same(jx, pt, where):
    a = _np(jx)
    b = convert.to_numpy(pt) if dataclasses.is_dataclass(pt) else pt.numpy()

    def cmp(x, y, path):
        if isinstance(x, dict):
            for k in x:
                cmp(x[k], y[k], f"{path}.{k}")
            return
        assert np.array_equal(np.asarray(x), np.asarray(y)), (where, path)
    cmp(a, b, "")


def _batch(rng, step, n_vols, writes=True):
    want = rng.random(B) < 0.85
    is_write = (rng.random(B) < 0.6) if writes else np.zeros(B, bool)
    lanes = dict(
        want=want, is_write=is_write & want,
        volume=rng.integers(0, n_vols, B).astype(np.int32),
        page=rng.integers(0, N_P, B).astype(np.int32),
        block=rng.integers(0, PAGE, B).astype(np.int32),
        payload=rng.integers(0, 256, (B, D)).astype(np.float32),
        queue=rng.integers(0, 4, B).astype(np.int32))
    jb = jfused.FusedBatch(step=jnp.int32(step),
                           **{k: jnp.asarray(v) for k, v in lanes.items()})
    tb = tfused.FusedBatch(step=torch.tensor(step, dtype=torch.int32),
                           **{k: torch.from_numpy(v) for k, v in lanes.items()})
    return jb, tb


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("jkernel,tkernel", [("pallas", "cuda"),
                                             ("xla", "torch"),
                                             ("xla", "ref")])
def test_fused_steps_match(jkernel, tkernel, seed):
    rng = np.random.default_rng(seed)
    n_r = 3
    jtable = jslots.make_table(N_SLOTS)
    jstates = []
    for _ in range(n_r):
        st = jdbs.make_state(N_E, N_V, N_P)
        st, _ = jdbs.create_volume(st)
        st, _ = jdbs.create_volume(st)
        jstates.append(st)
    pools = [rng.integers(0, 256, (N_E + 1, PAGE, D)).astype(np.float32)] * n_r
    jpools = tuple(jnp.asarray(p) for p in pools)
    jprs = tuple(jnp.zeros((N_V, N_P), jnp.int32) for _ in range(n_r))
    ttable = convert.table_from_numpy(_np(jtable), CPU)
    tstates, tpools, tprs = convert.replicas_from_numpy(
        [_np(s) for s in jstates], pools, [_np(p) for p in jprs], CPU)
    jstates = tuple(jstates)
    n_vols = 2
    for step in range(8):
        if step == 3:                         # snapshot -> CoW traffic
            jstates = tuple(jdbs.snapshot(s, jnp.int32(0))[0] for s in jstates)
            tstates = tuple(tdbs.snapshot(s, 0)[0] for s in tstates)
        if step == 5:                         # clone: shared CoW sources
            jstates = tuple(jdbs.clone(s, jnp.int32(1))[0] for s in jstates)
            tstates = tuple(tdbs.clone(s, 1)[0] for s in tstates)
            n_vols = 3
        jb, tb = _batch(rng, step, n_vols, writes=step % 4 != 2)
        if step % 4 == 2:
            jtable, jok, jreads = jfused.fused_step_read(
                jtable, jstates, jpools, jb, step, kernel=jkernel)
            ttable, tok, treads = tfused.fused_step_read(
                ttable, tstates, tpools, tb, step, kernel=tkernel)
        else:
            jtable, jstates, jpools, jprs, jok, jreads = jfused.fused_step(
                jtable, jstates, jpools, jprs, jb, step, kernel=jkernel)
            ttable, tstates, tpools, tprs, tok, treads = tfused.fused_step(
                ttable, tstates, tpools, tprs, tb, step, kernel=tkernel)
        where = f"step {step}"
        _same(jok, tok, where + " ok")
        _same(jreads, treads, where + " reads")
        _same(jtable, ttable, where + " table")
        for i in range(n_r):
            _same(jstates[i], tstates[i], where + f" state {i}")
            _same(jpools[i], tpools[i], where + f" pool {i}")
            _same(jprs[i], tprs[i], where + f" page_rev {i}")


def _engines(**kw):
    base = dict(comm="fused", n_replicas=3, payload_shape=(D,),
                page_blocks=PAGE, n_extents=64, max_pages=32, batch=8)
    base.update(kw)
    jk = base.pop("jkernel", "xla")
    return (JEngine(JConfig(kernel=jk, **base)),
            Engine(EngineConfig(kernel="cuda", device="cpu", **base)))


def test_replica_failure_mid_stream():
    jeng, teng = _engines()
    shadow = {}
    vols = (jeng.create_volume(), teng.create_volume())
    assert vols[0] == vols[1]
    vol = vols[1]

    def run(reqs):
        got = []
        for eng, R in ((jeng, JRequest), (teng, Request)):
            rs = [R(req_id=i, kind=k, volume=vol, page=p, block=0,
                    payload=None if pay is None else np.asarray(pay))
                  for i, (k, p, pay) in enumerate(reqs)]
            for r in rs:
                eng.submit(r)
            eng.drain()
            got.append([None if r.result is None else np.asarray(r.result)
                        for r in rs])
        for a, b in zip(*got):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a, b)
        return got[1]

    run([("write", p, np.full(D, p, np.float32)) for p in range(10)])
    for eng in (jeng, teng):
        eng.backend.fail(1)                    # mid-stream
    reqs = []
    for i in range(10):
        reqs.append(("write", 10 + i, np.full(D, 100 + i, np.float32)))
        reqs.append(("read", i, None))
    out = run(reqs)
    for j, (k, p, _) in enumerate(reqs):
        if k == "read":
            assert np.array_equal(out[j], np.full(D, p, np.float32))
    out = run([("read", p, None) for p in range(20)])
    for p in range(20):
        shadow[p] = p if p < 10 else 100 + p - 10
        assert np.array_equal(out[p], np.full(D, shadow[p], np.float32))
    assert teng.backend.consistent()
    revs = [int(r.state.revision) for r in teng.backend.replicas]
    assert revs[1] < revs[0] == revs[2]      # the failed one stopped
    for eng in (jeng, teng):                 # the streamed delta rebuild
        eng.control("rebuild", replica=1)
    moved = [e.backend.transports[1].pages_moved for e in (jeng, teng)]
    assert moved[0] == moved[1] > 0
    for i, (jr, tr) in enumerate(zip(jeng.backend.replicas,
                                     teng.backend.replicas)):
        _same(jr.state, tr.state, f"rebuilt state {i}")
        _same(jr.pool, tr.pool, f"rebuilt pool {i}")
        _same(jr.page_rev, tr.page_rev, f"rebuilt page_rev {i}")
    assert teng.backend.consistent()
    teng.backend.fail(0)                     # the rebuilt replica alone
    teng.backend.fail(2)
    out = run([("read", p, None) for p in range(20)])
    for p in range(20):
        assert np.array_equal(out[p], np.full(D, shadow[p], np.float32))
    with pytest.raises(RuntimeError, match="last healthy"):
        teng.backend.fail(1)


def test_pump_is_single_host_fetch(monkeypatch):
    """Within one pump: exactly one host fetch (``fetch_to_host``), and the
    step body reads nothing back — any ``.item()``, ``.tolist()``,
    ``.numpy()``, ``.cpu()``, truth test or int conversion of a tensor
    inside the step raises here."""
    _, eng = _engines(batch=16)
    vol = eng.create_volume()
    for i in range(10):
        eng.submit(Request(req_id=i, kind="write" if i % 2 else "read",
                           volume=vol, page=i, block=0,
                           payload=np.ones(D, np.float32)))
    eng.pump()
    for i in range(10):
        eng.submit(Request(req_id=100 + i, kind="write" if i % 2 else "read",
                           volume=vol, page=i, block=0,
                           payload=np.ones(D, np.float32)))
    calls = []
    real = tbackends.fetch_to_host
    monkeypatch.setattr(tbackends, "fetch_to_host",
                        lambda *t: (calls.append(1), real(*t))[1])

    def forbid(name):
        def _raise(*a, **k):
            raise AssertionError(f"host read-back in the step: {name}")
        return _raise

    for step_fn in ("fused_step", "fused_step_read"):
        inner = getattr(tbackends, step_fn)

        def guarded(*a, _inner=inner, **k):
            with monkeypatch.context() as m:
                for name in ("item", "tolist", "numpy", "cpu", "__bool__",
                             "__int__", "__index__", "nonzero"):
                    m.setattr(torch.Tensor, name, forbid(name))
                return _inner(*a, **k)
        monkeypatch.setattr(tbackends, step_fn, guarded)
    assert eng.pump() == 10
    assert len(calls) == 1, f"expected 1 completion fetch, saw {len(calls)}"
