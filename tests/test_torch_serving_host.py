"""Port parity: the copy-based serving baseline, ``ServeEngine(kv_backend=
"host")``, and ``ServePool``.

The same seeded requests go to the JAX engine and the port's
(``device="cpu"``: ``dbs_copy`` runs its plain version); weights cross with
``core/convert.py params_from_numpy``. Compared after every step: the
emitted token streams, the logits within atol 1e-4 and rtol 1e-4 (fp32;
the packages sum in other orders), the DBS extent map and ``dbs.stats``.
Where a greedy step's top-2 logit margin in JAX is under 1e-3, that step's
token is not compared (only its logits): a tie that close may break either
way.

The reference's baseline has two faults the port does not copy (ROADMAP
queue 3), pinned by ``test_reference_baseline_faults``: idle decode lanes
take volume 0's block table and overwrite that session's position-0 K/V,
and a prompt padded past a window ring's length pushes real positions out
of the ring. So the lock-step twins hold volume 0 with an empty volume in
both engines (no session is volume 0), and use granite, which has no
window layers; the port's own gemma2 fork is checked against an
independent decode, bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.core import dbs as JD  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serving import GenRequest as JGen  # noqa: E402
from repro.serving import ServeEngine as JServe  # noqa: E402
from repro.serving import ServePool as JPool  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.core import dbs as TD  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.dbs import copy_kernel  # noqa: E402
from repro_torch.serving import GenRequest, ServeEngine, ServePool  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3


def _models(name):
    jc, tc = j_smoke(name), t_smoke(name)
    jp = j_init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(tc, jax.device_get(jp), "cpu")


@pytest.fixture(scope="module")
def granite():
    return _models("granite-3-8b")


@pytest.fixture(scope="module")
def gemma2():
    return _models("gemma2-2b")


def _pair(m, hold_volume_0=True, **kw):
    jc, tc, jp, tp = m
    je = JServe(jc, jp, kv_backend="host", record_logits=True, **kw)
    te = ServeEngine(tc, tp, kv_backend="host", record_logits=True,
                     device="cpu", **kw)
    if hold_volume_0:
        assert je.volumes.create().vid == te.volumes.create().vid == 0
    return je, te


def _margin(logits):
    top = np.sort(np.asarray(logits))[-2:]
    return float(top[1] - top[0])


def _check(je, te, jo, to):
    """One lock step's comparison (see the module note)."""
    assert [r for r, _ in jo] == [r for r, _ in to]
    for (rid, jt), (_, tt) in zip(jo, to):
        jl = je.live[rid].logit_trace[-1]
        np.testing.assert_allclose(te.live[rid].logit_trace[-1], jl, **TOL)
        if _margin(jl) >= MARGIN:
            assert jt == tt, (rid, jt, tt)
    assert np.array_equal(te.state.table.numpy(),
                          np.asarray(jax.device_get(je.state.table)))
    assert TD.stats(te.state) == JD.stats(je.state)


def _lockstep(je, te, steps):
    for _ in range(steps):
        _check(je, te, je.step(), te.step())


def test_continuous_batching_completes_all(granite):
    """More requests than slots: every request ends with its tokens, equal
    to the reference's, and no extent or volume leaks."""
    jc = granite[0]
    je, te = _pair(granite, n_slots=4, max_len=64)
    rng = np.random.default_rng(0)
    for rid in range(6):
        prompt = rng.integers(0, jc.vocab_size, size=(8 + rid,))
        je.submit(JGen(req_id=rid, prompt=prompt.copy(), max_new=4))
        te.submit(GenRequest(req_id=rid, prompt=prompt.copy(), max_new=4))
    for _ in range(40):
        _lockstep(je, te, 1)
        if all(g.done for g in te.live.values()) and te.frontend.depth() == 0:
            break
    assert all(g.done for g in je.live.values())
    outs = {rid: g.out_tokens for rid, g in te.live.items()}
    assert len(outs) == 6 and all(len(v) == 4 for v in outs.values()), outs
    te.volumes.delete(0)
    st = TD.stats(te.state)
    assert st["extents_used"] == 0 and st["volumes"] == 0, st


def test_fork_matches_reference_in_lock_step(granite):
    """Fork mid-decode (twin of tests/test_serving.py's fork test): both
    sessions' next allocation CoWs the shared frontier page through
    ``dbs_copy`` (K and V of every layer), and each step equals the
    reference's; greedy decoding from the shared prefix continues
    identically in parent and child."""
    jc, tc = granite[:2]
    je, te = _pair(granite, n_slots=4, max_len=64)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jc.vocab_size, size=(9,))
    je.submit(JGen(req_id=0, prompt=prompt.copy(), max_new=10))
    te.submit(GenRequest(req_id=0, prompt=prompt.copy(), max_new=10))
    _lockstep(je, te, 3)
    jch, tch = je.fork(0, 1, max_new=5), te.fork(0, 1, max_new=5)
    assert jch is not None and tch is not None
    assert (jch.slot, jch.volume) == (tch.slot, tch.volume)
    copy_kernel.reset_counts()
    _lockstep(je, te, 12)
    # the first step after the fork CoWs the frontier page on both sides:
    # one copy per pool (K and V of each global layer)
    assert copy_kernel.PLAIN_CALLS["dbs_copy"] == 2 * tc.n_layers
    par, chi = te.live[0].out_tokens, te.live[1].out_tokens
    assert chi == par[:len(chi)], (par, chi)
    assert len(par) == 10 and len(chi) == 5


@pytest.mark.parametrize("model,prompt_len,hold", [
    ("granite-3-8b", 8, False),     # idle lanes overwrite volume 0
    ("gemma2-2b", 17, True),        # the padded prompt overruns the ring
])
def test_reference_baseline_faults(model, prompt_len, hold, request):
    """The port's baseline agrees with the zero-copy engine (JAX's, which
    prefills unpadded and masks idle lanes) where the reference's baseline
    does not (module note)."""
    m = request.getfixturevalue("granite" if model.startswith("granite")
                                else "gemma2")
    jc, _, jp, _ = m
    je, te = _pair(m, hold_volume_0=hold, n_slots=4, max_len=64)
    jz = JServe(jc, jp, n_slots=4, max_len=64, record_logits=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jc.vocab_size, size=(prompt_len + r,))
               for r in range(2)]
    for rid, p in enumerate(prompts):
        for e, G in ((je, JGen), (te, GenRequest), (jz, JGen)):
            e.submit(G(req_id=rid, prompt=p.copy(), max_new=6))
    for e in (je, te, jz):
        e.run(max_steps=20)
    worst = 0.0
    for rid in range(2):
        want = np.stack(jz.live[rid].logit_trace)
        np.testing.assert_allclose(np.stack(te.live[rid].logit_trace), want,
                                   **TOL)
        assert te.live[rid].out_tokens == jz.live[rid].out_tokens
        worst = max(worst, float(np.abs(np.stack(
            je.live[rid].logit_trace) - want).max()))
    assert worst > 1e-2, f"the reference's baseline fault did not show " \
                         f"({worst})"


def test_gemma2_fork_equals_independent_decode(gemma2):
    """gemma2's window layers keep their K/V in per-slot rings: the fork
    copies the parent's ring rows (ROADMAP queue 3), so with slots left
    stale by earlier requests the forked streams are bit-identical to two
    sessions decoded independently. The 30-token prompt pads past the
    16-token window."""
    _, tc, _, tp = gemma2
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, tc.vocab_size, size=(30,))
    eng = ServeEngine(tc, tp, n_slots=4, max_len=64, kv_backend="host",
                      record_logits=True, device="cpu")
    for r in range(3):                     # leave stale rings in the slots
        eng.submit(GenRequest(req_id=100 + r, prompt=rng.integers(
            0, tc.vocab_size, size=(20,)), max_new=3))
    eng.run(max_steps=10)
    eng.submit(GenRequest(req_id=0, prompt=prompt.copy(), max_new=12))
    for _ in range(4):
        eng.step()
    child = eng.fork(0, 1, max_new=8)
    assert child is not None and child.slot != eng.live[0].slot
    eng.run(max_steps=20)
    ref = ServeEngine(tc, tp, n_slots=4, max_len=64, kv_backend="host",
                      record_logits=True, device="cpu")
    for rid in (0, 1):
        ref.submit(GenRequest(req_id=rid, prompt=prompt.copy(), max_new=12))
    ref.run(max_steps=20)
    assert eng.live[0].out_tokens == ref.live[0].out_tokens
    n = len(eng.live[1].logit_trace)
    assert eng.live[1].out_tokens == ref.live[1].out_tokens[:len(
        eng.live[1].out_tokens)]
    np.testing.assert_array_equal(np.stack(eng.live[0].logit_trace[4:]),
                                  np.stack(ref.live[0].logit_trace[4:]))
    np.testing.assert_array_equal(np.stack(eng.live[1].logit_trace),
                                  np.stack(ref.live[1].logit_trace[4:4 + n]))
    st = TD.stats(eng.state)
    assert st["extents_used"] == 0 and st["volumes"] == 0, st


@pytest.mark.parametrize("kv_backend", ["fused", "host"])
def test_serve_pool_shards_and_completes(granite, kv_backend):
    """Twin of tests/test_serving.py's ServePool test: requests hash across
    two shards and all complete with the reference pool's tokens, the fork
    stays on its parent's shard, and every shard ends leak-free."""
    jc, tc, jp, tp = granite
    pools = (JPool(jc, jp, n_shards=2, n_slots=4, max_len=64),
             ServePool(tc, tp, n_shards=2, n_slots=4, max_len=64,
                       kv_backend=kv_backend, device="cpu"))
    rng = np.random.default_rng(2)
    for rid in range(5):
        prompt = rng.integers(0, jc.vocab_size, size=(6 + rid,))
        pools[0].submit(JGen(req_id=rid, prompt=prompt.copy(), max_new=6))
        pools[1].submit(GenRequest(req_id=rid, prompt=prompt.copy(),
                                   max_new=6))
    for p in pools:
        for _ in range(3):
            p.step()
        child = p.fork(0, 10, max_new=2)       # rid 10 hashes to shard 0...
        assert child is not None
        assert p.shard_of(10) == p.shard_of(0)   # ...as its parent does
    outs = [p.run(max_steps=30) for p in pools]
    assert set(outs[1]) == set(range(5)) | {10}
    assert all(len(outs[1][r]) == 6 for r in range(5))
    assert outs[1] == outs[0]
    assert not pools[1]._home
    for sh in pools[1].shards:
        st = TD.stats(sh.state)
        assert st["extents_used"] == 0 and st["volumes"] == 0, st
    with pytest.raises(ValueError, match="n_shards"):
        ServePool(tc, tp, n_shards=0, device="cpu")
