"""Port parity: serving the hybrid and MoE families, ``ServeEngine`` on
``kv_backend="fused"`` (zero-copy) and ``"host"`` (the copy-based
baseline), with smoke configs of granite-moe-3b-a800m and hymba-1.5b.

granite-moe: the same seeded requests go to the JAX ``ServeEngine`` and the
port's (``device="cpu"``: the kernel wrappers run their plain versions),
stepped in lock step; tokens are equal and each step's recorded logits
agree within atol 1e-4 and rtol 1e-4 (fp32, a whole model; the decode
step's MoE sums a token's experts in another order, ``layers.apply_moe``).
Where a JAX step's top-2 margin is under 1e-3 only its logits are
compared. On ``host`` volume 0 is held by an empty volume in both engines
(the reference baseline's idle lanes write over volume 0's K/V:
tests/test_torch_serving_host.py). On ``sharded`` and ``ring`` (two KV
shards) the port's engine equals its ``fused`` one.

hymba (on ``sharded`` and ``ring`` as well): the reference's engine
cannot serve it (``test_reference_hybrid_
serving_faults``), so each request's per-step logits are held, within the
same tolerance, against an independent JAX greedy decode of the request
by the reference's model functions: ``M.prefill`` of the unpadded prompt
into dense caches, then ``M.decode_step`` from its last token, as the
engine's first step does. Where the reference's Mamba chunk rule rejects
the prompt's length (513), that decode prefills the whole chunks (512) and
steps through the rest. The traffic recycles slots, forks a session and
holds prompts longer than the window (16 in the smoke config).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.configs.base import ExecutionPlan as JPlan  # noqa: E402
from repro.core import dbs as JD  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.serving import GenRequest as JGen  # noqa: E402
from repro.serving import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import ExecutionPlan  # noqa: E402
from repro_torch.core import dbs as TD  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import GenRequest, ServeEngine  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3
SSM_CHUNK = 256                 # BlockCtx.ssm_chunk, both packages
JAX_PLAN = JPlan(remat="none", attn_impl="chunked", compute_dtype="float32")
PLAN = ExecutionPlan(remat="none", attn_impl="chunked",
                     compute_dtype="float32")
_j_decode = jax.jit(JM.decode_step, static_argnums=(3, 4))
_j_prefill = jax.jit(JM.prefill, static_argnums=(2, 3))
_DECODED = {}                   # the JAX decodes, shared by the tests


def _models(name):
    jc, tc = j_smoke(name), t_smoke(name)
    jp = j_init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(tc, jax.device_get(jp), "cpu")


@pytest.fixture(scope="module")
def granite():
    return _models("granite-moe-3b-a800m")


@pytest.fixture(scope="module")
def hymba():
    return _models("hymba-1.5b")


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)) for n in lens]


def _margin(logits):
    top = np.sort(np.asarray(logits))[-2:]
    return float(top[1] - top[0])


def _leak_free(eng):
    st = eng.state
    if eng._sharded:                # the stacked (S, ...) state
        assert not bool((st.extent_owner >= 0).any()
                        | (st.vol_head >= 0).any())
        return
    st = TD.stats(st)
    assert st["volumes"] == 0 and st["extents_used"] == 0, st


# ---------------------------------------------------------------------------
# granite-moe: engine against engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_backend", ["fused", "host"])
def test_granite_moe_serving_matches_jax_engine(granite, kv_backend):
    """Six requests on four slots (recycled), lock step: tokens, logits,
    and the DBS stats after every step; nothing leaks."""
    jc, tc, jp, tp = granite
    kw = dict(n_slots=4, max_len=64, kv_backend=kv_backend)
    je = JServe(jc, jp, record_logits=True, **kw)
    te = ServeEngine(tc, tp, record_logits=True, device="cpu", **kw)
    if kv_backend == "host":
        assert je.volumes.create().vid == te.volumes.create().vid == 0
    # two prompt lengths: each new length compiles the reference's prefill
    prompts = _prompts(jc.vocab_size, (9, 20, 9, 20, 20, 9), 0)
    for rid, p in enumerate(prompts):
        je.submit(JGen(req_id=rid, prompt=p.copy(), max_new=5))
        te.submit(GenRequest(req_id=rid, prompt=p.copy(), max_new=5))
    for _ in range(40):
        jo, to = je.step(), te.step()
        assert [r for r, _ in jo] == [r for r, _ in to]
        for (rid, jt), (_, tt) in zip(jo, to):
            jl = je.live[rid].logit_trace[-1]
            np.testing.assert_allclose(te.live[rid].logit_trace[-1], jl,
                                       **TOL)
            if _margin(jl) >= MARGIN:
                assert jt == tt, (rid, jt, tt)
        assert TD.stats(te.state) == JD.stats(je.state)
        if all(g.done for g in te.live.values()) and \
                te.frontend.depth() == 0:
            break
    assert all(g.done for g in je.live.values())
    assert all(len(g.out_tokens) == 5 for g in te.live.values())
    if kv_backend == "host":
        te.volumes.delete(0)
    _leak_free(te)


@pytest.mark.parametrize("kv_backend", ["sharded", "ring"])
def test_granite_moe_sharded_and_ring_equal_fused(granite, kv_backend):
    """The KV store on two shards, and the ring on it: the same requests
    give the zero-copy ``fused`` engine's tokens and logits (which the
    test above holds to the reference's engine)."""
    jc, tc, _, tp = granite
    prompts = _prompts(jc.vocab_size, (9, 20, 9, 20, 20, 9), 0)
    runs = []
    for kvb, kw in (("fused", {}), (kv_backend, dict(kv_shards=2))):
        eng = ServeEngine(tc, tp, kv_backend=kvb, n_slots=4, max_len=64,
                          record_logits=True, device="cpu", **kw)
        for rid, p in enumerate(prompts):
            eng.submit(GenRequest(req_id=rid, prompt=p.copy(), max_new=5))
        eng.run(max_steps=40)
        runs.append(eng)
    for rid in range(len(prompts)):
        want, got = runs[0].live[rid], runs[1].live[rid]
        assert got.out_tokens == want.out_tokens
        np.testing.assert_allclose(np.stack(got.logit_trace),
                                   np.stack(want.logit_trace), **TOL)
    _leak_free(runs[1])


# ---------------------------------------------------------------------------
# hymba: engine against the reference's model functions
# ---------------------------------------------------------------------------
def _reference_prefix(s):
    """The longest prefix of an s-token prompt the reference's Mamba chunk
    rule can prefill in one call."""
    n = max(1, s // SSM_CHUNK)
    return n * (s // n)


def _jax_decode(m, prompt, n, max_len=64):
    """Per-step logits of one request's greedy decode by the reference's
    model functions alone (batch 1, unpadded prompt, dense caches), kept
    for the other tests of the module."""
    key = (prompt.tobytes(), n, max_len)
    if key not in _DECODED:
        _DECODED[key] = _decode(m, prompt, n, max_len)
    return _DECODED[key]


def _decode(m, prompt, n, max_len):
    jc, _, jp, _ = m
    cache = JM.init_cache(jc, 1, max_len, paged=False, dtype=jnp.float32)
    s, w = len(prompt), _reference_prefix(len(prompt))
    _, cache = _j_prefill(jp, jnp.asarray(prompt[:w])[None], jc, JAX_PLAN,
                          cache)
    for t in range(w, s):                # the tokens the rule leaves over
        _, cache = _j_decode(jp, jnp.asarray([int(prompt[t])]),
                             jnp.asarray([t], jnp.int32), jc, JAX_PLAN, cache)
    last, logits = int(prompt[-1]), []
    for t in range(n):
        lg, cache = _j_decode(jp, jnp.asarray([last]),
                              jnp.asarray([s + t], jnp.int32), jc, JAX_PLAN,
                              cache)
        logits.append(np.asarray(lg[0]))
        last = int(jnp.argmax(lg[0]))
    return np.stack(logits)


def _engine(m, kv_backend, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 64)
    return ServeEngine(m[1], m[3], kv_backend=kv_backend, record_logits=True,
                       device="cpu", **kw)


def _mamba_rows(eng, slot):
    return [c["mamba"]["ssm"][slot].clone() for c in eng.caches]


@pytest.mark.parametrize("kv_backend", ["fused", "host", "sharded", "ring"])
def test_hymba_serving_matches_model_decode(hymba, kv_backend):
    """Six requests on four slots, prompts on both sides of the window:
    every step's logits equal the independent decode's, tokens too; the
    slots were recycled with a live Mamba state left by their last
    occupant (moved on by idle decode lanes), which admission zeroes.
    The sharded KV store (and the ring on it) runs two shards."""
    jc = hymba[0]
    eng = _engine(hymba, kv_backend,
                  **(dict(kv_shards=2) if kv_backend == "sharded" else {}))
    prompts = _prompts(jc.vocab_size, (9, 26, 9, 26, 26, 9), 1)
    for rid, p in enumerate(prompts):
        eng.submit(GenRequest(req_id=rid, prompt=p.copy(), max_new=5))
    eng.run(max_steps=40)
    for rid, p in enumerate(prompts):
        g = eng.live[rid]
        assert len(g.out_tokens) == 5
        want = _jax_decode(hymba, p, 5)
        np.testing.assert_allclose(np.stack(g.logit_trace), want, **TOL)
        assert g.out_tokens == [int(np.argmax(lg)) for lg in want]
    assert all(bool(r.abs().sum() > 0) for slot in range(eng.n_slots)
               for r in _mamba_rows(eng, slot))
    _leak_free(eng)


@pytest.mark.parametrize("kv_backend", ["fused", "host"])
def test_hymba_fork_copies_mamba_state(hymba, kv_backend):
    """A session forked after its 3rd decode step: the child's slot takes
    the parent's Mamba state (and window rings), so both continue the
    independent decode's logits."""
    jc = hymba[0]
    eng = _engine(hymba, kv_backend)
    prompt = _prompts(jc.vocab_size, (26,), 2)[0]
    eng.submit(GenRequest(req_id=0, prompt=prompt.copy(), max_new=9))
    for _ in range(3):
        eng.step()
    child = eng.fork(0, 1, max_new=6)
    assert child is not None
    par_slot = eng.live[0].slot
    for a, b in zip(_mamba_rows(eng, par_slot), _mamba_rows(eng, child.slot)):
        assert torch.equal(a, b) and bool(a.abs().sum() > 0)
    eng.run(max_steps=20)
    want = _jax_decode(hymba, prompt, 9)
    par, chi = eng.live[0], eng.live[1]
    np.testing.assert_allclose(np.stack(par.logit_trace), want, **TOL)
    n_c = len(chi.logit_trace)
    assert n_c == 3 and len(chi.out_tokens) == 6
    np.testing.assert_allclose(np.stack(chi.logit_trace), want[3:3 + n_c],
                               **TOL)
    assert chi.out_tokens == par.out_tokens[:6]
    _leak_free(eng)


def test_hymba_prompt_the_reference_cannot_chunk(hymba):
    """513 tokens (the reference's Mamba reshape rejects it, chunk 256):
    the port's prefill logits equal the reference's prefill of 512 tokens
    and one decode step of the 513th; served zero-copy, every step equals
    the independent decode's."""
    jc, tc, jp, tp = hymba
    prompt = _prompts(jc.vocab_size, (513,), 3)[0]
    assert _reference_prefix(513) == 512
    caches = TM.init_cache(tc, 1, 520, paged=False, dtype=torch.float32)
    lt, _ = TM.prefill(tp, torch.from_numpy(prompt)[None], tc, PLAN, caches)
    jcache = JM.init_cache(jc, 1, 520, paged=False, dtype=jnp.float32)
    _, jcache = _j_prefill(jp, jnp.asarray(prompt[:512])[None], jc,
                           JAX_PLAN, jcache)
    lj, _ = _j_decode(jp, jnp.asarray([int(prompt[512])]),
                      jnp.asarray([512], jnp.int32), jc, JAX_PLAN, jcache)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    eng = _engine(hymba, "fused", n_slots=2, max_len=528)
    eng.submit(GenRequest(req_id=0, prompt=prompt.copy(), max_new=3))
    eng.run(max_steps=8)
    np.testing.assert_allclose(np.stack(eng.live[0].logit_trace),
                               _jax_decode(hymba, prompt, 3, max_len=528),
                               **TOL)
    _leak_free(eng)


def test_reference_hybrid_serving_faults(hymba):
    """The reference's faults on hymba (ROADMAP queue 3), pinned on the JAX
    side; the port corrects each.

    1. Its engine cannot serve a hybrid net: prefill slices each per-slot
       cache entry as ``v[slot:slot + 1]``, which shortens a Mamba tuple.
    2. Its zero-copy prefill hands a paged (global) layer no Mamba state
       and writes none back, so decode would start from the slot's old
       state; in the port that run differs from the model-level decode.
    3. Its engine has no reset of a recycled slot's Mamba state; without
       the port's, a recycled request differs from the model-level decode.
    4. Its ``mamba_forward`` rejects lengths its chunk rule cannot divide.
    """
    jc, tc, jp, tp = hymba
    prompts = _prompts(jc.vocab_size, (9, 26), 4)
    for kv_backend in ("fused", "host"):                       # fault 1
        je = JServe(jc, jp, n_slots=2, max_len=64, kv_backend=kv_backend)
        je.submit(JGen(req_id=0, prompt=prompts[0].copy(), max_new=2))
        with pytest.raises(ValueError, match="not enough values to unpack"):
            je.step()
    with pytest.raises(TypeError, match="reshape"):           # fault 4
        JS.mamba_forward(JM.unstack_params(jp, jc)["layers_unstacked"][0][
            "mamba"], jnp.zeros((1, 513, jc.d_model)), chunk=SSM_CHUNK)

    want = _jax_decode(hymba, prompts[1], 4)

    def served(eng):
        eng.submit(GenRequest(req_id=9, prompt=prompts[1].copy(), max_new=4))
        eng.run(max_steps=10)
        return np.stack(eng.live[9].logit_trace)

    # fault 2: the paged layers' Mamba rows put back after prefill
    eng = _engine(hymba, "fused", n_slots=2)
    eng.submit(GenRequest(req_id=0, prompt=prompts[0].copy(), max_new=2))
    eng.run(max_steps=4)
    paged = [eng.caches[li]["mamba"] for li, *_ in eng._paged]
    inner = eng._prefill_one_zero

    def prefill_dropping_paged_state(g):
        old = [{k: t[g.slot].clone() for k, t in st.items()} for st in paged]
        inner(g)
        for st, o in zip(paged, old):
            for k in st:
                st[k][g.slot] = o[k]
    eng._prefill_one_zero = prefill_dropping_paged_state
    assert np.abs(served(eng) - want).max() > 1e-3
    # fault 3: no reset at admission (the slot holds the last occupant's
    # state); the same engine with the reset serves the request right
    for reset in (False, True):
        eng = _engine(hymba, "fused", n_slots=1)
        eng.submit(GenRequest(req_id=0, prompt=prompts[0].copy(), max_new=3))
        eng.run(max_steps=4)
        if not reset:
            eng._reset_recurrent = lambda slot: None
        got = served(eng)
        if reset:
            np.testing.assert_allclose(got, want, **TOL)
        else:
            assert np.abs(got - want).max() > 1e-3
