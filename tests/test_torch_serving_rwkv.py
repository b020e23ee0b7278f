"""Port parity: serving an RWKV-6 net, ``ServeEngine(kv_backend="host")``
and ``ServePool``, on ``smoke_config("rwkv6-3b")``.

The reference's engine cannot serve a pure-recurrent net (ROADMAP queue
3; ``test_reference_rwkv_faults`` pins how), so the port's engine is held
against an independent JAX greedy decode of each request: ``M.prefill`` of
the unpadded prompt, then ``M.decode_step`` from its last token, as the
engine's own first step does. Weights cross with ``core/convert.py
params_from_numpy``. fp32; logits within atol 1e-4 and rtol 1e-4 (the
packages sum in other orders), tokens equal. The port runs on the CPU
(``device="cpu"``), where the scan's wrapper takes its plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.configs.base import ExecutionPlan as JPlan  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import GenRequest as JGen  # noqa: E402
from repro.serving import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import ExecutionPlan  # noqa: E402
from repro_torch.core import dbs as TD  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.dbs import copy_kernel  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as scan_kernel  # noqa: E402
from repro_torch.serving import GenRequest, ServeEngine, ServePool  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
JAX_PLAN = JPlan(remat="none", attn_impl="chunked", compute_dtype="float32")
_j_decode = jax.jit(JM.decode_step, static_argnums=(3, 4))


@pytest.fixture(scope="module")
def rwkv():
    jc, tc = j_smoke("rwkv6-3b"), t_smoke("rwkv6-3b")
    jp = j_init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(tc, jax.device_get(jp), "cpu")


def _jax_decode(m, prompt, n, cache=None):
    """Greedy tokens and per-step logits of one request, decoded by the
    reference's model functions alone (batch 1, unpadded prompt). A given
    ``cache`` is prefilled as it stands (not reset)."""
    jc, _, jp, _ = m
    if cache is None:
        cache = JM.init_cache(jc, 1, 8, dtype=jnp.float32)
    s = len(prompt)
    _, cache = JM.prefill(jp, jnp.asarray(prompt)[None], jc, JAX_PLAN, cache)
    last, toks, logits = int(prompt[-1]), [], []
    for t in range(n):
        lg, cache = _j_decode(jp, jnp.asarray([last]),
                              jnp.asarray([s + t], jnp.int32), jc, JAX_PLAN,
                              cache)
        logits.append(np.asarray(lg[0]))
        last = int(jnp.argmax(lg[0]))
        toks.append(last)
    return toks, np.stack(logits), cache


def _engine(m, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 64)
    return ServeEngine(m[1], m[3], kv_backend="host", record_logits=True,
                       device="cpu", **kw)


def _prompts(m, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, m[0].vocab_size, size=(n,)) for n in lens]


def _matches_reference(m, g, prompt):
    toks, logits, _ = _jax_decode(m, prompt, len(g.out_tokens))
    np.testing.assert_allclose(np.stack(g.logit_trace), logits, **TOL)
    assert g.out_tokens == toks


def _leak_free(eng):
    st = TD.stats(eng.state)
    assert st["extents_used"] == 0 and st["volumes"] == 0, st


def test_serve_matches_independent_decode(rwkv):
    """Two requests decoded together equal two independent reference
    decodes; the scan runs once per layer per prompt and per decode step
    (``attn_impl="cuda"``: on the CPU, the wrapper's plain version), and
    no ``dbs_copy`` runs, as there is no KV pool."""
    tc = rwkv[1]
    eng = _engine(rwkv, plan=ExecutionPlan(attn_impl="cuda",
                                           compute_dtype="float32"))
    prompts = _prompts(rwkv, (13, 21), seed=0)
    for rid, p in enumerate(prompts):
        eng.submit(GenRequest(req_id=rid, prompt=p.copy(), max_new=5))
    scan_kernel.reset_counts()
    copy_kernel.reset_counts()
    eng.step()                               # both prefills, one decode
    assert scan_kernel.PLAIN_CALLS["rwkv6_scan"] == 3 * tc.n_layers
    eng.run(max_steps=10)
    assert scan_kernel.PLAIN_CALLS["rwkv6_scan"] == 7 * tc.n_layers
    assert scan_kernel.LAUNCHES["rwkv6_scan"] == 0
    assert copy_kernel.PLAIN_CALLS["dbs_copy"] == 0
    for rid, p in enumerate(prompts):
        assert len(eng.live[rid].out_tokens) == 5
        _matches_reference(rwkv, eng.live[rid], p)
    _leak_free(eng)


def test_continuous_batching_recycles_slots(rwkv):
    """Seven requests through two slots: each later request lands in a slot
    an earlier one left (its state moved on by idle decode lanes too), and
    still equals an independent reference decode, because admission zeroes
    the slot's recurrent rows."""
    eng = _engine(rwkv, n_slots=2)
    prompts = _prompts(rwkv, (5, 9, 13, 17, 6, 11, 8), seed=1)
    for rid, p in enumerate(prompts):
        eng.submit(GenRequest(req_id=rid, prompt=p.copy(), max_new=3 + rid % 3))
    eng.run(max_steps=60)
    assert all(g.done for g in eng.live.values())
    for rid, p in enumerate(prompts):
        assert len(eng.live[rid].out_tokens) == 3 + rid % 3
        _matches_reference(rwkv, eng.live[rid], p)
    _leak_free(eng)


def test_fork_copies_recurrent_state(rwkv):
    """A session forked after its 4th decode step into a slot that earlier
    requests left stale: the child takes a copy of the parent's recurrent
    rows, so parent and child both continue the reference's greedy stream
    (greedy decoding from the shared state is deterministic)."""
    eng = _engine(rwkv)
    for r, p in enumerate(_prompts(rwkv, (7, 12, 9), seed=2)):
        eng.submit(GenRequest(req_id=100 + r, prompt=p, max_new=3))
    eng.run(max_steps=10)                    # leave stale state in slots
    prompt = _prompts(rwkv, (15,), seed=3)[0]
    eng.submit(GenRequest(req_id=0, prompt=prompt.copy(), max_new=10))
    for _ in range(4):
        eng.step()
    child = eng.fork(0, 1, max_new=6)
    assert child is not None and child.slot != eng.live[0].slot
    eng.run(max_steps=20)
    par, chi = eng.live[0], eng.live[1]
    assert len(par.out_tokens) == 10 and len(chi.out_tokens) == 6
    toks, logits, _ = _jax_decode(rwkv, prompt, 10)
    assert par.out_tokens == toks
    np.testing.assert_allclose(np.stack(par.logit_trace), logits, **TOL)
    assert chi.out_tokens == toks[:6]
    np.testing.assert_allclose(np.stack(chi.logit_trace), logits[4:6], **TOL)
    _leak_free(eng)


def test_serve_pool_two_shards(rwkv):
    """Requests hash across two host-backed shards and each equals its
    independent reference decode; the fork stays on its parent's shard.
    As in the granite twin (tests/test_torch_serving_host.py), the fork
    ends before its parent: the reverse order leaks the shared prefix's
    extents in both packages (``test_reference_parent_first_delete_leaks``)."""
    tc, tp = rwkv[1], rwkv[3]
    pool = ServePool(tc, tp, n_shards=2, n_slots=4, max_len=64,
                     kv_backend="host", record_logits=True, device="cpu")
    prompts = _prompts(rwkv, (6, 7, 8, 9, 10), seed=4)
    for rid, p in enumerate(prompts):
        pool.submit(GenRequest(req_id=rid, prompt=p.copy(), max_new=6))
    for _ in range(3):
        pool.step()
    assert pool.fork(0, 10, max_new=2) is not None
    assert pool.shard_of(10) == pool.shard_of(0)
    outs = pool.run(max_steps=30)
    assert set(outs) == set(range(5)) | {10}
    for rid, p in enumerate(prompts):
        g = pool.shards[pool.shard_of(rid)].live[rid]
        _matches_reference(rwkv, g, p)
    # the child inherits the parent's three tokens and adds one
    assert outs[10] == outs[0][:4]
    for sh in pool.shards:
        _leak_free(sh)


@pytest.mark.parametrize("child_first", [True, False])
def test_reference_parent_first_delete_leaks(child_first):
    """A reference behaviour the port keeps (ROADMAP queue 3): deleting a
    fork's parent volume before the fork frees neither the shared prefix's
    extents then (the fork still maps them) nor later (their owner is the
    parent's snapshot, not the fork's). The same DBS calls on both packages
    give the same stats; deleting the fork first frees everything."""
    from repro.core import dbs as JD
    ends = []
    for D, arr, kw in ((JD, jnp.asarray, {}),
                       (TD, torch.as_tensor, {"device": "cpu"})):
        st = D.make_state(16, 4, 8, **kw)
        st, vol = D.create_volume(st)
        st, _ = D.write_pages(st, vol, arr(np.arange(2, dtype=np.int32)),
                              arr(np.ones(2, np.uint32).astype(
                                  np.int64 if D is TD else np.uint32)))
        st, child = D.clone(st, vol)
        # both sides then write their shared frontier page (CoW)
        st, _ = D.write_pages(st, arr(np.array([int(vol), int(child)],
                                               np.int32)),
                              arr(np.ones(2, np.int32)),
                              arr(np.ones(2, np.uint32).astype(
                                  np.int64 if D is TD else np.uint32)))
        for v in ((child, vol) if child_first else (vol, child)):
            st = D.delete_volume(st, v)
        ends.append({k: int(v) for k, v in D.stats(st).items()})
    assert ends[0] == ends[1]
    assert ends[1]["volumes"] == 0
    assert ends[1]["extents_used"] == (0 if child_first else 1)


def test_fused_backend_raises_as_reference(rwkv):
    """Zero-copy serving needs a paged layer, in both packages."""
    jc, tc, jp, tp = rwkv
    with pytest.raises(ValueError, match="pure-recurrent"):
        JServe(jc, jp, kv_backend="fused")
    with pytest.raises(ValueError, match="pure-recurrent"):
        ServeEngine(tc, tp, kv_backend="fused", device="cpu")


def test_reference_rwkv_faults(rwkv):
    """The reference's behaviour beside the port's (ROADMAP queue 3)."""
    jc, tc, jp, tp = rwkv
    page = jc.page_blocks
    prompt = _prompts(rwkv, (13,), seed=5)[0]
    # 1. the reference's host engine slices the nested RWKV cache dict
    je = JServe(jc, jp, kv_backend="host", n_slots=2, max_len=64)
    je.submit(JGen(req_id=0, prompt=prompt.copy(), max_new=4))
    with pytest.raises(KeyError):
        je.step()
    # 2. its baseline pads the prompt to a page multiple, and the pads
    # enter the recurrence: greedy tokens change; the port's engine
    # prefills unpadded and equals the unpadded decode
    padded = np.pad(prompt, (0, (-len(prompt)) % page))
    assert len(padded) > len(prompt)
    toks, logits, _ = _jax_decode(rwkv, prompt, 4)
    ptoks, plogits, _ = _jax_decode(rwkv, padded, 4)
    assert ptoks != toks and np.abs(plogits - logits).max() > 1e-2
    eng = _engine(rwkv)
    eng.submit(GenRequest(req_id=0, prompt=prompt.copy(), max_new=4))
    eng.run(max_steps=8)
    assert eng.live[0].out_tokens == toks
    # 3. the reference's prefill reshapes into s // 256 equal chunks and
    # fails at 513 tokens; the port takes a ragged last chunk, and its
    # 513-token prefill equals the reference's 512-token prefill followed
    # by one decode step
    long = _prompts(rwkv, (513,), seed=6)[0]
    with pytest.raises(TypeError, match="reshape"):
        JM.prefill(jp, jnp.asarray(long)[None], jc, JAX_PLAN,
                   JM.init_cache(jc, 1, 8, dtype=jnp.float32))
    _, jcache = JM.prefill(jp, jnp.asarray(long[:512])[None], jc, JAX_PLAN,
                           JM.init_cache(jc, 1, 8, dtype=jnp.float32))
    jl, jcache = JM.decode_step(jp, jnp.asarray(long[512:]),
                                jnp.asarray([512], jnp.int32), jc, JAX_PLAN,
                                jcache)
    from repro_torch.models import model as TM
    tcache = TM.init_cache(tc, 1, 8, dtype=torch.float32, device="cpu")
    tl, tcache = TM.prefill(tp, torch.from_numpy(long)[None], tc,
                            ExecutionPlan(compute_dtype="float32"), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for jcl, tcl in zip(jcache, tcache):
        for key in ("wkv", "shift_t", "shift_c"):
            np.testing.assert_allclose(tcl["rwkv"][key].numpy(),
                                       np.asarray(jcl["rwkv"][key]), **TOL)
    # 4. the reference never resets a slot's recurrent state at admission:
    # a prompt prefilled over the last occupant's state decodes otherwise
    # than from a fresh state; the port's recycled slot equals a fresh one
    first = _prompts(rwkv, (9,), seed=7)[0]
    *_, stale = _jax_decode(rwkv, first, 3)
    stoks, slogits, _ = _jax_decode(rwkv, prompt, 4, cache=stale)
    assert np.abs(slogits - logits).max() > 1e-2
    eng = _engine(rwkv, n_slots=1)
    eng.submit(GenRequest(req_id=0, prompt=first.copy(), max_new=3))
    eng.submit(GenRequest(req_id=1, prompt=prompt.copy(), max_new=4))
    eng.run(max_steps=12)
    assert eng.live[0].slot == eng.live[1].slot == -1
    assert eng.live[1].out_tokens == toks
    np.testing.assert_allclose(np.stack(eng.live[1].logit_trace), logits,
                               **TOL)
