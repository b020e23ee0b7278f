"""Port parity: configs, layers, attention, blocks and the model.

The same inputs, made with numpy from a seed, go through the JAX function
and its port (``repro_torch.models``) on the CPU. Weights cross through
``core/convert.py params_from_numpy``. Per-module outputs must agree
within atol 1e-5 and rtol 1e-5; prefill and per-step decode logits of a
whole model within atol 1e-4 and rtol 1e-4 (fp32 throughout; the two
packages sum in other orders). The models are the smoke configs of
granite-3-8b (global attention, GQA 4:1) and gemma2-2b (alternating local
and global layers, logit caps, post-norms, gated GELU, sqrt(d) embedding
scale).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.configs.base import ExecutionPlan  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

MOD = dict(atol=1e-5, rtol=1e-5)
E2E = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["granite-3-8b", "gemma2-2b"]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else jax.device_get(x))


def _close(a, b, tol=MOD):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(JAX config, port config, JAX params, port params)."""
    jc = jcfgs.smoke_config(request.param)
    tc = tcfgs.smoke_config(request.param)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(tc, jax.device_get(jp), "cpu")
    return jc, tc, jp, tp


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", jcfgs.ALL_ARCHS)
def test_configs_equal_the_reference(name):
    assert tcfgs.ALL_ARCHS == jcfgs.ALL_ARCHS
    assert (dataclasses.asdict(tcfgs.get_config(name))
            == dataclasses.asdict(jcfgs.get_config(name)))
    assert (dataclasses.asdict(tcfgs.smoke_config(name))
            == dataclasses.asdict(jcfgs.smoke_config(name)))
    jsigs, tsigs = JB.layer_sigs(jcfgs.get_config(name)), TB.layer_sigs(
        tcfgs.get_config(name))
    assert [dataclasses.astuple(s) for s in jsigs] == [
        dataclasses.astuple(s) for s in tsigs]
    assert [(tuple(map(dataclasses.astuple, s.sigs)), s.count, s.first_layer)
            for s in JB.layer_schedule(jcfgs.get_config(name))] == [
        (tuple(map(dataclasses.astuple, s.sigs)), s.count, s.first_layer)
        for s in TB.layer_schedule(tcfgs.get_config(name))]


def test_unported_layer_kinds_raise():
    # every layer kind of configs/ is ported: deepseek-v3's MLA layers and
    # MTP head build (tests/test_torch_mla.py holds them against the
    # reference); a kind the port does not know still raises
    cfg = tcfgs.smoke_config("deepseek-v3-671b")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    assert "mtp" in params and "kv_b" in params["layers_unstacked"][0]
    bogus = TB.LayerSig("sparse", 0, "dense")
    with pytest.raises(ValueError, match="unknown layer kind 'sparse'"):
        TB.init_layer(torch.Generator().manual_seed(0), cfg, bogus)
    with pytest.raises(ValueError, match="unknown layer kind"):
        TB.init_layer_cache(cfg, bogus, 1, 16, paged=True)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gemma", [False, True])
def test_rms_norm(gemma):
    rng = np.random.default_rng(1)
    x, w = _normal(rng, 3, 5, 32), _normal(rng, 32)
    _close(TL.rms_norm(_t(x), _t(w), 1e-6, gemma_style=gemma),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                       gemma_style=gemma))


@pytest.mark.parametrize("act", ["silu", "gelu_tanh", "relu_sq"])
def test_activations_and_softcap(act):
    rng = np.random.default_rng(2)
    x = _normal(rng, 4, 64) * 3
    _close(TL.activation_fn(act)(_t(x)), JL.activation_fn(act)(jnp.asarray(x)))
    for cap in (0.0, 5.0):
        _close(TL.softcap(_t(x), cap), JL.softcap(jnp.asarray(x), cap))


@pytest.mark.parametrize("theta", [10_000.0, 0.0])
def test_rope(theta):
    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 7, 4, 16)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    _close(TL.apply_rope(_t(x), _t(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    _close(TL.rope_frequencies(16, 10_000.0),
           JL.rope_frequencies(16, 10_000.0))


def test_mlp_embeddings_and_logits(model):
    jc, tc, jp, tp = model
    rng = np.random.default_rng(4)
    x = _normal(rng, 2, 5, jc.d_model)
    lp_j = jax.tree.map(lambda a: a[0], jp["segments"][0]["pos0"])
    lp_t = TM.unstack_params(tp, tc)["layers_unstacked"][0]
    _close(TL.apply_mlp(lp_t["mlp"], _t(x), tc),
           JL.apply_mlp(lp_j["mlp"], jnp.asarray(x), jc))
    tok = rng.integers(0, jc.vocab_size, (2, 5)).astype(np.int32)
    emb_t = TL.embed_tokens(tp["embed"], _t(tok), tc, torch.float32)
    emb_j = JL.embed_tokens(jp["embed"], jnp.asarray(tok), jc, jnp.float32)
    _close(emb_t, emb_j)
    _close(TL.lm_logits(tp["embed"], _t(x), tc),
           JL.lm_logits(jp["embed"], jnp.asarray(x), jc))


def test_port_init_params_shapes_match_reference(model):
    """The port draws its own weights (from a torch.Generator) in the
    reference's shapes, one dict per layer."""
    jc, tc, jp, _ = model
    tp = TM.init_params(torch.Generator().manual_seed(0), tc)
    ref = TM.unstack_params(params_from_numpy(tc, jax.device_get(jp), "cpu"),
                            tc)

    def shapes(tree, path=""):
        if isinstance(tree, dict):
            return sorted(x for k, v in tree.items()
                          for x in shapes(v, f"{path}/{k}"))
        if isinstance(tree, list):
            return sorted(x for i, v in enumerate(tree)
                          for x in shapes(v, f"{path}/{i}"))
        return [(path, tuple(tree.shape))]
    assert shapes(tp["layers_unstacked"]) == shapes(ref["layers_unstacked"])
    assert shapes(tp["embed"]) == shapes(ref["embed"])
    assert TM.param_count_actual(tp) == sum(
        x.size for x in jax.tree.leaves(jp))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _qkv(rng, b, sq, sk, h, kv, d):
    return (_normal(rng, b, sq, h, d), _normal(rng, b, sk, kv, d),
            _normal(rng, b, sk, kv, d))


def _pos(b, s, off=0):
    return np.broadcast_to(np.arange(off, off + s, dtype=np.int32),
                           (b, s)).copy()


@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 0.0), (0, 50.0),
                                        (7, 30.0)])
def test_dense_chunked_banded_attention(window, cap):
    rng = np.random.default_rng(5)
    b, s, h, kv, d = 2, 24, 4, 2, 16
    q, k, v = _qkv(rng, b, s, s, h, kv, d)
    pos = _pos(b, s)
    args_t = [_t(a) for a in (q, k, v, pos, pos)]
    args_j = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    kw = dict(window=window, logit_cap=cap)
    ref = JA.dense_attention(*args_j, **kw)
    _close(TA.dense_attention(*args_t, **kw), ref)
    for chunk in (8, 10, 1024):           # 10 -> gcd(24, 10) = 2
        _close(TA.chunked_attention(*args_t, chunk=chunk, **kw),
               JA.chunked_attention(*args_j, chunk=chunk, **kw))
    if window:
        for qc in (4, 6, 8):              # band < S: the loop over q chunks
            _close(TA.banded_attention(*args_t, window=window,
                                       logit_cap=cap, q_chunk=qc),
                   JA.banded_attention(*args_j, window=window,
                                       logit_cap=cap, q_chunk=qc))


@pytest.mark.parametrize("window,cap", [(0, 0.0), (6, 20.0)])
def test_decode_partial_finish_and_merge(window, cap):
    rng = np.random.default_rng(6)
    b, s, h, kv, d = 3, 20, 4, 2, 16
    q = _normal(rng, b, 1, h, d)
    kc, vc = _normal(rng, b, s, kv, d), _normal(rng, b, s, kv, d)
    q_pos = np.array([[3], [11], [19]], np.int32)
    k_pos = _pos(b, s)
    args_t = [_t(a) for a in (q, kc, vc, q_pos, k_pos)]
    args_j = [jnp.asarray(a) for a in (q, kc, vc, q_pos, k_pos)]
    kw = dict(window=window, logit_cap=cap)
    _close(TA.decode_attention(*args_t, **kw),
           JA.decode_attention(*args_j, **kw))
    parts_t = [TA.decode_partial(args_t[0], args_t[1][:, sl], args_t[2][:, sl],
                                 args_t[3], args_t[4][:, sl], **kw)
               for sl in (slice(0, 8), slice(8, 20))]
    parts_j = [JA.decode_partial(args_j[0], args_j[1][:, sl], args_j[2][:, sl],
                                 args_j[3], args_j[4][:, sl], **kw)
               for sl in (slice(0, 8), slice(8, 20))]
    for pt, pj in zip(parts_t, parts_j):
        for a, c in zip(pt, pj):
            _close(a, c)
        _close(TA.finish_partial(*pt), JA.finish_partial(*pj))
    merged_t = TA.merge_partials(*[torch.stack(x) for x in zip(*parts_t)])
    merged_j = JA.merge_partials(*[jnp.stack(x) for x in zip(*parts_j)])
    _close(merged_t, merged_j)


@pytest.mark.parametrize("stride,rank,stripe", [(1, 0, True), (2, 1, True),
                                                (2, 0, False), (3, 2, True)])
def test_paged_gather_and_decode_attention(stride, rank, stripe):
    rng = np.random.default_rng(7)
    b, h, kv, d, page, p_max, e = 3, 4, 2, 8, 4, 6, 24
    pool_k, pool_v = _normal(rng, e, page, kv, d), _normal(rng, e, page, kv, d)
    table = (rng.permutation(e)[:b * p_max].reshape(b, p_max)).astype(np.int32)
    table[2, 4:] = -1                      # holes past the length
    q = _normal(rng, b, 1, h, d)
    q_pos = np.array([[5], [23], [13]], np.int32)
    _close(TA.paged_gather(_t(pool_k), _t(table)),
           JA.paged_gather(jnp.asarray(pool_k), jnp.asarray(table)))
    kw = dict(window=0, logit_cap=0.0, page_owner_stride=stride,
              owner_rank=rank, stripe_slice=stripe)
    for window in (0, 9):
        kw["window"] = window
        got = TA.paged_decode_attention(_t(q), _t(pool_k), _t(pool_v),
                                        _t(table), _t(q_pos), **kw)
        want = JA.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
            jnp.asarray(table), jnp.asarray(q_pos), **kw)
        for a, c in zip(got, want):
            _close(a, c)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _cache_pair(jc, tc, sig, batch, max_len, paged, rng):
    """Equal random caches for both packages (pools and rings filled so
    that stale contents would show)."""
    jcache = JB.init_layer_cache(jc, sig_j(sig), batch, max_len, paged=paged,
                                 dtype=jnp.float32)
    tcache = TB.init_layer_cache(tc, sig, batch, max_len, paged=paged,
                                 dtype=torch.float32)
    assert sorted(jcache) == sorted(tcache)
    out_j, out_t = {}, {}
    for key, arr in jcache.items():
        assert tuple(arr.shape) == tuple(tcache[key].shape), key
        if key == "block_table":
            n = arr.shape[0] * arr.shape[1]
            val = rng.permutation(n).reshape(arr.shape).astype(np.int32)
        elif key == "ring_pos":
            val = np.full(arr.shape, 2 ** 31 - 1, np.int32)
        else:
            val = _normal(rng, *arr.shape)
        out_j[key], out_t[key] = jnp.asarray(val), _t(val)
    return out_j, out_t


def sig_j(sig):
    return JB.LayerSig(sig.attn, sig.window, sig.mlp)


@pytest.mark.parametrize("paged", [True, False])
def test_apply_block_prefill_then_decode(model, paged):
    """Every layer kind of the model (local rings, paged pools with default
    block tables, dense caches): a prefill block then three decode blocks,
    outputs and caches against the reference."""
    jc, tc, jp, tp = model
    rng = np.random.default_rng(8)
    batch, max_len, s = 2, 32, 16
    layers_t = TM.unstack_params(tp, tc)["layers_unstacked"]
    layers_j = JM.unstack_params(jp, jc)["layers_unstacked"]
    seen = set()
    for li, sig in enumerate(TB.layer_sigs(tc)):
        if sig in seen:
            continue
        seen.add(sig)
        cj, ct = _cache_pair(jc, tc, sig, batch, max_len, paged, rng)
        if "block_table" in cj:
            bt = np.asarray(JM.default_block_tables(jc, batch, max_len))
            cj["block_table"], ct["block_table"] = jnp.asarray(bt), _t(bt)
        x = _normal(rng, batch, s, jc.d_model)
        pos = _pos(batch, s)
        ctx_j = JB.BlockCtx(mode="prefill", q_pos=jnp.asarray(pos),
                            k_pos=jnp.asarray(pos), cache=cj)
        ctx_t = TB.BlockCtx(mode="prefill", q_pos=_t(pos), k_pos=_t(pos),
                            cache=ct)
        yj, cj, _ = JB.apply_block(jc, sig_j(sig), layers_j[li],
                                   jnp.asarray(x), ctx_j)
        yt, ct, _ = TB.apply_block(tc, sig, layers_t[li], _t(x), ctx_t)
        _close(yt, yj)
        for step in range(3):
            x1 = _normal(rng, batch, 1, jc.d_model)
            qp = np.full((batch, 1), s + step, np.int32)
            ctx_j = JB.BlockCtx(mode="decode", q_pos=jnp.asarray(qp),
                                cache=cj)
            ctx_t = TB.BlockCtx(mode="decode", q_pos=_t(qp), cache=ct)
            yj, cj, _ = JB.apply_block(jc, sig_j(sig), layers_j[li],
                                       jnp.asarray(x1), ctx_j)
            yt, ct, _ = TB.apply_block(tc, sig, layers_t[li], _t(x1), ctx_t)
            _close(yt, yj)
        for key in cj:
            _close(ct[key], cj[key])


@pytest.mark.parametrize("impl", ["dense", "chunked", "cuda"])
def test_full_attention_dispatch(model, impl):
    """``attn_impl="cuda"`` (the flash kernel's wrapper, its plain version
    on the CPU) against the reference's ``"pallas"`` in interpret mode."""
    jc, tc, _, _ = model
    rng = np.random.default_rng(9)
    s, hd = 13, jc.resolved_head_dim
    q, k, v = _qkv(rng, 1, s, s, jc.n_heads, jc.n_kv_heads, hd)
    pos = _pos(1, s)
    for sig in set(TB.layer_sigs(tc)):
        got = TB._full_attention(
            tc, sig, _t(q), _t(k), _t(v),
            TB.BlockCtx(mode="prefill", q_pos=_t(pos), k_pos=_t(pos),
                        attn_impl=impl))
        want = JB._full_attention(
            jc, sig_j(sig), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            JB.BlockCtx(mode="prefill", q_pos=jnp.asarray(pos),
                        k_pos=jnp.asarray(pos),
                        attn_impl="pallas" if impl == "cuda" else impl))
        _close(got, want)


# ---------------------------------------------------------------------------
# the model: prefill then decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [True, False])
def test_prefill_and_decode_logits(model, paged):
    jc, tc, jp, tp = model
    rng = np.random.default_rng(10)
    batch, max_len, s = 2, 32, 16        # s % page == 0 for the paged write
    jplan = JB  # noqa: F841  (the reference plan is built below)
    from repro.configs.base import ExecutionPlan as JPlan
    jplan = JPlan(remat="none", attn_impl="chunked", compute_dtype="float32")
    tplan = ExecutionPlan(remat="none", attn_impl="chunked",
                          compute_dtype="float32")
    jcache = JM.init_cache(jc, batch, max_len, paged=paged, dtype=jnp.float32)
    tcache = TM.init_cache(tc, batch, max_len, paged=paged,
                           dtype=torch.float32)
    if paged:
        bt = np.asarray(JM.default_block_tables(jc, batch, max_len))
        _close(TM.default_block_tables(tc, batch, max_len), bt)
        jcache = JM.with_block_tables(jcache, jnp.asarray(bt))
        tcache = TM.with_block_tables(tcache, _t(bt))
    tok = rng.integers(0, jc.vocab_size, (batch, s)).astype(np.int32)
    lj, jcache = JM.prefill(jp, jnp.asarray(tok), jc, jplan, jcache)
    lt, tcache = TM.prefill(tp, _t(tok), tc, tplan, tcache)
    _close(lt, lj, E2E)
    nxt = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    for step in range(4):
        pos = np.full((batch,), s + step, np.int32)
        lj, jcache = JM.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos),
                                    jc, jplan, jcache)
        lt, tcache = TM.decode_step(tp, _t(nxt), _t(pos), tc, tplan, tcache)
        _close(lt, lj, E2E)
        nxt = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
