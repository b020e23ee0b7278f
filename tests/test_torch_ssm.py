"""Port parity: RWKV-6 time mix, channel mix, one RWKV block, and the model's
prefill and decode on ``smoke_config("rwkv6-3b")``.

Weights come from the reference's initialisers and cross as numpy
(``core/convert.py params_from_numpy``); inputs and carried states are
drawn with numpy. fp32; tolerance atol 1e-4 and rtol 1e-4 (the packages
sum in other orders). Prompt lengths 13 and 300 run at the block's own
RWKV chunk (``BlockCtx.ssm_chunk``, 256, under which both are one chunk by
the reference's rule) and at shorter chunks that split them (13 tokens at
chunk 8 stay one chunk; 300 at chunk 30 are ten). ``impl="cuda"`` on the
CPU takes the kernel wrapper's plain version and must give the same
numbers. Lengths the reference cannot chunk are in
tests/test_torch_serving_rwkv.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.configs.base import ExecutionPlan as JPlan  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import ExecutionPlan  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as scan_kernel  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
NAME = "rwkv6-3b"
CHUNK = TB.BlockCtx.ssm_chunk           # 256, the reference's too


@pytest.fixture(scope="module")
def layer():
    jc, tc = j_smoke(NAME), t_smoke(NAME)
    jp = JS.init_rwkv6(jax.random.PRNGKey(1), jc)
    return jc, tc, jp, params_from_numpy(tc, jax.device_get(jp), "cpu")


@pytest.fixture(scope="module")
def model():
    jc, tc = j_smoke(NAME), t_smoke(NAME)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(tc, jax.device_get(jp), "cpu")


def _state(cfg, b, seed):
    """A non-zero carried state, as numpy."""
    rng = np.random.default_rng(seed)
    h = cfg.d_model // cfg.ssm.rwkv_head_dim
    hd = cfg.ssm.rwkv_head_dim
    return {"wkv": rng.standard_normal((b, h, hd, hd)).astype(np.float32),
            "shift_t": rng.standard_normal((b, cfg.d_model)).astype(
                np.float32),
            "shift_c": rng.standard_normal((b, cfg.d_model)).astype(
                np.float32)}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jax.device_get(want)), **TOL)


def test_init_matches_reference_shapes(layer):
    jc, tc, jp, _ = layer
    tp = TS.init_rwkv6(torch.Generator().manual_seed(0), tc)
    assert set(tp) == set(jp)
    for key, val in tp.items():
        assert tuple(val.shape) == jp[key].shape, key
    st_j = JS.rwkv6_init_state(jc, 3, jnp.float32)
    st_t = TS.rwkv6_init_state(tc, 3, torch.float32)
    assert {k: tuple(v.shape) for k, v in st_t.items()} == \
        {k: v.shape for k, v in st_j.items()}
    assert st_t["wkv"].dtype == torch.float32


@pytest.mark.parametrize("s,chunk", [(13, CHUNK), (300, CHUNK), (13, 8),
                                     (300, 30), (1, CHUNK)])
@pytest.mark.parametrize("impl", ["chunked", "cuda"])
def test_time_and_channel_mix(layer, s, chunk, impl):
    jc, tc, jp, tp = layer
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    st = _state(jc, 2, seed=s + 1)
    jy, jst = JS.rwkv6_time_mix(jp, jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in st.items()},
                                jc, chunk=chunk)
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    scan_kernel.reset_counts()
    ty, tst_new = TS.rwkv6_time_mix(tp, torch.from_numpy(x), tst, tc,
                                    chunk=chunk, impl=impl)
    assert scan_kernel.PLAIN_CALLS["rwkv6_scan"] == (impl == "cuda")
    _close(ty, jy)
    for key in ("wkv", "shift_t"):
        _close(tst_new[key], jst[key])
    jc_y, jc_st = JS.rwkv6_channel_mix(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    tc_y, tc_st = TS.rwkv6_channel_mix(tp, torch.from_numpy(x), tst)
    _close(tc_y, jc_y)
    _close(tc_st["shift_c"], jc_st["shift_c"])


@pytest.mark.parametrize("mode,s", [("prefill", 13), ("prefill", 300),
                                    ("decode", 1)])
def test_rwkv_block(model, mode, s):
    """One RWKV block (norms, time mix, channel mix, residuals) with a
    carried cache; the port updates the cache in place."""
    jc, tc, jp, tp = model
    sig = TB.layer_sigs(tc)[0]
    jsig = JB.layer_sigs(jc)[0]
    lp_t = TM.unstack_params(tp, tc)["layers_unstacked"][0]
    lp_j = jax.tree.map(lambda a: a[0], jp["segments"][0]["pos0"])
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    st = _state(jc, 2, seed=3)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    jctx = JB.BlockCtx(mode=mode, q_pos=jnp.asarray(pos),
                       k_pos=jnp.asarray(pos),
                       cache={"rwkv": {k: jnp.asarray(v)
                                       for k, v in st.items()}})
    cache_t = {"rwkv": {k: torch.from_numpy(v.copy()) for k, v in st.items()}}
    tctx = TB.BlockCtx(mode=mode, q_pos=torch.from_numpy(pos.copy()),
                       k_pos=torch.from_numpy(pos.copy()), cache=cache_t)
    jx, jcache, _ = JB.apply_block(jc, jsig, lp_j, jnp.asarray(x), jctx)
    tx, tcache, _ = TB.apply_block(tc, sig, lp_t, torch.from_numpy(x), tctx)
    _close(tx, jx)
    assert tcache is cache_t
    for key in ("wkv", "shift_t", "shift_c"):
        _close(cache_t["rwkv"][key], jcache["rwkv"][key])


@pytest.mark.parametrize("s", [13, 300])
@pytest.mark.parametrize("impl", ["chunked", "cuda"])
def test_model_prefill_and_decode(model, s, impl):
    """``prefill`` then four greedy ``decode_step``s (batch 2) from the
    same prompts: logits after every step, and the caches at the end."""
    jc, tc, jp, tp = model
    rng = np.random.default_rng(s)
    toks = rng.integers(0, jc.vocab_size, (2, s))
    jplan = JPlan(remat="none", attn_impl="chunked", compute_dtype="float32")
    tplan = ExecutionPlan(remat="none", attn_impl=impl,
                          compute_dtype="float32")
    jcache = JM.init_cache(jc, 2, 512, dtype=jnp.float32)
    tcache = TM.init_cache(tc, 2, 512, dtype=torch.float32, device="cpu")
    jl, jcache = JM.prefill(jp, jnp.asarray(toks), jc, jplan, jcache)
    tl, tcache = TM.prefill(tp, torch.from_numpy(toks), tc, tplan, tcache)
    _close(tl, jl)
    for t in range(4):
        nxt = np.array(jnp.argmax(jl, -1))
        pos = np.full((2,), s + t, np.int32)
        jl, jcache = JM.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos),
                                    jc, jplan, jcache)
        tl, tcache = TM.decode_step(tp, torch.from_numpy(nxt),
                                    torch.from_numpy(pos), tc, tplan, tcache)
        _close(tl, jl)
    for jcl, tcl in zip(jcache, tcache):
        for key in ("wkv", "shift_t", "shift_c"):
            _close(tcl["rwkv"][key], jcl["rwkv"][key])


def test_init_params_draws_the_rwkv_schedule():
    """The port's own random init: untied head, one RWKV parameter dict per
    layer, and a prefill that runs on it."""
    tc = t_smoke(NAME)
    p = TM.init_params(torch.Generator().manual_seed(0), tc)
    assert p["embed"]["lm_head"].shape == (tc.d_model, tc.vocab_size)
    assert len(p["layers_unstacked"]) == tc.n_layers
    assert all(set(lp) == {"ln1", "ln2", "tmix_cmix"}
               for lp in p["layers_unstacked"])
    cache = TM.init_cache(tc, 1, 64, dtype=torch.float32, device="cpu")
    logits, _ = TM.prefill(p, torch.arange(9)[None], tc,
                           ExecutionPlan(compute_dtype="float32"), cache)
    assert logits.shape == (1, tc.vocab_size)
    assert torch.isfinite(logits).all()
    assert cache[0]["rwkv"]["wkv"].abs().sum() > 0


def test_pallas_impl_raises(layer):
    """``attn_impl="pallas"`` names the TPU kernel: the RWKV path refuses it,
    as the port's flash dispatch does, rather than running the plain form."""
    _, tc, _, tp = layer
    x = torch.zeros((1, 4, tc.d_model))
    st = TS.rwkv6_init_state(tc, 1, torch.float32)
    scan_kernel.reset_counts()
    with pytest.raises(ValueError, match="attn_impl='cuda'"):
        TS.rwkv6_time_mix(tp, x, st, tc, impl="pallas")
    assert scan_kernel.PLAIN_CALLS["rwkv6_scan"] == 0
