"""Port parity: MLA (deepseek-v3's low-rank latent attention) and the MTP
head (``models/blocks.py`` ``_project_mla``, ``_mla_output``, the MLA
branches of ``init_layer``, ``init_layer_cache`` and ``apply_block``;
``models/model.py`` ``init_params``' MTP head and ``mtp_hidden``).

The same inputs, made with numpy from a seed, go through the JAX function
and its port on the CPU; weights cross through ``core/convert.py
params_from_numpy``. Per-module outputs (the projections, one block's
prefill and decode outputs and caches) must agree within atol 1e-5 and
rtol 1e-5, the MTP head's output over a whole model's hidden states
within atol 1e-4 and rtol 1e-4 (fp32; the packages sum in other orders).
The config is deepseek-v3's smoke config (MLA with q_lora 32, kv_lora 16,
rope 8, nope 16, v 16 over 16 heads; one dense layer, one MoE layer, an
MTP block). The MLA cache is one latent KV head (keys 24 wide: latent
plus rope; values 16: the latent) on paged pools, dense caches and, for a
windowed MLA layer, ring buffers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ExecutionPlan as JPlan  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.configs.base import ATTN_MLA, MLP_DENSE, MLP_MOE  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import ExecutionPlan  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

MOD = dict(atol=1e-5, rtol=1e-5)
E2E = dict(atol=1e-4, rtol=1e-4)
NAME = "deepseek-v3-671b"
PLAN = ExecutionPlan(remat="none", attn_impl="chunked",
                     compute_dtype="float32")
J_PLAN = JPlan(remat="none", attn_impl="chunked", compute_dtype="float32")


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else jax.device_get(x))


def _close(a, b, tol=MOD):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pos(b, s, off=0):
    return np.broadcast_to(np.arange(off, off + s, dtype=np.int32),
                           (b, s)).copy()


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        return sorted(x for k, v in tree.items()
                      for x in _shapes(v, f"{path}/{k}"))
    if isinstance(tree, (list, tuple)):
        return sorted(x for i, v in enumerate(tree)
                      for x in _shapes(v, f"{path}/{i}"))
    return [(path, tuple(tree.shape))]


@pytest.fixture(scope="module")
def deepseek():
    """(JAX config, port config, JAX params, the port's copy of them)."""
    jc, tc = j_smoke(NAME), t_smoke(NAME)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(tc, jax.device_get(jp), "cpu")


def _layer(tc, tp, mlp):
    """The unstacked port parameters of the first layer with ``mlp``, and
    its index."""
    layers = TM.unstack_params(tp, tc)["layers_unstacked"]
    li = next(i for i, s in enumerate(TB.layer_sigs(tc)) if s.mlp == mlp)
    return li, layers[li]


@pytest.mark.parametrize("mlp", [MLP_DENSE, MLP_MOE])
def test_init_layer_shapes_match_reference(mlp):
    jc, tc = j_smoke(NAME), t_smoke(NAME)
    sig = TB.LayerSig(ATTN_MLA, 0, mlp)
    pt = TB.init_layer(torch.Generator().manual_seed(0), tc, sig)
    pj = JB.init_layer(jax.random.PRNGKey(0), jc,
                       JB.LayerSig(ATTN_MLA, 0, mlp))
    assert _shapes(pt) == _shapes(jax.device_get(pj))
    for key in ("q_a", "q_a_norm", "q_b", "kv_a", "kv_a_norm", "kv_b", "o"):
        assert key in pt
    assert not {"q", "k", "v"} & set(pt)


def test_port_init_params_draw_the_mtp_head(deepseek):
    """The port's own weights, MTP head included, in the reference's
    shapes and count."""
    jc, tc, jp, tp = deepseek
    mine = TM.init_params(torch.Generator().manual_seed(0), tc)
    ref = TM.unstack_params(tp, tc)
    assert _shapes(mine["layers_unstacked"]) == _shapes(
        ref["layers_unstacked"])
    assert _shapes(mine["mtp"]) == _shapes(jax.device_get(jp["mtp"]))
    assert TM.param_count_actual(mine) == sum(
        x.size for x in jax.tree.leaves(jp))
    assert "mtp" not in TM.init_params(torch.Generator().manual_seed(0),
                                       dataclasses.replace(tc, mtp_depth=0))


def test_params_from_numpy_carries_the_mtp_subtree(deepseek):
    """The crossed tree holds the MTP block, projection and norm, and the
    MLA leaves of every layer, equal to the reference's arrays."""
    _, tc, jp, tp = deepseek
    assert sorted(tp["mtp"]) == ["block", "norm", "proj"]
    jm = jax.device_get(jp["mtp"])
    for key in ("q_a", "q_a_norm", "q_b", "kv_a", "kv_a_norm", "kv_b", "o"):
        np.testing.assert_array_equal(_np(tp["mtp"]["block"][key]), jm[
            "block"][key])
    np.testing.assert_array_equal(_np(tp["mtp"]["proj"]), jm["proj"])
    np.testing.assert_array_equal(_np(tp["mtp"]["block"]["mlp"]["wi"]),
                                  jm["block"]["mlp"]["wi"])
    seg = jax.device_get(jp["segments"][0]["pos0"])
    np.testing.assert_array_equal(_np(tp["segments"][0]["pos0"]["kv_b"]),
                                  seg["kv_b"])


def test_project_mla_and_output_match_reference(deepseek):
    """The absorbed projections (q_eff, the latent key and value, the
    explicit scale 1/sqrt(nope + rope)) and the output through kv_b's
    v-part and o, at positions that do not start at 0."""
    jc, tc, jp, tp = deepseek
    li, lp = _layer(tc, tp, MLP_DENSE)
    lj = JM.unstack_params(jp, jc)["layers_unstacked"][li]
    rng = np.random.default_rng(1)
    b, s = 2, 7
    h = _normal(rng, b, s, jc.d_model)
    pos = _pos(b, s, off=5)
    ctx_t = TB.BlockCtx(mode="prefill", q_pos=_t(pos), k_pos=_t(pos))
    ctx_j = JB.BlockCtx(mode="prefill", q_pos=jnp.asarray(pos),
                        k_pos=jnp.asarray(pos))
    got = TB._project_mla(tc, lp, _t(h), ctx_t)
    want = JB._project_mla(jc, lj, jnp.asarray(h), ctx_j)
    m = tc.mla
    assert got[0].shape == (b, s, tc.n_heads,
                            m.kv_lora_rank + m.rope_head_dim)
    assert got[1].shape == (b, s, 1, m.kv_lora_rank + m.rope_head_dim)
    assert got[2].shape == (b, s, 1, m.kv_lora_rank)
    for a, c in zip(got[:3], want[:3]):
        _close(a, c)
    assert got[3] == pytest.approx(want[3]) == 1.0 / np.sqrt(
        m.nope_head_dim + m.rope_head_dim)
    o_lat = _normal(rng, b, s, tc.n_heads, m.kv_lora_rank)
    _close(TB._mla_output(tc, lp, _t(o_lat)),
           JB._mla_output(jc, lj, jnp.asarray(o_lat)))


def _mla_caches(jc, tc, sig, batch, max_len, paged, rng):
    """Equal random MLA caches for both packages, shapes checked: one KV
    head, keys kv_rank + rope wide, values kv_rank."""
    jcache = JB.init_layer_cache(jc, JB.LayerSig(sig.attn, sig.window,
                                                 sig.mlp),
                                 batch, max_len, paged=paged,
                                 dtype=jnp.float32)
    tcache = TB.init_layer_cache(tc, sig, batch, max_len, paged=paged,
                                 dtype=torch.float32)
    assert sorted(jcache) == sorted(tcache)
    m = tc.mla
    out_j, out_t = {}, {}
    for key, arr in jcache.items():
        assert tuple(arr.shape) == tuple(tcache[key].shape), key
        if key in ("ring_k", "pool_k", "k"):
            assert arr.shape[-2:] == (1, m.kv_lora_rank + m.rope_head_dim)
        if key in ("ring_v", "pool_v", "v"):
            assert arr.shape[-2:] == (1, m.kv_lora_rank)
        if key == "block_table":
            val = np.asarray(JM.default_block_tables(jc, batch, max_len))
        elif key == "ring_pos":
            val = np.full(arr.shape, 2 ** 31 - 1, np.int32)
        else:
            val = _normal(rng, *arr.shape)
        out_j[key], out_t[key] = jnp.asarray(val), _t(val)
    return out_j, out_t


@pytest.mark.parametrize("cache", ["paged", "dense", "ring"])
def test_mla_block_prefill_then_decode(deepseek, cache):
    """deepseek-v3's MLA layers (the dense one and the MoE one): a prefill
    block then three decode blocks, outputs and caches against the
    reference's ``apply_block``; ``ring`` runs the layer with a 12-token
    window over a 16-token prompt (the ring wraps)."""
    jc, tc, jp, tp = deepseek
    rng = np.random.default_rng(2)
    batch, max_len, s = 2, 32, 16
    layers_j = JM.unstack_params(jp, jc)["layers_unstacked"]
    for mlp in (MLP_DENSE, MLP_MOE):
        li, lp = _layer(tc, tp, mlp)
        sig = TB.LayerSig(ATTN_MLA, 12 if cache == "ring" else 0, mlp)
        sj = JB.LayerSig(sig.attn, sig.window, sig.mlp)
        cj, ct = _mla_caches(jc, tc, sig, batch, max_len, cache == "paged",
                             rng)
        x = _normal(rng, batch, s, jc.d_model)
        pos = _pos(batch, s)
        ctx_j = JB.BlockCtx(mode="prefill", q_pos=jnp.asarray(pos),
                            k_pos=jnp.asarray(pos), cache=cj)
        ctx_t = TB.BlockCtx(mode="prefill", q_pos=_t(pos), k_pos=_t(pos),
                            cache=ct)
        yj, cj, _ = JB.apply_block(jc, sj, layers_j[li], jnp.asarray(x),
                                   ctx_j)
        yt, ct, _ = TB.apply_block(tc, sig, lp, _t(x), ctx_t)
        _close(yt, yj)
        for step in range(3):
            x1 = _normal(rng, batch, 1, jc.d_model)
            qp = np.full((batch, 1), s + step, np.int32)
            ctx_j = JB.BlockCtx(mode="decode", q_pos=jnp.asarray(qp),
                                cache=cj)
            ctx_t = TB.BlockCtx(mode="decode", q_pos=_t(qp), cache=ct)
            yj, cj, _ = JB.apply_block(jc, sj, layers_j[li],
                                       jnp.asarray(x1), ctx_j)
            yt, ct, _ = TB.apply_block(tc, sig, lp, _t(x1), ctx_t)
            _close(yt, yj)
        for key in cj:
            _close(ct[key], cj[key])


@pytest.mark.parametrize("impl", ["dense", "chunked", "cuda"])
def test_mla_prefill_attention_routes(deepseek, impl):
    """MLA's prefill attention (K 24 and V 16 wide on one KV head, the
    explicit scale) on each route against the reference's ``chunked``;
    ``cuda`` is the flash kernel's wrapper (its plain version on the
    CPU), which gives V a width of its own."""
    jc, tc, jp, tp = deepseek
    li, lp = _layer(tc, tp, MLP_DENSE)
    lj = JM.unstack_params(jp, jc)["layers_unstacked"][li]
    rng = np.random.default_rng(3)
    s = 13
    h = _normal(rng, 1, s, jc.d_model)
    pos = _pos(1, s)
    ctx_j = JB.BlockCtx(mode="prefill", q_pos=jnp.asarray(pos),
                        k_pos=jnp.asarray(pos))
    q, k, v, scale = JB._project_mla(jc, lj, jnp.asarray(h), ctx_j)
    sig = TB.LayerSig(ATTN_MLA, 0, MLP_DENSE)
    want = JA.chunked_attention(q, k, v, ctx_j.q_pos, ctx_j.k_pos,
                                scale=scale)
    got = TB._full_attention(
        tc, sig, _t(q), _t(k), _t(v),
        TB.BlockCtx(mode="prefill", q_pos=_t(pos), k_pos=_t(pos),
                    attn_impl=impl), scale=scale)
    assert got.shape == (1, s, tc.n_heads, tc.mla.kv_lora_rank)
    _close(got, want)


def test_mtp_hidden_matches_reference(deepseek):
    """The MTP head over the model's final hidden states (the next
    token's embedding, the projection, one MLA block with a dense MLP)."""
    jc, tc, jp, tp = deepseek
    tok = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 24))
    h_j, _ = JM.forward(jp, jnp.asarray(tok), jc, J_PLAN)
    h_t, _ = TM.forward(tp, _t(tok), tc, PLAN)
    _close(h_t, h_j, E2E)
    want = JM.mtp_hidden(jp, h_j, jnp.asarray(tok), jc, J_PLAN)
    got = TM.mtp_hidden(tp, _t(np.asarray(h_j)), _t(tok), tc, PLAN)
    assert got.shape == (2, 23, jc.d_model)
    _close(got, want, E2E)


def test_forward_and_mtp_on_the_cuda_route_match_dense(deepseek):
    """The chip phase's check at smoke size: ``forward`` then
    ``mtp_hidden`` with ``attn_impl="cuda"`` (the flash wrapper; its
    plain version here) equal the same two calls on ``"dense"``."""
    _, tc, _, tp = deepseek
    tok = _t(np.random.default_rng(5).integers(0, tc.vocab_size, (1, 40)))
    out = {}
    for impl in ("cuda", "dense"):
        plan = ExecutionPlan(remat="none", attn_impl=impl,
                             compute_dtype="float32")
        h, _ = TM.forward(tp, tok, tc, plan)
        out[impl] = (h, TM.mtp_hidden(tp, h, tok, tc, plan))
    _close(out["cuda"][0], out["dense"][0], E2E)
    _close(out["cuda"][1], out["dense"][1], E2E)
