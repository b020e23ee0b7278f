"""Port parity: the attention kernels' wrappers and plain versions against
the JAX package's Pallas kernels (interpret mode on the CPU).

On the CPU the port's kernel wrappers (``paged_attention_fwd``,
``paged_attention_pool_fwd``, ``flash_attention_fwd`` and the model-layout
``flash_attention``) run their plain versions; the CUDA kernels behind the
same wrappers are held against those plain versions on the card by the
``gpu``-marked tests/test_torch_kernels_gpu.py. The geometries are those of
tests/test_kernels.py and tests/test_serving.py: ragged lengths, sliding
windows, logit caps, holes past and below the length, a lane with no live
page, GQA, MQA and MHA, and odd sequence lengths for flash. Tolerance:
atol 1e-5, rtol 1e-5 (fp32; the reference accumulates page by page or
block by block, the plain versions in one softmax).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as JFO  # noqa: E402
from repro.kernels.flash_attention.kernel import \
    flash_attention_fwd as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as j_attention_ref  # noqa: E402
from repro.kernels.paged_attention.kernel import (  # noqa: E402
    paged_attention_fwd as j_paged, paged_attention_pool_fwd as j_paged_pool)
from repro_torch.kernels import flash_attention as TF  # noqa: E402
from repro_torch.kernels import paged_attention as TP  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(jax.device_get(b)),
                               **TOL)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _paged_inputs(rng, b, h, kv, d, page, p_max, e, lengths, n_planes=0):
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    shape = (e, page, n_planes, kv, d) if n_planes else (e, page, kv, d)
    pools = [rng.standard_normal(shape).astype(np.float32)
             for _ in range(1 if n_planes else 2)]
    table = rng.permutation(e - 1)[:b * p_max].reshape(b, p_max) + 1
    for i in range(b):                       # holes past the length
        table[i, -(-int(lengths[i]) // page):] = -1
    return q, pools, table.astype(np.int32), np.asarray(lengths, np.int32)


@pytest.mark.parametrize("b,h,kv,d,page,p_max,window,cap", [
    (4, 4, 2, 8, 4, 5, 0, 0.0), (4, 4, 2, 8, 4, 5, 3, 5.0),
    (2, 4, 2, 64, 8, 6, 0, 0.0), (3, 8, 4, 128, 16, 4, 24, 50.0),
    (2, 4, 1, 64, 8, 5, 0, 30.0), (1, 16, 16, 64, 32, 3, 0, 0.0)])
def test_paged_attention_matches_pallas(b, h, kv, d, page, p_max, window,
                                        cap):
    rng = np.random.default_rng(b * 100 + d)
    e = b * p_max + 3
    lengths = rng.integers(1, p_max * page + 1, b)
    lengths[0] = p_max * page                 # a full row
    if b > 2:
        lengths[1] = 0                        # no live page: zeros
    q, (pk, pv), table, lengths = _paged_inputs(rng, b, h, kv, d, page,
                                                p_max, e, lengths)
    if p_max > 2:
        table[0, 1] = -1                      # a hole BELOW the length
    scale = 1.0 / np.sqrt(d)
    calls = TP.PLAIN_CALLS["paged_attention"]
    got = TP.paged_attention_fwd(_t(q), _t(pk), _t(pv), _t(table),
                                 _t(lengths), window=window, logit_cap=cap,
                                 scale=scale)
    assert TP.PLAIN_CALLS["paged_attention"] == calls + 1
    want = j_paged(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                   jnp.asarray(table), jnp.asarray(lengths), window=window,
                   logit_cap=cap, scale=scale, interpret=True)
    _close(got, want)
    if b > 2:
        assert not got[1].any()
    ref = TP.paged_attention_ref(_t(q), _t(pk), _t(pv), _t(table),
                                 _t(lengths), window=window, logit_cap=cap)
    np.testing.assert_array_equal(
        ref, TP.paged_attention(_t(q), _t(pk), _t(pv), _t(table),
                                _t(lengths), window=window, logit_cap=cap))


@pytest.mark.parametrize("kp,vp,window,cap,scale", [
    (0, 1, 0, 0.0, None), (2, 3, 0, 0.0, None), (0, 3, 3, 5.0, 0.25),
    (4, 5, 6, 50.0, 0.3)])
def test_paged_attention_pool_matches_pallas(kp, vp, window, cap, scale):
    """The zero-copy entry on the geometry of tests/test_serving.py: two
    planes of one engine pool, ragged lengths, a hole below a length; an
    explicit scale as the serving engine passes for padded head dims."""
    rng = np.random.default_rng(kp * 10 + vp)
    b, h, kv, d, page, p_max, e = 4, 4, 2, 8, 4, 5, 24
    q, (pool,), table, lengths = _paged_inputs(
        rng, b, h, kv, d, page, p_max, e, [1, 7, 13, 20], n_planes=6)
    table[3, 1] = -1
    got = TP.paged_attention_pool_fwd(_t(q), _t(pool), _t(table),
                                      _t(lengths), k_plane=kp, v_plane=vp,
                                      window=window, logit_cap=cap,
                                      scale=scale)
    want = j_paged_pool(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(table),
                        jnp.asarray(lengths), k_plane=kp, v_plane=vp,
                        window=window, logit_cap=cap, scale=scale,
                        interpret=True)
    _close(got, want)
    # the plane view is the split-pool function on two planes
    split = TP.paged_attention_ref(_t(q), _t(pool[:, :, kp]),
                                   _t(pool[:, :, vp]), _t(table), _t(lengths),
                                   window=window, logit_cap=cap, scale=scale)
    np.testing.assert_allclose(got, split, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("b,s,h,kv,hd,win,cap", [
    (2, 256, 4, 2, 64, 0, 0.0),
    (1, 512, 8, 2, 128, 128, 50.0),
    (2, 128, 4, 4, 64, 0, 30.0),
    (1, 384, 6, 1, 64, 96, 0.0),      # 384 = 3*128, MQA
    (1, 97, 4, 2, 16, 0, 50.0),       # odd: the reference's block halves to 1
    (2, 45, 2, 1, 32, 8, 0.0),        # odd, windowed
])
def test_flash_attention_matches_pallas(b, s, h, kv, hd, win, cap):
    rng = np.random.default_rng(s + hd)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    calls = TF.PLAIN_CALLS["flash_attention"]
    got = TF.flash_attention(_t(q), _t(k), _t(v), window=win, logit_cap=cap)
    assert TF.PLAIN_CALLS["flash_attention"] == calls + 1
    want = JFO.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               window=win, logit_cap=cap)
    _close(got, want)
    _close(TF.flash_attention_reference(_t(q), _t(k), _t(v), window=win,
                                        logit_cap=cap),
           JFO.flash_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), window=win,
                                         logit_cap=cap))


@pytest.mark.parametrize("sq,sk,causal,window", [
    (16, 16, True, 0), (8, 24, True, 0), (8, 24, True, 5), (12, 12, False, 0),
    (24, 24, False, 7)])
def test_flash_fwd_and_attention_ref_match_pallas(sq, sk, causal, window):
    """The (B,H,S,hd) entry: suffix alignment (Sq < Sk), no causal mask,
    windows; the plain ``attention_ref`` against the reference's."""
    rng = np.random.default_rng(sq * 31 + sk)
    b, h, kv, d = 2, 4, 2, 16
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, sk, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, logit_cap=20.0)
    got = TF.flash_attention_fwd(_t(q), _t(k), _t(v), **kw)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   interpret=True, **kw)
    _close(got, want)
    _close(TF.attention_ref(_t(q), _t(k), _t(v), **kw),
           j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           **kw))


def test_wrappers_check_their_inputs():
    q = torch.zeros((2, 4, 8))
    pool = torch.zeros((5, 4, 2, 8))
    table = torch.zeros((2, 3), dtype=torch.int32)
    lengths = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(TypeError):
        TP.paged_attention_fwd(q, pool, pool, table.long(), lengths)
    with pytest.raises(ValueError, match="contiguous"):
        TP.paged_attention_fwd(q, pool.transpose(0, 1).contiguous()
                               .transpose(0, 1), pool, table, lengths)
    with pytest.raises(ValueError, match="group"):
        TP.paged_attention_fwd(torch.zeros((2, 3, 8)), pool, pool, table,
                               lengths)
    with pytest.raises(ValueError, match="planes"):
        TP.paged_attention_pool_fwd(q, torch.zeros((5, 4, 2, 2, 8)), table,
                                    lengths, k_plane=0, v_plane=2)
    x = torch.zeros((1, 2, 6, 8))
    with pytest.raises(TypeError):
        TF.flash_attention_fwd(x.double(), x, x)
    with pytest.raises(ValueError, match="contiguous"):
        TF.flash_attention_fwd(x.transpose(2, 3).contiguous().transpose(2, 3),
                               x, x)
