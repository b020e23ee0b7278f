"""Port parity: the Mamba branch (``models/ssm.py``) and the hybrid block
(``models/blocks.py``, hymba's attention and Mamba heads side by side).

The same inputs, made with numpy from a seed, go through the JAX function
and its port on the CPU; weights cross through ``core/convert.py
params_from_numpy``. Module outputs and states must agree within atol 1e-5
and rtol 1e-5 (fp32; the port's in-chunk scan is a Hillis-Steele scan, the
reference's ``jax.lax.associative_scan`` another tree over the same
terms). The reference keeps the Mamba state as a tuple ``(conv, ssm)``, the
port as a dict ``{"conv", "ssm"}``: the tests convert at that boundary.

Where the reference's chunk rule (``s // chunk`` equal chunks) does not
divide a length, its ``mamba_forward`` raises and the port takes a ragged
last chunk: there the port is held against the reference's two calls, the
whole chunks then the rest from the carried state
(``test_mamba_513_against_split_reference`` pins the raise).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

MOD = dict(atol=1e-5, rtol=1e-5)
STEP = dict(atol=5e-4, rtol=5e-4)   # tests/test_training_math.py's
ARCH = "hymba-1.5b"


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else jax.device_get(x))


def _close(a, b, tol=MOD):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def mamba():
    """(JAX config, port config, JAX Mamba params, port Mamba params)."""
    jc, tc = j_smoke(ARCH), t_smoke(ARCH)
    pj = JS.init_mamba(jax.random.PRNGKey(0), jc)
    return jc, tc, pj, params_from_numpy(tc, jax.device_get(pj), "cpu")


def _state(rng, jc, b, carried):
    """Equal states for both packages: zeros, or random (a carried one)."""
    e, n, k = (jc.ssm.expand * jc.d_model, jc.ssm.state_dim,
               jc.ssm.conv_kernel)
    if not carried:
        conv, ssm = (np.zeros((b, k - 1, e), np.float32),
                     np.zeros((b, e, n), np.float32))
    else:
        conv, ssm = _normal(rng, b, k - 1, e), _normal(rng, b, e, n)
    return (jnp.asarray(conv), jnp.asarray(ssm)), {"conv": _t(conv),
                                                  "ssm": _t(ssm)}


def _check_state(st_t, st_j, tol=MOD):
    _close(st_t["conv"], st_j[0], tol)
    _close(st_t["ssm"], st_j[1], tol)


def _reference_chunks(s, chunk):
    """(whole-chunk prefix, chunk) of the reference's rule; the prefix is
    ``s`` where the rule divides it."""
    n = max(1, s // chunk)
    return n * (s // n), chunk


def test_init_mamba_shapes_match_reference(mamba):
    jc, tc, pj, _ = mamba
    pt = TS.init_mamba(torch.Generator().manual_seed(0), tc)
    assert sorted(pt) == sorted(pj)
    for k in pj:
        assert tuple(pt[k].shape) == tuple(pj[k].shape), k
        assert pt[k].dtype == torch.float32, k
    for k in ("dt_bias", "a_log", "d_skip"):      # deterministic leaves
        _close(pt[k], pj[k], dict(atol=0, rtol=0))
    st_t = TS.mamba_init_state(pt, 3, torch.float32)
    st_j = JS.mamba_init_state(pj, 3, jnp.float32)
    assert [tuple(st_t[k].shape) for k in ("conv", "ssm")] == [
        tuple(a.shape) for a in st_j]


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("chunk", [256, 8])
@pytest.mark.parametrize("s", [13, 300, 512])
def test_mamba_forward_matches_reference(mamba, s, chunk, carried):
    """Output and both states; (300, 8) is a length the reference's rule
    rejects (37 chunks of 8 leave 4 tokens), held against its split."""
    jc, _, pj, pt = mamba
    rng = np.random.default_rng(s * 10 + chunk + carried)
    x = _normal(rng, 2, s, jc.d_model)
    st_j, st_t = _state(rng, jc, 2, carried)
    y_t, new_t = TS.mamba_forward(pt, _t(x), st_t, chunk=chunk)
    whole, _ = _reference_chunks(s, chunk)
    y_j, new_j = JS.mamba_forward(pj, jnp.asarray(x[:, :whole]), st_j,
                                  chunk=chunk)
    if whole < s:
        y2, new_j = JS.mamba_forward(pj, jnp.asarray(x[:, whole:]), new_j,
                                     chunk=chunk)
        y_j = jnp.concatenate([y_j, y2], axis=1)
    _close(y_t, y_j)
    _check_state(new_t, new_j)
    # the carried state is read, not written
    _close(st_t["ssm"], st_j[1], dict(atol=0, rtol=0))


def test_mamba_step_matches_reference(mamba):
    jc, _, pj, pt = mamba
    rng = np.random.default_rng(1)
    st_j, st_t = _state(rng, jc, 3, True)
    for _ in range(4):
        x = _normal(rng, 3, 1, jc.d_model)
        y_t, st_t = TS.mamba_step(pt, _t(x), st_t)
        y_j, st_j = JS.mamba_step(pj, jnp.asarray(x), st_j)
        _close(y_t, y_j)
        _check_state(st_t, st_j)


def test_mamba_chunked_equals_stepwise(mamba):
    """Twin of tests/test_training_math.py's: chunks of 8 against 32 single
    steps, within that test's 5e-4; and both against the reference's."""
    jc, _, pj, pt = mamba
    rng = np.random.default_rng(2)
    x = _normal(rng, 2, 32, jc.d_model)
    y_chunk, st_chunk = TS.mamba_forward(pt, _t(x), chunk=8)
    st = TS.mamba_init_state(pt, 2, torch.float32)
    ys = []
    for t in range(32):
        y, st = TS.mamba_step(pt, _t(x[:, t:t + 1]), st)
        ys.append(y)
    _close(y_chunk, torch.cat(ys, dim=1), STEP)
    _close(st_chunk["ssm"], st["ssm"], STEP)
    y_ref, st_ref = JS.mamba_forward(pj, jnp.asarray(x), chunk=8)
    _close(y_chunk, y_ref)
    _check_state(st_chunk, st_ref)


def test_mamba_513_against_split_reference(mamba):
    """At 513 tokens and chunk 256 the reference's reshape raises (fault 4
    of ROADMAP queue 3's hybrid entry); the port equals the reference's
    ``mamba_forward(x[:, :512])`` then ``mamba_forward(x[:, 512:], state)``.
    """
    jc, _, pj, pt = mamba
    rng = np.random.default_rng(3)
    x = _normal(rng, 1, 513, jc.d_model)
    with pytest.raises(TypeError, match="reshape"):
        JS.mamba_forward(pj, jnp.asarray(x), chunk=256)
    y1, st = JS.mamba_forward(pj, jnp.asarray(x[:, :512]), chunk=256)
    y2, st = JS.mamba_forward(pj, jnp.asarray(x[:, 512:]), st, chunk=256)
    y_t, st_t = TS.mamba_forward(pt, _t(x), chunk=256)
    _close(y_t, jnp.concatenate([y1, y2], axis=1))
    _check_state(st_t, st)


# ---------------------------------------------------------------------------
# the hybrid block
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def hymba():
    jc, tc = j_smoke(ARCH), t_smoke(ARCH)
    jp = j_init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(tc, jax.device_get(jp), "cpu")


def _hybrid_caches(jc, tc, sig, batch, max_len, paged, rng):
    """Equal random caches for both packages, the Mamba state included
    (a tuple in the reference's, a dict in the port's)."""
    jcache = JB.init_layer_cache(jc, JB.LayerSig(*_astuple(sig)), batch,
                                 max_len, paged=paged, dtype=jnp.float32)
    tcache = TB.init_layer_cache(tc, sig, batch, max_len, paged=paged,
                                 dtype=torch.float32)
    assert sorted(jcache) == sorted(tcache)
    out_j, out_t = {}, {}
    for key, arr in jcache.items():
        if key == "mamba":
            conv, ssm = (_normal(rng, *a.shape) for a in arr)
            assert [tuple(tcache[key][k].shape) for k in ("conv", "ssm")] \
                == [conv.shape, ssm.shape]
            out_j[key] = (jnp.asarray(conv), jnp.asarray(ssm))
            out_t[key] = {"conv": _t(conv), "ssm": _t(ssm)}
            continue
        assert tuple(arr.shape) == tuple(tcache[key].shape), key
        if key == "block_table":
            val = np.asarray(JM.default_block_tables(jc, batch, max_len))
        elif key == "ring_pos":
            val = np.full(arr.shape, 2 ** 31 - 1, np.int32)
        else:
            val = _normal(rng, *arr.shape)
        out_j[key], out_t[key] = jnp.asarray(val), _t(val)
    return out_j, out_t


def _astuple(sig):
    return sig.attn, sig.window, sig.mlp


def _check_caches(ct, cj):
    for key in cj:
        if key == "mamba":
            _check_state(ct[key], cj[key])
        else:
            _close(ct[key], cj[key])


@pytest.mark.parametrize("paged", [True, False])
def test_hybrid_block_prefill_then_decode(hymba, paged):
    """hymba's global (paged or dense) and window (ring) hybrid layers: a
    prefill block from a carried Mamba state, then three decode blocks;
    outputs and caches, the Mamba state included, against the reference's
    ``apply_block``."""
    jc, tc, jp, tp = hymba
    rng = np.random.default_rng(4)
    batch, max_len, s = 2, 48, 24         # s > the smoke window (16)
    layers_t = TM.unstack_params(tp, tc)["layers_unstacked"]
    layers_j = JM.unstack_params(jp, jc)["layers_unstacked"]
    sigs = TB.layer_sigs(tc)
    assert {sig.window > 0 for sig in sigs} == {True, False}
    seen = set()
    for li, sig in enumerate(sigs):
        if sig in seen:
            continue
        seen.add(sig)
        jsig = JB.LayerSig(*_astuple(sig))
        cj, ct = _hybrid_caches(jc, tc, sig, batch, max_len, paged, rng)
        x = _normal(rng, batch, s, jc.d_model)
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (batch, s)).copy()
        yj, cj, _ = JB.apply_block(
            jc, jsig, layers_j[li], jnp.asarray(x),
            JB.BlockCtx(mode="prefill", q_pos=jnp.asarray(pos),
                        k_pos=jnp.asarray(pos), cache=cj))
        yt, ct, _ = TB.apply_block(
            tc, sig, layers_t[li], _t(x),
            TB.BlockCtx(mode="prefill", q_pos=_t(pos), k_pos=_t(pos),
                        cache=ct))
        _close(yt, yj)
        _check_caches(ct, cj)
        for step in range(3):
            x1 = _normal(rng, batch, 1, jc.d_model)
            qp = np.full((batch, 1), s + step, np.int32)
            yj, cj, _ = JB.apply_block(
                jc, jsig, layers_j[li], jnp.asarray(x1),
                JB.BlockCtx(mode="decode", q_pos=jnp.asarray(qp), cache=cj))
            yt, ct, _ = TB.apply_block(
                tc, sig, layers_t[li], _t(x1),
                TB.BlockCtx(mode="decode", q_pos=_t(qp), cache=ct))
            _close(yt, yj)
        _check_caches(ct, cj)
