"""Port parity at float16: the attention kernels' and the RWKV scan's fp16
forms, ``forward`` and serving on a float16 plan.

The reference's Pallas kernels take fp16 as they take any dtype: they
compute in fp32 and write the output in q's dtype (the scan's y in r's,
its state fp32); its kernel sweeps hold a non-bf16 dtype within
``_tol`` (``tests/test_kernels.py``: rtol and atol 2e-3, TOL here). The
same inputs, made with numpy from a seed and rounded to fp16, go through
the reference's kernels (interpret mode) and the port's wrappers (their
plain versions on the CPU):

- flash at ``tests/test_torch_bf16.py``'s four geometries, and at the
  shapes of each of its fp16 instantiations on the card: d = dv of 64
  and 128 (the wgmma form), 72 (the mma.sync form) and 576 (the wide
  one);
- paged at its four geometries, its packed instantiation's (a wide head
  dim and a GQA group of 16: K 576, V 512), the pool form with fp16 q over
  an fp32 engine pool (``float16_q``, zero-copy serving's mix) and the
  stripe entry ``paged_attention_lse_fwd`` (its log-sum-exp fp32, against
  one computed in numpy from the same fp16 values);
- ``rwkv6_scan_fwd`` at two shapes (the decode and the chunked
  schedule's), u fp32 and fp16, y fp16 and the state fp32.

``forward`` at fp16 with ``attn_impl="cuda"`` against the reference's
``attn_impl="pallas"`` (gemma2-2b, granite-3-8b at smoke widths): the
port's largest distance to the reference's fp32 logits stays within
RATIO (1.5) of the reference's own fp16 distance to them.

Serving on a float16 plan (``param_dtype`` and ``compute_dtype``
float16; the port raised ``TypeError`` at the first prompt before its
wrappers took fp16): zero-copy (``kv_backend="fused"``) gemma2-2b in lock
step with the reference's ``pallas`` fp16 engine and its fp32 engine, and
the copy-based baseline (``kv_backend="host"``, its K/V pools fp16) forked
in lock step with the reference's fp16 and fp32 baselines on granite-3-8b
(the reference's baseline mishandles gemma2's window rings, ROADMAP queue
3, so its lock-step twins take granite, as
``tests/test_torch_dtype_forms.py`` does); the yardstick and the near-tie
rule of ``tests/test_torch_bf16.py`` and ``tests/test_torch_dtype_forms.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.configs.base import ExecutionPlan as JPlan  # noqa: E402
from repro.core import dbs as JD  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as j_flash)
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention as j_paged)
from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention_pool as j_paged_pool)
from repro.kernels.rwkv6_scan import rwkv6_scan as j_scan  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import lm_logits as j_logits  # noqa: E402
from repro.serving import GenRequest as JGen  # noqa: E402
from repro.serving import ServeEngine as JServe  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.configs.base import ExecutionPlan  # noqa: E402
from repro_torch.core import dbs as TD  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.dbs import copy_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as PK  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as SK  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import lm_logits as t_logits  # noqa: E402
from repro_torch.serving import GenRequest, ServeEngine  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)             # the reference's _tol(fp16)
RATIO = 1.5
MARGIN = 0.05        # tests/test_torch_dtype_forms.py's near tie
F16 = dict(remat="none", compute_dtype="float16", param_dtype="float16")


def _f16(rng, *shape, scale=1.0):
    """Seeded normal values rounded to fp16, as exact fp32 numpy."""
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return x.astype(np.float16).astype(np.float32)


def _pair(x):
    """The same fp16 values in both packages."""
    return jnp.asarray(x, jnp.float16), torch.from_numpy(x).half()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the kernels' fp16 forms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,h,kv,hd,win,cap,form", [
    (2, 256, 4, 2, 64, 0, 0.0, "f16_wgmma"),       # test_torch_bf16's four
    (1, 512, 8, 2, 128, 128, 50.0, "f16_wgmma"),
    (2, 128, 4, 4, 64, 0, 30.0, "f16_wgmma"),
    (1, 384, 6, 1, 64, 96, 0.0, "f16_wgmma"),
    (1, 96, 4, 2, 72, 0, 50.0, "f16_mma"),         # the mma.sync form
    (1, 64, 16, 1, 576, 0, 0.0, "f16_mma"),        # the wide instantiation
])
def test_flash_attention_fp16_matches_reference(b, s, h, kv, hd, win, cap,
                                                form):
    rng = np.random.default_rng(s + hd)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_f16(rng, b, s, n, hd))
                                    for n in (h, kv, kv))
    scale = 1.0 / math.sqrt(192.0) if hd == 576 else None
    kw = dict(window=win, logit_cap=cap, scale=scale)
    want = j_flash(jq, jk, jv, **kw)
    FK.reset_counts()
    got = FK.flash_attention_fwd(tq.transpose(1, 2), tk.transpose(1, 2),
                                 tv.transpose(1, 2), **kw).transpose(1, 2)
    assert want.dtype == jnp.float16 and got.dtype == torch.float16
    assert FK.PLAIN_CALLS["flash_attention"] == 1
    assert FK.flash_form(hd, hd, torch.float16, (8,), (16,)) == form
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _paged_inputs(rng, b, h, kv, hd, page, p, n_planes=0, dv=None):
    e = b * p + 3
    dv = hd if dv is None else dv
    pools = ([_f16(rng, e, page, n_planes, kv, hd)] if n_planes
             else [_f16(rng, e, page, kv, hd), _f16(rng, e, page, kv, dv)])
    bt = rng.permutation(e)[:b * p].reshape(b, p).astype(np.int32)
    lengths = np.asarray([(p * page) - (i * 3 + 1) % (p * page - 1)
                          for i in range(b)], np.int32)
    return _f16(rng, b, h, hd), pools, bt, lengths


def _lse_np(q, pk, bt, lengths, scale, window, cap):
    """Each row's log-sum-exp of its live logits, in float64 numpy from the
    same fp16 values: (B, H)."""
    b, h, d = q.shape
    page, kv = pk.shape[1], pk.shape[2]
    out = np.empty((b, h))
    for i in range(b):
        keys = pk[bt[i]].reshape(-1, kv, d)[:lengths[i]].astype(np.float64)
        pos = np.arange(lengths[i])
        live = pos > lengths[i] - 1 - window if window else pos >= 0
        for j in range(h):
            x = keys[:, j // (h // kv)] @ q[i, j].astype(np.float64) * scale
            if cap:
                x = cap * np.tanh(x / cap)
            x = x[live]
            m = x.max()
            out[i, j] = m + np.log(np.exp(x - m).sum())
    return out


@pytest.mark.parametrize("b,h,kv,hd,dv,page,p,win,cap,form", [
    (2, 4, 2, 64, 64, 8, 6, 0, 0.0, "lanes"),     # test_torch_bf16's four
    (3, 8, 4, 128, 128, 16, 4, 24, 50.0, "lanes"),
    (2, 4, 1, 64, 64, 8, 5, 0, 30.0, "lanes"),
    (1, 16, 16, 64, 64, 32, 3, 0, 0.0, "lanes"),
    (2, 16, 1, 576, 512, 8, 4, 0, 0.0, "packed"),  # MLA's absorbed latent
])
def test_paged_attention_fp16_matches_reference(b, h, kv, hd, dv, page, p,
                                                win, cap, form):
    """The split pools in fp16 (the ``float16`` form) and the stripe entry
    on them: the output fp16 in both packages, the log-sum-exp fp32."""
    rng = np.random.default_rng(b * 100 + hd + p)
    q, (pk, pv), bt, lengths = _paged_inputs(rng, b, h, kv, hd, page, p,
                                             dv=dv)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q), _pair(pk), _pair(pv)
    scale = 1.0 / math.sqrt(192.0) if hd == 576 else 1.0 / math.sqrt(hd)
    kw = dict(window=win, logit_cap=cap, scale=scale)
    want = j_paged(jq, jk, jv, jnp.asarray(bt), jnp.asarray(lengths), **kw)
    tbt, tln = torch.from_numpy(bt), torch.from_numpy(lengths)
    PK.reset_counts()
    got = PK.paged_attention_fwd(tq, tk, tv, tbt, tln, **kw)
    out, lse = PK.paged_attention_lse_fwd(tq, tk, tv, tbt, tln, **kw)
    assert PK.PLAIN_CALLS["paged_attention"] == 2
    assert PK.paged_form(h // kv, hd, dv) == form
    assert want.dtype == jnp.float16 and got.dtype == torch.float16
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    for o in (got, out):
        np.testing.assert_allclose(_np(o), _np(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), _lse_np(q, pk, bt, lengths,
                                                     scale, win, cap),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("win,cap", [(0, 0.0), (24, 50.0)])
def test_paged_pool_fp16_q_over_fp32_pool(win, cap):
    """Zero-copy serving's mix on an fp16 plan (``float16_q``): q fp16,
    the engine pool fp32; the output fp16 in both packages."""
    rng = np.random.default_rng(9 + win)
    b, h, kv, hd, page, p = 3, 8, 4, 64, 16, 4
    q, (pool,), bt, lengths = _paged_inputs(rng, b, h, kv, hd, page, p,
                                            n_planes=6)
    pool = pool + _f16(rng, *pool.shape) * 1e-3     # not fp16 values
    jq, tq = _pair(q)
    kw = dict(k_plane=2, v_plane=5, window=win, logit_cap=cap)
    want = j_paged_pool(jq, jnp.asarray(pool), jnp.asarray(bt),
                        jnp.asarray(lengths), **kw)
    PK.reset_counts()
    got = PK.paged_attention_pool_fwd(tq, torch.from_numpy(pool),
                                      torch.from_numpy(bt),
                                      torch.from_numpy(lengths), **kw)
    assert want.dtype == jnp.float16 and got.dtype == torch.float16
    assert PK.PLAIN_CALLS["paged_attention"] == 1
    assert PK._form(torch.float16, torch.float32) == "float16_q"
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("b,s,h,hd,chunk", [(8, 1, 3, 64, 64),
                                            (2, 96, 4, 32, 32)])
@pytest.mark.parametrize("u_dtype", ["float32", "float16"])
def test_rwkv6_scan_fp16_matches_reference(b, s, h, hd, chunk, u_dtype):
    """fp16 r, k, v and logw (u fp32 or fp16) in the decode and the
    chunked schedule's shapes: y fp16 and the state fp32 in both
    packages."""
    rng = np.random.default_rng(s + hd)
    r, k, v = (_f16(rng, b, s, h, hd) for _ in range(3))
    logw = -np.exp(_f16(rng, b, s, h, hd, scale=0.5)).astype(
        np.float16).astype(np.float32)
    u = _f16(rng, h, hd, scale=0.1)
    jd = {"float32": jnp.float32, "float16": jnp.float16}[u_dtype]
    jy, js = j_scan(*(jnp.asarray(a, jnp.float16) for a in (r, k, v, logw)),
                    jnp.asarray(u, jd), chunk=chunk)
    assert jy.dtype == jnp.float16 and js.dtype == jnp.float32
    SK.reset_counts()
    ty, ts = SK.rwkv6_scan_fwd(*(torch.from_numpy(a).half()
                                 for a in (r, k, v, logw)),
                               torch.from_numpy(u).to(getattr(torch,
                                                              u_dtype)),
                               chunk=chunk)
    assert ty.dtype == torch.float16 and ts.dtype == torch.float32
    assert SK.PLAIN_CALLS["rwkv6_scan"] == 1
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)


def test_wrappers_refuse_mixed_16_bit_pairs():
    """fp16 is a form of its own, not a cast: fp16 q over bf16 pools, bf16
    q over fp16 pools, fp16 with fp32 K, fp64 and fp16 among bf16 scan
    inputs raise before any dispatch."""
    h16 = torch.zeros((1, 2, 8, 16), dtype=torch.float16)
    for args in ((h16, h16.float(), h16), (h16, h16, h16.bfloat16()),
                 (h16.double(),) * 3):
        with pytest.raises(TypeError):
            FK.flash_attention_fwd(*args)
    qd = torch.zeros((1, 2, 16), dtype=torch.float16)
    pool = torch.zeros((3, 4, 2, 16), dtype=torch.float16)
    table = torch.zeros((1, 2), dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    for qq, pk_ in ((qd, pool.bfloat16()), (qd.bfloat16(), pool),
                    (qd, pool.float())):
        with pytest.raises(TypeError):
            PK.paged_attention_fwd(qq, pk_, pk_, table, ln)
    for qq, pl in ((qd, pool[:, :, None].bfloat16()),
                   (qd.bfloat16(), pool[:, :, None]),
                   (qd.double(), pool[:, :, None].float())):
        with pytest.raises(TypeError):
            PK.paged_attention_pool_fwd(qq, pl, table, ln, k_plane=0,
                                        v_plane=0)
    r = torch.zeros((1, 4, 2, 8), dtype=torch.float16)
    u = torch.zeros((2, 8))
    with pytest.raises(TypeError, match="one dtype"):
        SK.rwkv6_scan_fwd(r, r, r.bfloat16(), r, u)
    with pytest.raises(TypeError, match="u"):
        SK.rwkv6_scan_fwd(r, r, r, r, u.bfloat16())
    with pytest.raises(TypeError, match="u"):
        SK.rwkv6_scan_fwd(*(r.bfloat16(),) * 4, u.half())


# ---------------------------------------------------------------------------
# the model and serving on a float16 plan
# ---------------------------------------------------------------------------
def _models(name):
    jc, tc = jcfgs.smoke_config(name), tcfgs.smoke_config(name)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(tc, jax.device_get(jp), "cpu")


@pytest.mark.parametrize("name", ["gemma2-2b", "granite-3-8b"])
def test_forward_fp16_matches_reference(name):
    jc, tc, jp, tp = _models(name)
    tok = np.random.default_rng(0).integers(0, jc.vocab_size,
                                            (2, 24)).astype(np.int32)

    def ref(dtype, impl):
        plan = JPlan(remat="none", attn_impl=impl, compute_dtype=dtype)
        h, _ = JM.forward(jp, jnp.asarray(tok), jc, plan)
        return _np(j_logits(jp["embed"], h, jc))

    FK.reset_counts()
    plan = ExecutionPlan(remat="none", attn_impl="cuda",
                         compute_dtype="float16")
    h, _ = TM.forward(tp, torch.from_numpy(tok).long(), tc, plan)
    assert h.dtype == torch.float16
    got = _np(t_logits(tp["embed"], h, tc))
    assert FK.PLAIN_CALLS["flash_attention"] > 0
    assert np.isfinite(got).all()
    fp32, ref16 = ref("float32", "chunked"), ref("float16", "pallas")
    d_ref = float(np.abs(ref16 - fp32).max())
    d_port = float(np.abs(got - fp32).max())
    print(f"{name}: port fp16 - reference fp32 {d_port:.4g}, reference "
          f"fp16 - fp32 {d_ref:.4g}")
    assert 0.0 < d_ref and d_port <= RATIO * d_ref


def _margin(logits):
    top = np.sort(np.asarray(logits, np.float32))[-2:]
    return float(top[1] - top[0])


def _lockstep(engines, steps, state, fork_at=None):
    """Step (port, reference fp16, reference fp32) together for ``steps``
    steps (after ``fork_at`` steps, request 0 forks into 1 on each):
    while a request's port and reference fp16 tokens agree its logits are
    measured (while the two references' agree too); a port token that
    differs from the reference fp16 one must come at a near tie of the
    reference (its top-2 margin under ``state["tie"]``), after which the
    request is not compared."""
    te, jb, _j32 = engines
    for i in range(steps):
        if fork_at is not None and i == fork_at:
            kids = [e.fork(0, 1, max_new=5) for e in engines]
            assert all(k is not None for k in kids)
            assert len({(k.slot, k.volume) for k in kids}) == 1
            copy_kernel.reset_counts()
        outs = [e.step() for e in engines]
        if not any(outs):
            break
        for j, out in enumerate(outs):
            for rid, tok in out:
                state["tokens"].setdefault(rid, ([], [], []))[j].append(tok)
        for rid, _ in outs[0]:
            if rid in state["tied"]:
                continue
            port, ref, fp32 = (np.asarray(e.live[rid].logit_trace[-1],
                                          np.float32) for e in engines)
            tt, jt, ft = (t[-1] for t in state["tokens"][rid])
            state["compared"] += 1
            if rid not in state["parted"]:
                state["d_port"] = max(state["d_port"],
                                      float(np.abs(port - fp32).max()))
                state["d_ref"] = max(state["d_ref"],
                                     float(np.abs(ref - fp32).max()))
            if tt != jt:
                assert _margin(ref) < state["tie"], (rid, _margin(ref))
                state["tied"].add(rid)
            if jt != ft:
                state["parted"].add(rid)
        if te.kv_backend == "host":
            assert np.array_equal(te.state.table.numpy(),
                                  np.asarray(jax.device_get(jb.state.table)))
            assert TD.stats(te.state) == JD.stats(jb.state)


@pytest.mark.parametrize("backend,name", [("fused", "gemma2-2b"),
                                          ("host", "granite-3-8b")])
def test_serving_fp16_matches_reference(backend, name):
    """The float16 plan, lock step with the reference's fp16 and fp32
    engines (module note). Zero-copy (gemma2-2b): two requests; its decode
    reads the fp32 engine pool with fp16 q (``float16_q``). The baseline
    (granite-3-8b): volume 0 held in every engine, one request forked
    after 3 steps, one plain ``dbs_copy`` per fp16 pool at the first step
    after the fork, the child's tokens a prefix of the parent's."""
    jc, tc, jp, tp = _models(name)
    kw = dict(n_slots=4, max_len=64, record_logits=True, kv_backend=backend)
    te = ServeEngine(tc, tp, plan=ExecutionPlan(attn_impl="cuda", **F16),
                     device="cpu", **kw)
    jb = JServe(jc, jp, plan=JPlan(
        attn_impl="pallas" if backend == "fused" else "chunked", **F16), **kw)
    j32 = JServe(jc, jp, plan=JPlan(remat="none", attn_impl="chunked",
                                    compute_dtype="float32"), **kw)
    engines = (te, jb, j32)
    rng = np.random.default_rng(1)
    n_req = 2 if backend == "fused" else 1
    if backend == "host":
        assert {e.volumes.create().vid for e in engines} == {0}
        pools = [c[k] for c in te.caches if c is not None and "pool_k" in c
                 for k in ("pool_k", "pool_v")]
        assert pools and all(p.dtype == torch.float16 for p in pools)
    for rid in range(n_req):
        pr = rng.integers(0, jc.vocab_size, int(rng.integers(5, 20)))
        for eng, gen in ((te, GenRequest), (jb, JGen), (j32, JGen)):
            eng.submit(gen(req_id=rid, prompt=pr.astype(np.int32).copy(),
                           max_new=8 if backend == "fused" else 10))
    PK.reset_counts()
    FK.reset_counts()
    state = dict(tokens={}, tied=set(), parted=set(), compared=0,
                 d_port=0.0, d_ref=0.0, tie=MARGIN)
    _lockstep(engines, 15 if backend == "host" else 64, state,
              fork_at=3 if backend == "host" else None)
    assert FK.PLAIN_CALLS["flash_attention"] > 0
    assert PK.PLAIN_CALLS["paged_attention"] > 0 or backend == "host"
    if backend == "host":
        assert copy_kernel.PLAIN_CALLS["dbs_copy"] == len(pools)
        par, chi = te.live[0].out_tokens, te.live[1].out_tokens
        assert len(par) == 10 and len(chi) == 5 and chi == par[:5]
    else:
        assert all(len(t[0]) == 8 for t in state["tokens"].values())
    print(f"{backend}: steps compared {state['compared']}, port - fp32 "
          f"{state['d_port']:.4g}, reference fp16 - fp32 "
          f"{state['d_ref']:.4g}, near ties {state['tied']}")
    assert state["compared"] >= 12 and 0.0 < state["d_ref"]
    assert state["d_port"] <= RATIO * state["d_ref"]
