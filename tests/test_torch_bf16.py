"""Port parity at bfloat16: the attention kernels' bf16 form, ``forward``
and zero-copy serving on a bf16 plan.

The reference's Pallas kernels take any input dtype, compute in fp32 and
write the output in q's dtype; its kernel sweeps test both at bf16
(``tests/test_kernels.py``, within ``_tol(bfloat16)``: rtol and atol
2e-2). The same inputs, made with numpy from a seed and rounded to bf16,
go through the reference's kernels (interpret mode) and the port's
wrappers (their plain versions on the CPU):

- the bf16 cases of ``test_flash_attention_sweep`` and
  ``test_paged_attention_sweep``, the same four geometries each, within
  the reference's own bf16 tolerance; the outputs bf16 in both packages;
- the pool form with a bf16 q over an fp32 engine pool (zero-copy
  serving's mix) against ``paged_attention_pool_fwd``, and the striped
  read's kernel route on bf16 caches against its plain route;
- the wrappers refuse fp64 and mixed dtypes other than the pool forms'
  (fp16, a form of its own since the fp16 slice, is held in
  ``tests/test_torch_fp16.py``).

``forward`` at bf16 with ``attn_impl="cuda"`` against the reference's
``attn_impl="pallas"`` (gemma2-2b, granite-3-8b, hymba-1.5b at smoke
widths): both packages round in other places, so the port is held to the
reference's fp32 logits (``attn_impl="chunked"``) no further than 1.5x
the reference's own bf16 distance to them (RATIO).

Zero-copy serving (``kv_backend="fused"``) on a bf16 plan, lock step with
the reference's ``attn_impl="pallas"`` bf16 engine and its fp32 engine,
``record_logits`` on: while a request's three token streams agree, its
logits are compared, and over all compared steps the port's largest
distance to the fp32 logits stays within RATIO of the reference bf16
engine's. Where the port's token differs from the reference bf16
engine's, that step's top-2 margin in the reference must be a near tie
(under twice the reference's largest bf16 distance), and the request's
later steps are not compared.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.configs.base import ExecutionPlan as JPlan  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as j_flash)
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention as j_paged)
from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention_pool as j_paged_pool)
from repro.models import model as JM  # noqa: E402
from repro.models.layers import lm_logits as j_logits  # noqa: E402
from repro.serving import GenRequest as JGen  # noqa: E402
from repro.serving import ServeEngine as JServe  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.configs.base import ExecutionPlan  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as t_flash)
from repro_torch.kernels.paged_attention import kernel as PK  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import lm_logits as t_logits  # noqa: E402
from repro_torch.serving import GenRequest, ServeEngine  # noqa: E402

BF16_TOL = dict(rtol=2e-2, atol=2e-2)        # the reference's _tol(bf16)
RATIO = 1.5


def _bf16(rng, *shape):
    """Seeded normal values rounded to bf16, as exact fp32 numpy."""
    x = rng.standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def _pair(x):
    """The same bf16 values in both packages."""
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the kernels' bf16 form
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,h,kv,hd,win,cap", [
    (2, 256, 4, 2, 64, 0, 0.0),
    (1, 512, 8, 2, 128, 128, 50.0),
    (2, 128, 4, 4, 64, 0, 30.0),
    (1, 384, 6, 1, 64, 96, 0.0),
])
def test_flash_attention_bf16_sweep(b, s, h, kv, hd, win, cap):
    rng = np.random.default_rng(s + hd)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_bf16(rng, b, s, n, hd))
                                    for n in (h, kv, kv))
    want = j_flash(jq, jk, jv, window=win, logit_cap=cap)
    FK.reset_counts()
    got = t_flash(tq, tk, tv, window=win, logit_cap=cap)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert FK.PLAIN_CALLS["flash_attention"] == 1
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def _paged_inputs(rng, b, h, kv, hd, page, p, n_planes=0):
    e = b * p + 3
    pools = [_bf16(rng, e, page, n_planes, kv, hd) if n_planes
             else _bf16(rng, e, page, kv, hd)
             for _ in range(1 if n_planes else 2)]
    bt = rng.permutation(e)[:b * p].reshape(b, p).astype(np.int32)
    lengths = np.asarray([(p * page) - (i * 3 + 1) % (p * page - 1)
                          for i in range(b)], np.int32)
    return _bf16(rng, b, h, hd), pools, bt, lengths


@pytest.mark.parametrize("b,h,kv,hd,page,p,win,cap", [
    (2, 4, 2, 64, 8, 6, 0, 0.0),
    (3, 8, 4, 128, 16, 4, 24, 50.0),
    (2, 4, 1, 64, 8, 5, 0, 30.0),
    (1, 16, 16, 64, 32, 3, 0, 0.0),
])
def test_paged_attention_bf16_sweep(b, h, kv, hd, page, p, win, cap):
    rng = np.random.default_rng(b * 100 + hd + p)
    q, (pk, pv), bt, lengths = _paged_inputs(rng, b, h, kv, hd, page, p)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q), _pair(pk), _pair(pv)
    want = j_paged(jq, jk, jv, jnp.asarray(bt), jnp.asarray(lengths),
                   window=win, logit_cap=cap)
    got = PK.paged_attention_fwd(tq, tk, tv, torch.from_numpy(bt),
                                 torch.from_numpy(lengths), window=win,
                                 logit_cap=cap)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("win,cap", [(0, 0.0), (24, 50.0)])
def test_paged_pool_bf16_q_over_fp32_pool(win, cap):
    """Zero-copy serving's mix: q in the plan's bf16, the engine pool
    fp32; the output bf16 in both packages."""
    rng = np.random.default_rng(7 + win)
    b, h, kv, hd, page, p = 3, 8, 4, 64, 16, 4
    q, (pool,), bt, lengths = _paged_inputs(rng, b, h, kv, hd, page, p,
                                            n_planes=6)
    pool = pool + _bf16(rng, *pool.shape) * 1e-3     # not bf16 values
    jq, tq = _pair(q)
    kw = dict(k_plane=2, v_plane=5, window=win, logit_cap=cap)
    want = j_paged_pool(jq, jnp.asarray(pool), jnp.asarray(bt),
                        jnp.asarray(lengths), **kw)
    PK.reset_counts()
    got = PK.paged_attention_pool_fwd(tq, torch.from_numpy(pool),
                                      torch.from_numpy(bt),
                                      torch.from_numpy(lengths), **kw)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert PK.PLAIN_CALLS["paged_attention"] == 1
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("stripe_slice,window", [(True, 0), (False, 40)])
def test_striped_kernel_route_on_bf16_caches(stripe_slice, window):
    """A bf16 plan's striped decode read: four stripes' partials through
    the paged entry (``_kernel_partial``, q and caches bf16, the output
    bf16 and the log-sum-exp fp32) merged as the striped decode merges
    them, against the plain unstriped read of the same bf16 values
    (BF16_TOL)."""
    from repro_torch.distributed.collectives import _kernel_partial
    from repro_torch.models import attention as attn
    rng = np.random.default_rng(11)
    b, h, kv, d, page, p_max, stride = 4, 8, 4, 64, 8, 8, 4
    pools = [torch.from_numpy(_bf16(rng, b * p_max, page, kv, d)).to(
        torch.bfloat16) for _ in range(2)]
    table = torch.arange(b * p_max, dtype=torch.int32).reshape(b, p_max)
    q = torch.from_numpy(_bf16(rng, b, 1, h, d)).to(torch.bfloat16)
    q_pos = torch.tensor([[5], [20], [33], [63]], dtype=torch.int32)
    parts = [_kernel_partial(q, *pools, table, q_pos, stride, rank,
                             stripe_slice, window=window, logit_cap=50.0,
                             scale=None) for rank in range(stride)]
    assert parts[0][0].dtype == torch.bfloat16
    assert parts[0][1].dtype == torch.float32
    got = attn.merge_partials(*(torch.stack([p[i] for p in parts])
                                for i in range(3)))
    want = attn.merge_partials(*(t[None] for t in attn.paged_decode_attention(
        q, *pools, table, q_pos, window=window, logit_cap=50.0)))
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_wrappers_refuse_other_dtypes():
    """fp64 raises, and so do mixed dtypes other than the pool forms' 16-bit
    q over an fp32 pool (bf16 with fp16 among them): no input is cast to
    reach a form."""
    bf = torch.bfloat16
    q = torch.zeros((1, 2, 8, 16), dtype=bf)
    for args in ((q.double(),) * 3, (q, q.float(), q), (q, q, q.float()),
                 (q.float(), q, q), (q, q.half(), q), (q.half(), q, q)):
        with pytest.raises(TypeError):
            FK.flash_attention_fwd(*args)
    qd = torch.zeros((1, 2, 16), dtype=bf)
    pool = torch.zeros((3, 4, 2, 16), dtype=bf)
    table = torch.zeros((1, 2), dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    for qq, pk_, pv_ in ((qd.double(), pool.double(), pool.double()),
                         (qd, pool.float(), pool.float()),
                         (qd, pool, pool.float()),
                         (qd.float(), pool, pool),
                         (qd, pool.half(), pool.half()),
                         (qd.half(), pool, pool)):
        for fn in (PK.paged_attention_fwd, PK.paged_attention_lse_fwd):
            with pytest.raises(TypeError):
                fn(qq, pk_, pv_, table, ln)
    for qq, pl in ((qd.float(), pool[:, :, None]),
                   (qd, pool[:, :, None].half()),
                   (qd.half(), pool[:, :, None])):
        with pytest.raises(TypeError):
            PK.paged_attention_pool_fwd(qq, pl, table, ln, k_plane=0,
                                        v_plane=0)


# ---------------------------------------------------------------------------
# the model at bf16
# ---------------------------------------------------------------------------
def _models(name):
    jc, tc = jcfgs.smoke_config(name), tcfgs.smoke_config(name)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(tc, jax.device_get(jp), "cpu")


@pytest.mark.parametrize("name", ["gemma2-2b", "granite-3-8b",
                                  "hymba-1.5b"])
def test_forward_bf16_matches_reference(name):
    jc, tc, jp, tp = _models(name)
    tok = np.random.default_rng(0).integers(0, jc.vocab_size,
                                            (2, 24)).astype(np.int32)

    def ref(dtype, impl):
        plan = JPlan(remat="none", attn_impl=impl, compute_dtype=dtype)
        h, _ = JM.forward(jp, jnp.asarray(tok), jc, plan)
        return _np(j_logits(jp["embed"], h, jc))

    FK.reset_counts()
    plan = ExecutionPlan(remat="none", attn_impl="cuda",
                         compute_dtype="bfloat16")
    h, _ = TM.forward(tp, torch.from_numpy(tok).long(), tc, plan)
    got = _np(t_logits(tp["embed"], h, tc))
    assert FK.PLAIN_CALLS["flash_attention"] > 0
    fp32, ref_bf16 = ref("float32", "chunked"), ref("bfloat16", "pallas")
    d_ref = float(np.abs(ref_bf16 - fp32).max())
    d_port = float(np.abs(got - fp32).max())
    print(f"{name}: port bf16 - reference fp32 {d_port:.4g}, reference "
          f"bf16 - fp32 {d_ref:.4g}, port - reference bf16 "
          f"{float(np.abs(got - ref_bf16).max()):.4g}")
    assert 0.0 < d_ref and d_port <= RATIO * d_ref


def _margin(logits):
    top = np.sort(np.asarray(logits, np.float32))[-2:]
    return float(top[1] - top[0])


def test_zero_copy_serving_bf16_matches_reference():
    """Lock step of the port's bf16 zero-copy engine (``attn_impl="cuda"``:
    flash in prefill, the paged pool form with bf16 q over the fp32
    engine pool in decode; their plain versions here) with the
    reference's ``pallas`` bf16 engine and its fp32 engine (module
    note)."""
    jc, tc, jp, tp = _models("gemma2-2b")
    kw = dict(n_slots=2, max_len=64, record_logits=True)
    bf = dict(remat="none", compute_dtype="bfloat16")
    jb = JServe(jc, jp, plan=JPlan(attn_impl="pallas", **bf), **kw)
    j32 = JServe(jc, jp, plan=JPlan(remat="none", attn_impl="chunked",
                                    compute_dtype="float32"), **kw)
    te = ServeEngine(tc, tp, plan=ExecutionPlan(attn_impl="cuda", **bf),
                     device="cpu", **kw)
    rng = np.random.default_rng(1)
    for rid in range(3):
        pr = rng.integers(0, jc.vocab_size, int(rng.integers(5, 20)))
        for eng, gen in ((jb, JGen), (j32, JGen), (te, GenRequest)):
            eng.submit(gen(req_id=rid, prompt=pr.astype(np.int32).copy(),
                           max_new=8))
    PK.reset_counts()
    FK.reset_counts()
    steps = {}              # (rid, t) -> (port, ref bf16, ref fp32) logits
    tokens = {rid: ([], [], []) for rid in range(3)}
    for _ in range(64):
        outs = [eng.step() for eng in (te, jb, j32)]
        if not any(outs):
            break
        for i, (eng, out) in enumerate(zip((te, jb, j32), outs)):
            for rid, tok in out:
                t = len(tokens[rid][i])
                tokens[rid][i].append(tok)
                steps.setdefault((rid, t), [None] * 3)[i] = np.asarray(
                    eng.live[rid].logit_trace[-1], np.float32)
    assert PK.PLAIN_CALLS["paged_attention"] > 0
    assert FK.PLAIN_CALLS["flash_attention"] > 0
    d_port = d_ref = 0.0
    compared, diverged = 0, {}
    for rid, (tt, jt, ct) in tokens.items():
        assert len(tt) == len(jt) == len(ct) == 8
        for t in range(8):
            port, ref_bf16, fp32 = steps[(rid, t)]
            d_port = max(d_port, float(np.abs(port - fp32).max()))
            d_ref = max(d_ref, float(np.abs(ref_bf16 - fp32).max()))
            compared += 1
            if tt[t] != jt[t]:
                diverged[rid] = (t, _margin(ref_bf16))
            if tt[t] != jt[t] or jt[t] != ct[t]:
                break
    print(f"steps compared {compared}, port - fp32 {d_port:.4g}, "
          f"reference bf16 - fp32 {d_ref:.4g}, near ties {diverged}")
    assert compared >= 12 and 0.0 < d_ref
    assert d_port <= RATIO * d_ref
    for rid, (t, margin) in diverged.items():
        assert margin < 2 * d_ref, (rid, t, margin)
