"""Port parity: dropless top-k MoE (``models/layers.py`` ``init_moe``,
``apply_moe``).

The same tokens, made with numpy from a seed, go through the JAX
``apply_moe`` (``jax.lax.ragged_dot`` on the CPU) and the port's on the
CPU; weights cross through ``core/convert.py params_from_numpy``. Output
and aux loss must agree within atol 1e-5 and rtol 1e-5 (fp32), at decode
and prefill token shapes. The port runs every expert on every token with
zero combine weights for the unselected ones (it reads nothing back to
the host) and so sums a token's experts in expert order, the reference
in top-k order; the tolerance covers that.

The grouped form (``form="grouped"``: the reference's sort-and-group,
one product per expert over its tokens, the top-k-order combine) is held
against the reference and against the every-expert form at the same
tolerance, and the rule that picks the form (``moe_form``, on shapes
alone) is checked at the served models' full widths: every-expert at
every decode batch and at granite-moe's prefill, grouped at
deepseek-v3's prefill past 146 tokens.

Configurations: granite-moe's smoke MoE (softmax top-k, gated SiLU, the
Switch aux loss), deepseek-v3's (sigmoid aux-free routing with a nonzero
``router_bias``, a shared expert, aux 0), and each with padded experts
(``n_experts_padded > n_experts``: the router never picks them).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

MOD = dict(atol=1e-5, rtol=1e-5)
CASES = {"granite": ("granite-moe-3b-a800m", 0),
         "granite-padded": ("granite-moe-3b-a800m", 6),
         "deepseek": ("deepseek-v3-671b", 0),
         "deepseek-padded": ("deepseek-v3-671b", 7)}


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else jax.device_get(x))


def _close(a, b, tol=MOD):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _configs(name, padded):
    jc, tc = j_smoke(name), t_smoke(name)
    if padded:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, n_experts_padded=padded))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, n_experts_padded=padded))
    return jc, tc


@pytest.fixture(scope="module", params=list(CASES))
def moe(request):
    """(JAX config, port config, JAX params, port params); aux-free
    routers get a random nonzero bias so that it changes the choice."""
    jc, tc = _configs(*CASES[request.param])
    pj = JL.init_moe(jax.random.PRNGKey(1), jc)
    if "router_bias" in pj:
        rng = np.random.default_rng(9)
        pj["router_bias"] = jnp.asarray(
            rng.standard_normal(pj["router_bias"].shape).astype(np.float32))
    return jc, tc, pj, params_from_numpy(tc, jax.device_get(pj), "cpu")


def _tokens(rng, shape, d):
    return rng.standard_normal(shape + (d,)).astype(np.float32)


def test_init_moe_shapes_match_reference(moe):
    jc, tc, pj, _ = moe
    pt = TL.init_moe(torch.Generator().manual_seed(0), tc)

    def shapes(tree, path=""):
        if isinstance(tree, dict):
            return sorted(x for k, v in tree.items()
                          for x in shapes(v, f"{path}/{k}"))
        return [(path, tuple(tree.shape))]
    assert shapes(pt) == shapes(jax.device_get(pj))
    assert ("shared" in pt) == bool(tc.moe.n_shared)
    assert ("router_bias" in pt) == tc.moe.router_aux_free


@pytest.mark.parametrize("shape", [(1, 7), (2, 16), (8, 1), (4, 1),
                                   (1, 40), (3, 13)])
def test_apply_moe_matches_reference(moe, shape):
    """Output and aux against the reference's ``apply_moe``; (8, 1) and
    (4, 1) are decode batches, the rest prefill-like."""
    jc, tc, pj, pt = moe
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    x = _tokens(rng, shape, jc.d_model)
    out_j, aux_j = JL.apply_moe(pj, jnp.asarray(x), jc)
    out_t, aux_t = TL.apply_moe(pt, torch.from_numpy(x), tc)
    assert out_t.shape == x.shape and aux_t.shape == ()
    _close(out_t, out_j)
    _close(aux_t, aux_j)


def test_moe_rows_are_independent(moe):
    """A token's output does not depend on the other tokens of the call
    (the combine runs over all of them at once): a batch of 11 equals
    each token alone."""
    jc, tc, _, pt = moe
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_tokens(rng, (11, 1), jc.d_model))
    out, _ = TL.apply_moe(pt, x, tc)
    for t in range(x.shape[0]):
        _close(out[t], TL.apply_moe(pt, x[t:t + 1], tc)[0][0])


def test_moe_dropless_routes_every_token():
    """Twin of tests/test_training_math.py's forward half (the gradient
    half waits for the training slice): shape, finite, aux > 0, and every
    token's output is its top-k experts' weighted sum, none dropped."""
    jc, tc = _configs("granite-moe-3b-a800m", 0)
    pj = JL.init_moe(jax.random.PRNGKey(0), jc)
    p = params_from_numpy(tc, jax.device_get(pj), "cpu")
    x = torch.from_numpy(_tokens(np.random.default_rng(0), (1, 16),
                                 jc.d_model))
    out, aux = TL.apply_moe(p, x, tc)
    assert out.shape == x.shape
    assert torch.isfinite(out).all()
    assert float(aux) > 0.0
    xf = x.reshape(-1, tc.d_model)
    top_w, top_idx = torch.topk(xf @ p["router"], tc.moe.top_k)
    top_w = torch.softmax(top_w, -1)
    act = TL.activation_fn(tc.activation)
    for t in range(xf.shape[0]):
        want = sum(float(top_w[t, j]) * (
            act(xf[t] @ p["wi"][e]) * (xf[t] @ p["wg"][e])) @ p["wo"][e]
            for j, e in enumerate(top_idx[t].tolist()))
        _close(out.reshape(-1, tc.d_model)[t], want)


def _forms(monkeypatch, budget):
    """Count the calls of each MoE form while ``MOE_EVERY_EXPERT_BYTES``
    is ``budget`` (0: every call is grouped)."""
    seen = {"every": 0, "grouped": 0}
    for form in seen:
        inner = getattr(TL, f"_moe_{form}")

        def run(*a, _inner=inner, _form=form, **k):
            seen[_form] += 1
            return _inner(*a, **k)
        monkeypatch.setattr(TL, f"_moe_{form}", run)
    monkeypatch.setattr(TL, "MOE_EVERY_EXPERT_BYTES", budget)
    return seen


@pytest.mark.parametrize("shape", [(2, 16), (1, 40), (8, 1)])
def test_grouped_moe_matches_reference_and_every_expert(moe, shape,
                                                        monkeypatch):
    """The grouped form (the budget at 0 forces it) against the
    reference's ``apply_moe`` and against the every-expert form (the
    default at smoke sizes), output and aux."""
    jc, tc, pj, pt = moe
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    x = _tokens(rng, shape, jc.d_model)
    out_j, aux_j = JL.apply_moe(pj, jnp.asarray(x), jc)
    out_e, aux_e = TL.apply_moe(pt, torch.from_numpy(x), tc)
    seen = _forms(monkeypatch, 0)
    out_g, aux_g = TL.apply_moe(pt, torch.from_numpy(x), tc)
    assert seen == {"every": 0, "grouped": 1}
    assert out_g.shape == x.shape
    _close(out_g, out_j)
    _close(aux_g, aux_j)
    _close(out_g, out_e)
    _close(aux_g, aux_e)


@pytest.mark.parametrize("model,tokens,form", [
    ("deepseek-v3-671b", 8, "every"),          # the serving decode batch
    ("deepseek-v3-671b", 146, "every"),
    ("deepseek-v3-671b", 147, "grouped"),
    ("deepseek-v3-671b", 1000, "grouped"),     # a prompt, the MTP check
    ("granite-moe-3b-a800m", 8, "every"),
    ("granite-moe-3b-a800m", 1000, "every"),   # its longest served prompt
    ("granite-moe-3b-a800m", 1500, "every")])
def test_moe_form_rule(model, tokens, form):
    """``moe_form`` on shapes alone: the every-expert form while its
    (E, T, max(d, f)) fp32 intermediates fit ``MOE_EVERY_EXPERT_BYTES``."""
    cfg = t_get(model)
    assert TL.moe_form(cfg, tokens) == form
    mo = cfg.moe
    big = mo.e_total * tokens * max(cfg.d_model, mo.d_ff_expert) * 4
    assert (big <= TL.MOE_EVERY_EXPERT_BYTES) == (form == "every")


def test_apply_moe_takes_the_rules_form(moe, monkeypatch):
    """``apply_moe`` runs the form ``moe_form`` picks: every-expert at
    smoke sizes, grouped once the budget is below the call's
    intermediates (here 2 x 5 tokens: a budget of one token's)."""
    jc, tc, _, pt = moe
    x = torch.from_numpy(_tokens(np.random.default_rng(3), (2, 5),
                                 jc.d_model))
    mo = tc.moe
    one = mo.e_total * max(tc.d_model, mo.d_ff_expert) * 4
    seen = _forms(monkeypatch, TL.MOE_EVERY_EXPERT_BYTES)
    TL.apply_moe(pt, x, tc)
    TL.apply_moe(pt, x[:1, :1], tc)
    assert seen == {"every": 2, "grouped": 0}
    monkeypatch.setattr(TL, "MOE_EVERY_EXPERT_BYTES", one)
    assert TL.moe_form(tc, 1) == "every" and TL.moe_form(tc, 10) == "grouped"
    TL.apply_moe(pt, x[:1, :1], tc)
    TL.apply_moe(pt, x, tc)
    assert seen == {"every": 3, "grouped": 1}
