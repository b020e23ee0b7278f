"""Port parity: the optimizers, the chunked cross-entropy, the MoE
gradient and microbatch accumulation (twin of the training half of
tests/test_training_math.py), and the hand-written kernels' grad guard.

The optimizers run on IDENTICAL inputs in both packages (the same params,
gradients and state, as numpy): AdamW's first step is a sign function
for |g| >> eps, so params after a full train step would amplify any
rounding in the gradients; the train step's gradients are compared in
test_torch_train_step*.py instead. Tolerances: schedules, clipping and
the optimizers within rtol 1e-6 (atol 1e-9 beside it, for values near
zero), fp32 in both; the chunked CE within the reference test's 1e-5; the
MoE input gradient within atol/rtol 1e-5; microbatches 1 against 2 within
rtol 1e-5, gradients within 1e-5 of each leaf's largest magnitude.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training.train_step import _ce_block as j_ce_block  # noqa: E402
from repro.training.train_step import (  # noqa: E402
    chunked_cross_entropy as j_chunked_ce)
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import ExecutionPlan  # noqa: E402
from repro_torch.core.convert import (opt_state_from_numpy,  # noqa: E402
                                      params_from_numpy)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.models.model import (leaves_up_to, tree_leaves,  # noqa: E402
                                      tree_map)
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

OPT = dict(rtol=1e-6, atol=1e-9)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _t(tree):
    return opt_state_from_numpy(_np(tree), "cpu")


def _close_trees(t_tree, j_tree, **tol):
    t_leaves = tree_leaves(t_tree)
    j_leaves = leaves_up_to(t_tree, _np(j_tree))
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a.numpy(), b, **tol)


def _rand_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(16, 8)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32),
            "stack": rng.normal(size=(3, 4, 5)).astype(np.float32),
            "col": rng.normal(size=(6, 1)).astype(np.float32),
            "nested": {"s": np.asarray(rng.normal(), np.float32),
                       "l": [rng.normal(size=(4, 4)).astype(np.float32)]}}


@pytest.mark.parametrize("warmup,total", [(1, 8), (4, 20), (10, 10),
                                          (0, 100)])
def test_warmup_cosine_matches_reference(warmup, total):
    j_fn = JO.warmup_cosine(3e-4, warmup, total)
    t_fn = TO.warmup_cosine(3e-4, warmup, total)
    for step in range(0, total + 5):
        want = float(j_fn(jnp.asarray(step, jnp.int32)))
        got = float(t_fn(torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, **OPT)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _rand_tree(0)
    j_out, j_norm = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                           max_norm)
    t_out, t_norm = TO.clip_by_global_norm(_t(tree), max_norm)
    np.testing.assert_allclose(float(t_norm), float(j_norm), **OPT)
    np.testing.assert_allclose(float(TO.global_norm(t_out)),
                               min(max_norm, float(j_norm)), rtol=1e-5)
    _close_trees(t_out, j_out, **OPT)


@pytest.mark.parametrize("name,overrides", [
    ("adamw", dict(warmup=2, total_steps=10)),
    ("adamw", dict(warmup=1, total_steps=4, weight_decay=0.0,
                   max_grad_norm=0.1)),
    ("adafactor", dict(warmup=2, total_steps=10)),
    ("adafactor", dict(warmup=1, total_steps=4, weight_decay=0.05,
                       max_grad_norm=0.1)),
])
def test_optimizer_matches_reference_on_identical_inputs(name, overrides):
    """Three updates from the same params and state with the same
    gradients in both packages: params, every state leaf, the count and
    the norm agree (the port's update works in place)."""
    j_init, j_update = JO.make_optimizer(name, **overrides)
    t_init, t_update = TO.make_optimizer(name, **overrides)
    params = _rand_tree(1)
    j_p = jax.tree.map(jnp.asarray, params)
    j_s = j_init(j_p)
    t_p, t_s = _t(params), t_init(_t(params))
    _close_trees(t_s, j_s, **OPT)
    for i in range(3):
        grads = _rand_tree(10 + i)
        j_p, j_s, j_norm = j_update(jax.tree.map(jnp.asarray, grads), j_s,
                                    j_p)
        with torch.no_grad():
            t_p2, t_s2, t_norm = t_update(_t(grads), t_s, t_p)
        assert t_p2 is t_p and t_s2 is t_s
        np.testing.assert_allclose(float(t_norm), float(j_norm), **OPT)
        _close_trees(t_p, j_p, **OPT)
        _close_trees(t_s, j_s, **OPT)
    assert int(t_s["count"]) == int(j_s["count"]) == 3
    assert t_s["count"].dtype == torch.int32


def test_optimizer_state_crosses_from_reference():
    """``opt_state_from_numpy`` carries AdamW's and Adafactor's state over
    with the reference's shapes and dtypes, and ``init`` builds the same
    structure on its own."""
    params = _rand_tree(2)
    for name in ("adamw", "adafactor"):
        j_init, _ = JO.make_optimizer(name)
        t_init, _ = TO.make_optimizer(name)
        j_s = _np(j_init(jax.tree.map(jnp.asarray, params)))
        crossed, own = opt_state_from_numpy(j_s, "cpu"), t_init(_t(params))
        for a, b, c in zip(leaves_up_to(own, crossed),
                           tree_leaves(own), leaves_up_to(own, j_s)):
            assert a.shape == b.shape == c.shape
            assert a.dtype == b.dtype
            assert str(a.dtype).split(".")[1] == str(c.dtype)


def test_optimizers_descend_quadratic():
    target = torch.tensor([1.5, -2.0, 0.5])
    for name in ("adamw", "adafactor"):
        init, update = TO.make_optimizer(name, lr=0.1, warmup=1,
                                         total_steps=200, weight_decay=0.0)
        params = {"w": torch.zeros((3,)), "m": torch.zeros((4, 4))}
        state = init(params)
        with torch.no_grad():
            for _ in range(120):
                grads = {"w": params["w"] - target,
                         "m": params["m"] - torch.eye(4)}
                params, state, _ = update(grads, state, params)
        np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                                   atol=0.15)
        np.testing.assert_allclose(params["m"].numpy(), np.eye(4),
                                   atol=0.15)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        TO.make_optimizer("sgd")


@pytest.mark.parametrize("arch,chunk", [("granite-3-8b", 8),
                                        ("gemma2-2b", 16),
                                        ("musicgen-large", 8)])
def test_chunked_ce_equals_direct(arch, chunk):
    """Twin of the reference test, and both against the reference's
    values on the same embedding, hidden states and labels (gemma2: the
    final-logit soft cap; musicgen: four codebooks' labels)."""
    jc, tc = j_smoke(arch), t_smoke(arch)
    key = jax.random.PRNGKey(0)
    emb = JL.init_embeddings(key, jc)
    h = jax.random.normal(key, (2, 32, jc.d_model))
    shape = (2, 32) + ((jc.n_codebooks,) if jc.n_codebooks > 1 else ())
    labels = jax.random.randint(key, shape, 0, jc.vocab_size)
    t_emb = params_from_numpy(tc, _np(emb), "cpu")
    t_h = torch.from_numpy(np.array(h))
    t_lab = torch.from_numpy(np.array(labels)).long()
    direct = TS._ce_block(t_emb, t_h, t_lab, tc)
    chunked = TS.chunked_cross_entropy(t_emb, t_h, t_lab, tc, chunk=chunk)
    np.testing.assert_allclose(float(chunked), float(direct), rtol=1e-5)
    np.testing.assert_allclose(float(direct),
                               float(j_ce_block(emb, h, labels, jc)),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(chunked), float(j_chunked_ce(emb, h, labels, jc, chunk)),
        rtol=1e-5)


def test_chunked_ce_gradient_equals_direct():
    """The checkpointed chunks give the direct block's gradients."""
    tc = t_smoke("gemma2-2b")
    emb = TL.init_embeddings(torch.Generator().manual_seed(0), tc)
    h = torch.randn((2, 32, tc.d_model),
                    generator=torch.Generator().manual_seed(1))
    labels = torch.randint(0, tc.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(2))
    grads = []
    for chunk in (0, 8):
        e = {k: v.detach().requires_grad_() for k, v in emb.items()}
        hh = h.detach().requires_grad_()
        loss = TS.chunked_cross_entropy(e, hh, labels, tc, chunk=chunk)
        grads.append(torch.autograd.grad(loss, [hh, e["tokens"]]))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_moe_dropless_gradient_matches_reference(monkeypatch):
    """The MoE gradient half of the reference test: grads flow through both
    forms, the grouped dispatch and every expert on every token (finite,
    nonzero), and equal the reference's input gradient of
    ``apply_moe(...)[0].sum()``."""
    jc, tc = j_smoke("granite-moe-3b-a800m"), t_smoke("granite-moe-3b-a800m")
    key = jax.random.PRNGKey(0)
    pj = JL.init_moe(key, jc)
    x = jax.random.normal(key, (1, 16, jc.d_model))
    g_j = jax.grad(lambda xx: JL.apply_moe(pj, xx, jc)[0].sum())(x)
    pt = params_from_numpy(tc, _np(pj), "cpu")
    for budget in (0, 1 << 40):                 # grouped, then every expert
        monkeypatch.setattr(TL, "MOE_EVERY_EXPERT_BYTES", budget)
        xt = torch.from_numpy(np.array(x)).requires_grad_()
        out, aux = TL.apply_moe(pt, xt, tc)
        (g_t,) = torch.autograd.grad(out.sum(), [xt])
        assert torch.isfinite(g_t).all()
        assert float(g_t.abs().sum()) > 0
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j),
                                   atol=1e-5, rtol=1e-5)


def _spy_grads(monkeypatch):
    """Record the gradients ``make_train_step`` hands its optimizer."""
    seen = []
    inner = TS.make_optimizer

    def spy(name, **kw):
        init, update = inner(name, **kw)

        def upd(grads, state, params):
            seen.append(tree_map(torch.clone, grads))
            return update(grads, state, params)
        return init, upd
    monkeypatch.setattr(TS, "make_optimizer", spy)
    return seen


def test_microbatches_accumulate_in_fp32(monkeypatch):
    """Two microbatches give the one-batch step's metrics and gradients
    (equal halves: the mean of the halves' means is the mean), the
    gradients accumulated in fp32 buffers."""
    tc = t_smoke("granite-3-8b")
    params = init_params(torch.Generator().manual_seed(0), tc)
    tok = torch.randint(0, tc.vocab_size, (4, 16),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok, "labels": tok}
    seen = _spy_grads(monkeypatch)
    out = []
    for mb in (1, 2):
        plan = ExecutionPlan(remat="block", compute_dtype="float32",
                             microbatches=mb)
        init, step = TS.make_train_step(tc, plan, total_steps=8, warmup=1)
        p = tree_map(torch.clone, params)
        _, _, m = step(p, init(p), batch)
        out.append(m)
    assert set(out[0]) == set(out[1]) == {"ce", "loss", "grad_norm"}
    for k in out[0]:
        np.testing.assert_allclose(float(out[1][k]), float(out[0][k]),
                                   rtol=1e-5)
    for a, b in zip(tree_leaves(seen[0]), tree_leaves(seen[1])):
        assert b.dtype == torch.float32
        scale = float(a.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# the hand-written kernels have no backward: their entries refuse grad
# ---------------------------------------------------------------------------
def _kernel_calls():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import (paged_attention_fwd,
                                                     paged_attention_pool_fwd)
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_fwd
    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=gen)
    bt = torch.tensor([[0, 1]], dtype=torch.int32)
    ln = torch.tensor([12], dtype=torch.int32)
    return {
        "flash_attention": lambda g: flash_attention(
            g(r(1, 8, 4, 16)), r(1, 8, 2, 16), r(1, 8, 2, 16)),
        "rwkv6_scan": lambda g: rwkv6_scan_fwd(
            r(1, 8, 2, 16), g(r(1, 8, 2, 16)), r(1, 8, 2, 16),
            -torch.rand((1, 8, 2, 16), generator=gen), r(2, 16)),
        "paged_attention": lambda g: paged_attention_fwd(
            r(1, 4, 16), g(r(2, 8, 2, 16)), r(2, 8, 2, 16), bt, ln),
        "paged_attention_pool": lambda g: paged_attention_pool_fwd(
            g(r(1, 4, 16)), r(2, 8, 2, 2, 16), bt, ln, k_plane=0,
            v_plane=1),
    }


@pytest.mark.parametrize("name", ["flash_attention", "rwkv6_scan",
                                  "paged_attention", "paged_attention_pool"])
def test_kernel_entries_refuse_grad(name):
    """With grad mode on and an input that requires grad each entry raises
    before it launches (here, before the CPU's plain version), naming the
    missing backward; without either it runs."""
    call = _kernel_calls()[name]
    with pytest.raises(ValueError, match="no backward"):
        call(lambda t: t.requires_grad_())
    out = call(lambda t: t)
    with torch.no_grad():
        call(lambda t: t.requires_grad_())
    assert torch.isfinite(out[0] if isinstance(out, tuple) else out).all()


@pytest.mark.parametrize("arch", ["gemma2-2b", "rwkv6-3b"])
def test_train_step_on_the_kernel_route_raises(arch):
    """A train step with ``attn_impl="cuda"`` raises instead of training
    everything but attention (gemma2: flash; rwkv6: the scan)."""
    tc = t_smoke(arch)
    params = init_params(torch.Generator().manual_seed(0), tc)
    tok = torch.randint(0, tc.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    plan = ExecutionPlan(remat="block", attn_impl="cuda",
                         compute_dtype="float32")
    init, step = TS.make_train_step(tc, plan)
    with pytest.raises(ValueError, match="no backward"):
        step(params, init(params), {"tokens": tok, "labels": tok})
    with torch.no_grad():                       # forward alone still runs
        h, _ = forward(params, tok, tc, plan)
    assert torch.isfinite(h).all()
