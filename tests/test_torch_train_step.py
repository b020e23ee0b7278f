"""Port parity: one train step on every arch at smoke width, the twin of
tests/test_arch_smoke.py's ``test_forward_and_train_step``; this file
takes the dense and codebook archs, test_torch_train_step_families.py the
MoE, MLA, hybrid and RWKV ones (two files, so that each stays short on
one test worker).

From the same parameters (the reference's, crossed with ``core/convert.py
params_from_numpy``) and batch, the port's loss, its parts (``ce``,
``aux``, ``mtp``) and ``grad_norm`` equal the reference's within atol
1e-6 and rtol 1e-5, and every parameter's gradient within 1e-4 of that
leaf's largest magnitude (fp32; a whole model's forward and backward,
summed in other orders). Then two of the port's train steps on that batch
give a finite loss that does not rise by more than the reference test's
0.05. The reference's values come from one jitted ``value_and_grad`` of
its ``loss_fn`` an arch, computed once a module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import ExecutionPlan as JPlan  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.training.optimizer import (  # noqa: E402
    global_norm as j_global_norm)
from repro.training.train_step import loss_fn as j_loss_fn  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import ExecutionPlan  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import leaves_up_to, tree_leaves  # noqa: E402
from repro_torch.training.train_step import (grads_of,  # noqa: E402
                                             make_train_step)

ARCHS = ["chameleon-34b", "gemma2-2b", "gemma3-27b", "granite-3-8b",
         "musicgen-large", "starcoder2-15b"]
METRIC_TOL = dict(atol=1e-6, rtol=1e-5)
GRAD_TOL = 1e-4                      # of each leaf's largest magnitude
PLAN = ExecutionPlan(remat="block", attn_impl="chunked",
                     compute_dtype="float32", microbatches=1,
                     logits_chunk=0)
J_PLAN = JPlan(remat="block", attn_impl="chunked", compute_dtype="float32",
               microbatches=1, logits_chunk=0)


def reference_step(arch):
    """(port config, the reference's params as numpy, batch as numpy, its
    loss metrics, grad_norm and gradients as numpy)."""
    jc, tc = j_smoke(arch), t_smoke(arch)
    params = j_init(jax.random.PRNGKey(0), jc)
    k = jc.n_codebooks
    tok = np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, 32, k) if k > 1 else (2, 32)).astype(np.int32)
    batch = {"tokens": tok, "labels": tok}
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(p, b, jc, J_PLAN), has_aux=True))
    (_, metrics), grads = vg(params, batch)
    return (tc, jax.device_get(params), batch,
            {k: float(v) for k, v in metrics.items()},
            float(j_global_norm(grads)), jax.device_get(grads))


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return reference_step(request.param)


def check_gradients(ref):
    tc, params, batch, metrics, gnorm, grads = ref
    tp = params_from_numpy(tc, params, "cpu")
    tb = {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}
    g, m = grads_of(tp, tb, tc, PLAN)
    assert set(m) == set(metrics)
    for k, want in metrics.items():
        np.testing.assert_allclose(float(m[k]), want, **METRIC_TOL)
    t_leaves = tree_leaves(g)
    j_leaves = leaves_up_to(g, grads)
    assert len(t_leaves) == len(jax.tree.leaves(grads))
    norm = float(torch.stack([x.square().sum() for x in t_leaves]).sum()
                 .sqrt())
    np.testing.assert_allclose(norm, gnorm, **METRIC_TOL)
    for a, b in zip(t_leaves, j_leaves):
        assert a.shape == b.shape
        scale = float(np.abs(b).max()) or 1.0
        err = float(np.abs(a.numpy() - b).max())
        assert err <= GRAD_TOL * scale, (err, scale)


def check_descends(ref):
    tc, params, batch = ref[:3]
    tp = params_from_numpy(tc, params, "cpu")
    tb = {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}
    init, step = make_train_step(tc, PLAN, total_steps=8, warmup=1)
    opt = init(tp)
    tp, opt, m1 = step(tp, opt, tb)
    tp, opt, m2 = step(tp, opt, tb)
    assert int(opt["count"]) == 2
    assert np.isfinite(float(m2["loss"]))
    assert float(m2["loss"]) < float(m1["loss"]) + 0.05, \
        f"loss not improving: {float(m1['loss'])} -> {float(m2['loss'])}"
    np.testing.assert_allclose(float(m1["loss"]), ref[3]["loss"],
                               **METRIC_TOL)
    np.testing.assert_allclose(float(m1["grad_norm"]), ref[4],
                               **METRIC_TOL)


def test_gradients_match_reference(ref):
    check_gradients(ref)


def test_train_step_descends(ref):
    check_descends(ref)
