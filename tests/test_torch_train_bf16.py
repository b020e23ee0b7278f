"""Port parity: training on the reference's own plan, bf16 compute over
fp32 params (``ExecutionPlan``'s default ``compute_dtype``, the plan
``default_plan`` gives every train shape and ``examples/train_lm.py``
runs), at smoke widths on the CPU.

bf16 rounds each op's result to 8 bits of mantissa, and the two packages
round at different points (XLA fuses elementwise chains and keeps them in
fp32 between their ends; eager PyTorch rounds after each op that is not
fused by hand, ``models/layers.gated``). So the port is not held to the
reference's bf16 numbers bit for bit, but to a yardstick: the reference's
own bf16 error. From the same params (the reference's, crossed with
``core/convert.py params_from_numpy``) and batch:

- the loss equals the reference's bf16 loss within rtol ``LOSS_RTOL``
  (measured: at most 2.7e-5 over the four archs; the reference's own
  bf16-to-fp32 gap is up to 1.7e-4 on granite-moe);
- per parameter leaf, the port's bf16 gradient lies no farther (in the
  Frobenius norm) from the reference's fp32 gradient than ``FACTOR``
  times the reference's own bf16 gradient does (measured: at most 1.28x,
  on hymba's ``fuse_norm`` leaves; median 0.91-1.0x over the archs).

Cases: the four archs' gradients; ``logits_chunk`` 64 against 0 in bf16;
``microbatches=2`` (the gradients accumulate in fp32 buffers), its
step's params against the reference's step by the same yardstick; a
``Trainer`` started from the reference's params following the
reference ``Trainer``'s bf16 losses for three steps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import ExecutionPlan as JPlan  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.data.pipeline import SyntheticLM as JData  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.training.train_step import loss_fn as j_loss_fn  # noqa: E402
from repro.training.train_step import (  # noqa: E402
    make_train_step as j_make_train_step)
from repro.training.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import ExecutionPlan  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models.model import leaves_up_to, tree_leaves  # noqa: E402
from repro_torch.training.train_step import (grads_of,  # noqa: E402
                                             make_train_step)
from repro_torch.training.trainer import Trainer  # noqa: E402

ARCHS = ["gemma2-2b", "granite-3-8b", "granite-moe-3b-a800m", "hymba-1.5b"]
LOSS_RTOL = 1e-4
FACTOR = 1.5
CHUNK_TOL = dict(rtol=1e-6, atol=0.0)      # chunked CE against unchunked
BF16_EPS = 2.0 ** -8
TRAJ_RTOL = 1e-4                           # Trainer losses, three steps
BATCH, SEQ = 2, 32


def _plan(cls, dtype, **kw):
    kw = dict(dict(remat="block", attn_impl="chunked", logits_chunk=0), **kw)
    return cls(compute_dtype=dtype, **kw)


def _batch(vocab, seq=SEQ):
    tok = np.random.default_rng(0).integers(
        0, vocab, (BATCH, seq)).astype(np.int32)
    return {"tokens": tok, "labels": tok}


def _t_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


def _j_grads(jc, params, batch, dtype, **kw):
    plan = _plan(JPlan, dtype, **kw)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(p, b, jc, plan), has_aux=True))
    (loss, _), grads = vg(params, batch)
    return float(loss), jax.device_get(grads)


def _yardstick(t_tree, port, ref16, ref32, factor=FACTOR):
    """Per leaf: ||port - ref32|| <= factor * ||ref16 - ref32||. Returns
    the largest ratio."""
    t_leaves = [x.float().numpy() for x in tree_leaves(port)]
    r16, r32 = leaves_up_to(t_tree, ref16), leaves_up_to(t_tree, ref32)
    assert len(t_leaves) == len(r16) == len(r32)
    worst = 0.0
    for a, b16, b32 in zip(t_leaves, r16, r32):
        assert a.shape == b32.shape
        yard = float(np.linalg.norm(b16 - b32))
        err = float(np.linalg.norm(a - b32))
        if yard == 0.0:
            assert err == 0.0
            continue
        worst = max(worst, err / yard)
        assert err <= factor * yard, (err, yard)
    return worst


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """(arch, port config, the reference's params as numpy, batch, its
    bf16 and fp32 (loss, gradients))."""
    arch = request.param
    jc = j_smoke(arch)
    params = j_init(jax.random.PRNGKey(0), jc)
    batch = _batch(jc.vocab_size)
    return (arch, t_smoke(arch), jax.device_get(params), batch,
            _j_grads(jc, params, batch, "bfloat16"),
            _j_grads(jc, params, batch, "float32"))


def test_bf16_plan_matches_reference(ref):
    _, tc, params, batch, (l16, g16), (_, g32) = ref
    tp = params_from_numpy(tc, params, "cpu")
    g, m = grads_of(tp, _t_batch(batch), tc, _plan(ExecutionPlan,
                                                   "bfloat16"))
    np.testing.assert_allclose(float(m["loss"]), l16, rtol=LOSS_RTOL)
    for leaf in tree_leaves(g):
        assert leaf.dtype == torch.float32       # fp32 params, fp32 grads
    _yardstick(g, g, g16, g32)


def test_bf16_logits_chunk_equals_unchunked():
    """``logits_chunk`` 64 on a 128-token sequence against one block, in
    bf16: the same bf16 hidden states and fp32 logits a row, so the loss
    agrees to fp32 summation order; the tied embedding's gradient comes
    back through a bf16 cast of the table a chunk (as in the reference's
    scan), rounded once a chunk, so every leaf agrees within bf16's
    epsilon (2^-8) of its largest magnitude (measured: 3.5e-4). The
    chunked form holds the yardstick against the reference's own chunked
    gradients."""
    jc, tc = j_smoke("gemma2-2b"), t_smoke("gemma2-2b")
    params = j_init(jax.random.PRNGKey(0), jc)
    batch = _batch(jc.vocab_size, seq=128)
    tp = params_from_numpy(tc, jax.device_get(params), "cpu")
    tb = _t_batch(batch)
    out = {c: grads_of(tp, tb, tc, _plan(ExecutionPlan, "bfloat16",
                                         logits_chunk=c)) for c in (0, 64)}
    np.testing.assert_allclose(float(out[64][1]["loss"]),
                               float(out[0][1]["loss"]), **CHUNK_TOL)
    for a, b in zip(tree_leaves(out[64][0]), tree_leaves(out[0][0])):
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= BF16_EPS * scale
    l16, g16 = _j_grads(jc, params, batch, "bfloat16", logits_chunk=64)
    _, g32 = _j_grads(jc, params, batch, "float32", logits_chunk=64)
    np.testing.assert_allclose(float(out[64][1]["loss"]), l16,
                               rtol=LOSS_RTOL)
    _yardstick(out[64][0], out[64][0], g16, g32)


def test_bf16_microbatches_accumulate_in_fp32(monkeypatch):
    """Two microbatches in bf16: the accumulated gradient is fp32 and
    equals the mean of the two halves' gradients taken alone; one step's
    loss matches the reference's two-microbatch step, and the params it
    leaves hold the yardstick against the reference's bf16 and fp32
    steps."""
    arch = "granite-3-8b"
    jc, tc = j_smoke(arch), t_smoke(arch)
    params = jax.device_get(j_init(jax.random.PRNGKey(0), jc))
    batch = _batch(jc.vocab_size)
    ref = {}
    for dtype in ("bfloat16", "float32"):
        init, step = j_make_train_step(
            jc, _plan(JPlan, dtype, microbatches=2), total_steps=8, warmup=1)
        p, _, m = jax.jit(step)(params, init(params), batch)
        ref[dtype] = (float(m["loss"]), jax.device_get(p))
    plan = _plan(ExecutionPlan, "bfloat16", microbatches=2)
    tp = params_from_numpy(tc, params, "cpu")
    tb = _t_batch(batch)
    halves = [grads_of(tp, {k: v[i:i + 1] for k, v in tb.items()}, tc,
                       plan)[0] for i in range(2)]
    seen = {}
    from repro_torch.training import optimizer as TO
    inner = TO.make_optimizer

    def spy(name, **kw):
        init, update = inner(name, **kw)

        def upd(grads, state, params):
            seen["grads"] = [g.clone() for g in tree_leaves(grads)]
            return update(grads, state, params)
        return init, upd
    monkeypatch.setattr("repro_torch.training.train_step.make_optimizer",
                        spy)
    init, step = make_train_step(tc, plan, total_steps=8, warmup=1)
    tp, _, m = step(tp, init(tp), tb)
    for acc, a, b in zip(seen["grads"], tree_leaves(halves[0]),
                         tree_leaves(halves[1])):
        assert acc.dtype == torch.float32
        torch.testing.assert_close(acc, (a + b) / 2, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(m["loss"]), ref["bfloat16"][0],
                               rtol=LOSS_RTOL)
    _yardstick(tp, tp, ref["bfloat16"][1], ref["float32"][1])


def test_bf16_trainer_follows_reference_losses():
    """A ``Trainer`` on the bf16 plan started from the reference's params
    takes the reference ``Trainer``'s data stream (``SyntheticLM``'s
    numpy copy) and follows its losses for three steps."""
    arch = "granite-3-8b"
    jc, tc = j_smoke(arch), t_smoke(arch)
    kw = dict(total_steps=10, warmup=2)
    jt = JTrainer(jc, _plan(JPlan, "bfloat16"),
                  JData(jc.vocab_size, batch=4, seq=32), **kw)
    want = [h["loss"] for h in jt.run(3)]
    params = params_from_numpy(
        tc, jax.device_get(j_init(jax.random.PRNGKey(0), jc)), "cpu")
    tt = Trainer(tc, _plan(ExecutionPlan, "bfloat16"),
                 SyntheticLM(tc.vocab_size, batch=4, seq=32), device="cpu",
                 params=params, **kw)
    got = [h["loss"] for h in tt.run(3)]
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
