"""Twin of ``examples/train_lm.py``, the reference's own training plan
(bf16 compute over fp32 params, remat by block, logits in chunks of 64)
on its 67.7M-parameter model, cut to 2 steps of 2 x 32 tokens.

The reference script cannot finish: its ``Trainer`` opens a 256 MB store
whatever the model, and the params with AdamW's moments take 812 MB, so
the save at the end of its run raises. That fault is pinned by the
reference store's own save of one 320 MB array (``IndexError``), not by
the script. Its losses come from the reference ``Trainer`` without a
store, in this process, in bf16 and in fp32. The port's ``train_lm``
starts from the reference's weights. Its first loss (the same params and
batch) lies no farther from the reference's fp32 loss than ``FACTOR``
times the reference's own bf16 loss does (test_torch_train_bf16.py's
yardstick; measured: the port's 3.3e-4, the reference's 1.19e-3). Every
loss is within ``LOSS_RTOL`` of the reference's bf16 one: after a step,
AdamW's first update (near lr times the gradient's sign) flips ~0.5% of
each leaf's elements in either package where bf16 noise passes zero
(measured against fp32: the same share in both, gradients within 1.03x
of the reference's own bf16 error a leaf), and moves the next loss by
~1e-4 of itself (measured: the port 2.2e-4, the reference 1.1e-4 from
fp32's). The store is sized by ``ckpt_capacity``'s rule, and a restart
resumes at step 2 with the params and AdamW state bit for bit."""
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.checkpoint import ReplicatedCheckpoint as JCheckpoint  # noqa: E402
from repro.configs import ExecutionPlan as JPlan  # noqa: E402
from repro.data.pipeline import SyntheticLM as JData  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.training.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.checkpoint import ReplicatedCheckpoint  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.dbs_host import StoreFull  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.examples._common import weights  # noqa: E402
from repro_torch.models.model import tree_leaves  # noqa: E402
from repro_torch.training.trainer import (CKPT_CAPACITY,  # noqa: E402
                                          CKPT_KEEP, Trainer, ckpt_capacity)
from torch_example_twins import ROOT  # noqa: E402

FACTOR = 1.5                 # test_torch_train_bf16.py's yardstick
LOSS_RTOL = 5e-4             # a later step's bf16 noise, 5x (docstring)
STEPS, BATCH, SEQ = 2, 2, 32


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_train_lm", ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_store_cannot_hold_train_lm(tmp_path):
    """The reference's 256 MB store and one 80M-element fp32 array (the
    example's 812 MB state is 2.5x that): ``IndexError``. The port's store
    of that size refuses with ``StoreFull``; at ``ckpt_capacity``'s size
    it saves."""
    big = {"w": np.zeros(80_000_000, np.float32)}
    ref = JCheckpoint([str(tmp_path / "ref")], capacity_bytes=1 << 28)
    with pytest.raises(IndexError):
        ref.save("train", 0, big)
    port = ReplicatedCheckpoint([str(tmp_path / "small")],
                                capacity_bytes=CKPT_CAPACITY)
    with pytest.raises(StoreFull):
        port.save("train", 0, big)
    port.close()
    sized = ReplicatedCheckpoint([str(tmp_path / "sized")],
                                 capacity_bytes=ckpt_capacity(big))
    for step in range(CKPT_KEEP + 2):
        big["w"] += 1.0
        sized.save("train", step, big, keep_last=CKPT_KEEP)
    step, back = sized.restore("train", big)
    assert step == CKPT_KEEP + 1 and torch.equal(
        back["w"], torch.from_numpy(big["w"]))
    sized.close()


def test_small_models_keep_the_reference_store():
    cfg = smoke_config("granite-3-8b")
    tr = Trainer(cfg, train_lm.PLAN, None, device="cpu")
    assert ckpt_capacity(tr._state()) == CKPT_CAPACITY


def test_train_lm_matches_reference_saves_and_resumes(tmp_path):
    ref_mod = _reference_example()
    cfg = ref_mod.CFG_100M
    params = jax.device_get(j_init(jax.random.PRNGKey(0), cfg))
    want = {}
    for dtype in ("bfloat16", "float32"):
        plan = JPlan(remat="block", compute_dtype=dtype,
                     param_dtype="float32", microbatches=1, logits_chunk=64)
        jt = JTrainer(cfg, plan, JData(cfg.vocab_size, BATCH, SEQ),
                      lr=3e-4, warmup=50, total_steps=STEPS)
        want[dtype] = np.array([h["loss"] for h in jt.run(STEPS)])
        del jt

    argv = ["--steps", str(STEPS), "--batch", str(BATCH), "--seq", str(SEQ),
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    got = train_lm.main(argv, params=params)
    assert got["lines"][0] == "granite-100m: 67.7M params"
    assert train_lm.CFG_100M == train_lm.CFG_100M.__class__(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    losses = [h["loss"] for h in got["history"]]
    print("losses: port bf16", losses, "reference bf16", want["bfloat16"],
          "fp32", want["float32"])
    err = abs(losses[0] - want["float32"][0])
    yard = abs(want["bfloat16"][0] - want["float32"][0])
    assert err <= FACTOR * yard, (err, yard)
    np.testing.assert_allclose(losses, want["bfloat16"], rtol=LOSS_RTOL)
    assert got["lines"][-1] == (f"final loss {losses[-1]:.4f} "
                                f"(start {losses[0]:.4f})")
    state = {"params": got["params"], "opt": got["opt_state"]}
    assert got["ckpt_capacity"] == ckpt_capacity(state)
    version = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    assert version > 800e6 and got["ckpt_capacity"] >= (CKPT_KEEP + 1) \
        * version
    # a restart: the newest checkpoint (step 2), bit for bit
    tr = Trainer(train_lm.CFG_100M, train_lm.PLAN, None,
                 ckpt_dirs=got["ckpt_dirs"], device="cpu",
                 params=weights(train_lm.CFG_100M, params, "cpu"))
    assert tr.step == STEPS
    for a, b in zip(tree_leaves({"params": tr.params, "opt": tr.opt_state}),
                    tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tr.ckpt.close()
