"""Port parity: the whole system's second path on the CPU — train,
checkpoint to replicated on-disk DBS volumes, restart, serve — the twin of
tests/test_system.py (its four cases) and of
tests/test_durability.py::test_checkpoint_rebuild_streams_blocks.

Beyond them: the data sources give the reference's batches, equal, for
the same seed, shard and shapes; the checkpoint rebuild's stream summary
(blocks a volume, ``sent["STREAM"]``, bytes and extents moved) equals the
reference's; a ``Trainer`` started from the reference trainer's params and
optimizer state follows its loss trajectory (step 0 within rtol 1e-5, the
same params and batch; the later steps within atol 1e-4, looser, since
AdamW's first step is a sign function: gradients that differ in their last
bits can move a parameter near zero by up to 2·lr); a resumed trainer's
params and state equal the saved ones bit for bit and serve the same
tokens; the launcher trains and resumes; and the reference's resume fault (a
checkpoint that does not fit the model silently restarts training) is
pinned in the reference and corrected in the port.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.checkpoint import ReplicatedCheckpoint as JReplicated  # noqa: E402
from repro.configs import ExecutionPlan as JPlan  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.data.pipeline import MemmapLM as JMemmap  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.training.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.checkpoint import ReplicatedCheckpoint  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import ExecutionPlan  # noqa: E402
from repro_torch.core.convert import (opt_state_from_numpy,  # noqa: E402
                                      params_from_numpy)
from repro_torch.data.pipeline import (MemmapLM, Prefetcher,  # noqa: E402
                                       SyntheticLM)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.serving.engine import GenRequest, ServeEngine  # noqa: E402
from repro_torch.models.model import tree_leaves  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402

PLAN = ExecutionPlan(remat="none", compute_dtype="float32", microbatches=1,
                     logits_chunk=0)
J_PLAN = JPlan(remat="none", compute_dtype="float32", microbatches=1,
               logits_chunk=0)


def _dirs(tmp_path, name="ck"):
    dirs = [str(tmp_path / name / d) for d in "ab"]
    for d in dirs:
        os.makedirs(d)
    return dirs


def _serve(cfg, params):
    eng = ServeEngine(cfg, params, n_slots=2, max_len=48, device="cpu")
    eng.submit(GenRequest(req_id=0,
                          prompt=np.arange(8, dtype=np.int64) % cfg.vocab_size,
                          max_new=4))
    outs = eng.run(max_steps=12)
    eng.volumes.close()
    return outs[0]


def _bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_train_checkpoint_restart_serve(tmp_path):
    cfg = smoke_config("granite-3-8b")
    dirs = _dirs(tmp_path)
    data = SyntheticLM(cfg.vocab_size, 4, 16)

    tr = Trainer(cfg, PLAN, data, ckpt_dirs=dirs, ckpt_every=4,
                 total_steps=20, warmup=2, device="cpu")
    hist = tr.run(8)
    assert hist[-1]["loss"] < hist[0]["loss"] + 0.05
    step_before = tr.step
    tr.ckpt.close()

    # "preemption": a fresh process-equivalent trainer resumes exactly
    tr2 = Trainer(cfg, PLAN, data, ckpt_dirs=dirs, ckpt_every=4,
                  total_steps=20, warmup=2, device="cpu")
    assert tr2.step == step_before
    _bit_equal(tr2.params, tr.params)
    _bit_equal(tr2.opt_state, tr.opt_state)
    # and the restored params serve through the paged engine, as the live
    # ones do
    out = _serve(cfg, tr2.params)
    assert len(out) == 4
    assert out == _serve(cfg, tr.params)
    tr2.ckpt.close()


def test_straggler_accounting(tmp_path):
    cfg = smoke_config("gemma2-2b")
    data = SyntheticLM(cfg.vocab_size, 2, 16)
    tr = Trainer(cfg, PLAN, data, ckpt_dirs=None, total_steps=20, warmup=1,
                 deadline_factor=0.0, device="cpu")
    tr.run(8)
    assert tr.straggler_events > 0      # the deadline accounting fires
    assert len(tr.history) == 8 and tr.history[-1]["step"] == 7


def test_prefetcher_overlaps_and_closes():
    src = SyntheticLM(100, 4, 8)
    pf = Prefetcher(src, depth=3)
    batches = [next(pf) for _ in range(5)]
    assert all(b["tokens"].shape == (4, 8) for b in batches)
    # the reference's stream, equal, through the prefetcher too
    ref = iter(JSynthetic(100, 4, 8))
    for b in batches:
        want = next(ref)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k], want[k])
    # shard disjointness: different shards draw different streams
    a = next(iter(SyntheticLM(100, 4, 8, shard=0, n_shards=2)))
    b = next(iter(SyntheticLM(100, 4, 8, shard=1, n_shards=2)))
    assert not np.array_equal(a["tokens"], b["tokens"])
    pf.close()


@pytest.mark.parametrize("kw", [dict(vocab=256000, batch=4, seq=32),
                                dict(vocab=2048, batch=2, seq=16,
                                     codebooks=4),
                                dict(vocab=49155, batch=8, seq=8, shard=3,
                                     n_shards=4, seed=7)])
def test_synthetic_batches_equal_reference(kw):
    kw = dict(kw)
    vocab, batch, seq = kw.pop("vocab"), kw.pop("batch"), kw.pop("seq")
    got = iter(SyntheticLM(vocab, batch, seq, **kw))
    want = iter(JSynthetic(vocab, batch, seq, **kw))
    for _ in range(3):
        g, w = next(got), next(want)
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_memmap_source(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.arange(10_000, dtype=np.int32).tofile(path)
    src = MemmapLM(path, batch=2, seq=16)
    b0 = next(iter(src))
    assert b0["tokens"].shape == (2, 16)
    np.testing.assert_array_equal(b0["labels"][:, :-1], b0["tokens"][:, 1:])
    # shards and the wrap at the end of a shard, as the reference reads
    got = iter(MemmapLM(path, batch=4, seq=31, shard=1, n_shards=3))
    want = iter(JMemmap(path, batch=4, seq=31, shard=1, n_shards=3))
    for _ in range(30):
        g, w = next(got), next(want)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(g[k], w[k])


def test_checkpoint_rebuild_streams_blocks(tmp_path):
    """The reference durability test's checks, and its stream summary
    equal to the reference's for the same store."""
    tree = {"w": np.arange(512, dtype=np.float32).reshape(16, 32)}
    infos = {}
    for pkg, rep in (("j", JReplicated), ("t", ReplicatedCheckpoint)):
        rc = rep(_dirs(tmp_path, pkg), capacity_bytes=1 << 24)
        rc.save("train", 4, tree)
        rc.fail(1)
        info = rc.rebuild(1)
        assert info is rc.last_rebuild
        assert info["volumes"] and info["counters"]["sent"]["STREAM"] >= 1
        assert info["counters"]["bytes_moved"] > 0
        step, back = rc.stores[1].restore("train", like=tree)
        assert step == 4
        np.testing.assert_array_equal(np.asarray(back["w"]), tree["w"])
        infos[pkg] = info
        rc.close()
    assert infos["t"] == infos["j"]


def test_trainer_follows_reference_trajectory():
    """The port's ``Trainer`` with the reference trainer's initial params
    and optimizer state swapped in, on the reference's data stream: the
    same losses (module note: step 0 to rtol 1e-5, later steps to atol
    1e-4) and ``grad_norm`` at step 0."""
    jc, tc = j_smoke("granite-3-8b"), smoke_config("granite-3-8b")
    jt = JTrainer(jc, J_PLAN, JSynthetic(jc.vocab_size, 4, 16),
                  total_steps=20, warmup=2)
    tr = Trainer(tc, PLAN, SyntheticLM(tc.vocab_size, 4, 16),
                 total_steps=20, warmup=2, device="cpu")
    tr.params = params_from_numpy(tc, jax.device_get(jt.params), "cpu")
    tr.opt_state = opt_state_from_numpy(jax.device_get(jt.opt_state), "cpu")
    want, got = jt.run(4), tr.run(4)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5)
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], atol=1e-4)
    assert [h["step"] for h in got] == [h["step"] for h in want]


def test_resume_raises_on_a_mismatched_checkpoint(tmp_path):
    """The reference's ``_try_resume`` takes every exception for "no
    checkpoint": a trainer of another arch over a granite-3-8b checkpoint
    starts from step 0. The port starts fresh only when no replica holds a
    valid checkpoint, and raises on the mismatch."""
    dirs = _dirs(tmp_path)
    cfg = smoke_config("granite-3-8b")
    tr = Trainer(cfg, PLAN, SyntheticLM(cfg.vocab_size, 2, 8),
                 ckpt_dirs=dirs, device="cpu")
    tr.run(2)
    tr.ckpt.close()
    jt = JTrainer(j_smoke("gemma2-2b"), J_PLAN, None, ckpt_dirs=dirs)
    assert jt.step == 0                          # the fault: a silent restart
    jt.ckpt.close()
    with pytest.raises(ValueError, match="structure mismatch"):
        Trainer(smoke_config("gemma2-2b"), PLAN, None, ckpt_dirs=dirs,
                device="cpu")
    # with no checkpoint at all both start fresh
    fresh = Trainer(cfg, PLAN, None, ckpt_dirs=_dirs(tmp_path, "fresh"),
                    device="cpu")
    assert fresh.step == 0
    fresh.ckpt.close()


def test_launch_train_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` with ``--device cpu``: three
    steps with checkpoints, then a second run that resumes at step 3."""
    args = ["--arch", "granite-3-8b", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    hist = launch_train.main(args + ["--steps", "3"])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert os.path.exists(tmp_path / "a" / "ckpt.dbs")
    assert os.path.exists(tmp_path / "b" / "ckpt.dbs")
    hist = launch_train.main(args + ["--steps", "2"])
    assert [h["step"] for h in hist] == [3, 4]
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "on cpu" in out
