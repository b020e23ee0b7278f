"""Quickstart: the whole system in one script.

Port of ``examples/quickstart.py``. Builds a reduced granite-family
model, trains it a few steps on synthetic data (the fp32 plan),
checkpoints to a replicated DBS store, restarts, and serves the result
through the paged-KV engine (DBS volumes + slot scheduler + multi-queue
admission).

Run:  python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs import ExecutionPlan, smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.examples._common import (SERVE_PLAN, Lines, add_device_arg,
                                          clock, device_name, weights)
from repro_torch.serving import GenRequest, ServeEngine
from repro_torch.training.trainer import Trainer

TRAIN_STEPS = 15


def main(argv=None, *, params=None, record_logits=False):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # cuda must exist
    say = Lines()

    cfg = smoke_config("granite-3-8b")
    plan = ExecutionPlan(remat="none", compute_dtype="float32")
    kw = dict(ckpt_every=5, total_steps=40, warmup=2, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [os.path.join(tmp, d) for d in "ab"]
        for d in dirs:
            os.makedirs(d)

        say(f"== training {cfg.name} ({cfg.n_layers}L d={cfg.d_model}) ==")
        data = SyntheticLM(cfg.vocab_size, batch=4, seq=32)
        trainer = Trainer(cfg, plan, data, ckpt_dirs=dirs,
                          params=weights(cfg, params, dev), **kw)
        t0 = clock(dev)
        hist = trainer.run(TRAIN_STEPS)
        train_s = clock(dev) - t0
        say(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
            f"({trainer.step} steps, checkpointed to {len(dirs)} replicas)")
        trainer.ckpt.close()

        say("== restart: resume from the replicated DBS checkpoint ==")
        # the same tree as the first trainer's (the checkpoint's
        # structure), its values replaced by the restore
        trainer2 = Trainer(cfg, plan, data, ckpt_dirs=dirs,
                           params=weights(cfg, params, dev), **kw)
        if trainer2.step != trainer.step:
            raise AssertionError(f"resumed at step {trainer2.step}, not "
                                 f"{trainer.step}")
        say(f"resumed at step {trainer2.step}")

        say("== serving with paged-DBS KV cache ==")
        eng = ServeEngine(cfg, trainer2.params, n_slots=4, max_len=64,
                          plan=SERVE_PLAN, record_logits=record_logits,
                          device=dev)
        rng = np.random.default_rng(0)
        reqs = [GenRequest(req_id=rid, prompt=rng.integers(
            0, cfg.vocab_size, size=(8,)), max_new=8) for rid in range(3)]
        t0 = clock(dev)
        for r in reqs:
            eng.submit(r)
        outs = eng.run(max_steps=30)
        serve_s = clock(dev) - t0
        for rid, toks in sorted(outs.items()):
            say(f"request {rid}: {toks}")
        trainer2.ckpt.close()
        tokens = sum(len(v) for v in outs.values())
        say(f"trained {TRAIN_STEPS} steps in {train_s:.1f}s, served "
            f"{tokens} tokens in {serve_s:.1f}s ({tokens/serve_s:.1f} tok/s "
            f"on {device_name(dev)})")
        say("quickstart OK")
    return {"lines": say.lines, "history": hist, "resumed": trainer2.step,
            "outs": outs, "logits": {r.req_id: r.logit_trace for r in reqs},
            "train_seconds": train_s, "seconds": serve_s, "tokens": tokens,
            "engine": eng}


if __name__ == "__main__":
    main()
