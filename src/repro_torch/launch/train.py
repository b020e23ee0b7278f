"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Port of ``repro/launch/train.py``. It trains on the card (``cuda``) unless
``--device cpu`` is given; as the reference, it runs the reduced (smoke)
config by default and the published one with ``--full``. With
``--ckpt-dir`` it checkpoints to two replicas, ``<dir>/a`` and ``<dir>/b``,
every ``--ckpt-every`` steps and at the end, and resumes from them. The
trainer's checkpoint store is sized to the params and optimizer state
(``training/trainer.py ckpt_capacity``; the reference's is 256 MB
whatever the model, so its ``--full`` with a checkpoint directory fits no
model of the catalog).
"""
from __future__ import annotations

import argparse
import os

from repro_torch.configs import (ALL_ARCHS, ExecutionPlan, get_config,
                                 smoke_config)
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.training.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params "
          f"on {args.device}")
    plan = ExecutionPlan(remat="block", compute_dtype="float32",
                         logits_chunk=0)
    dirs = None
    if args.ckpt_dir:
        dirs = [os.path.join(args.ckpt_dir, d) for d in "ab"]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
    data = Prefetcher(SyntheticLM(cfg.vocab_size, args.batch, args.seq,
                                  codebooks=cfg.n_codebooks), depth=2)
    tr = Trainer(cfg, plan, data, ckpt_dirs=dirs, ckpt_every=args.ckpt_every,
                 device=args.device, total_steps=args.steps,
                 warmup=max(2, args.steps // 10))
    hist = tr.run(args.steps)
    print(f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
          f"({tr.straggler_events} straggler events)")
    if tr.ckpt:
        tr.ckpt.close()
    data.close()
    return hist


if __name__ == "__main__":
    main()
