"""End to end: train a 67.7M-parameter LM for a few hundred steps.

Port of ``examples/train_lm.py`` (whose docstring says ~110M; the model
has 67,676,800 parameters). A granite-family decoder on synthetic Zipf
data with the real training stack, on the reference's own training plan:
bf16 compute over fp32 params, remat by block, chunked CE, AdamW with
warmup and a cosine schedule, replicated DBS checkpoints every 50 steps
(the trainer's store sized to the params and AdamW's moments: 812 MB a
version), straggler accounting. Loss should fall from ~ln(V) toward the
Zipf entropy. A second run on the same ``--ckpt-dir`` resumes from the
newest checkpoint and trains ``--steps`` more.

Run:  python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import ExecutionPlan
from repro_torch.configs.base import ATTN_GLOBAL, ArchConfig
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.examples._common import (Lines, add_device_arg, clock,
                                          device_name, weights)
from repro_torch.models.model import param_count_actual
from repro_torch.training.trainer import Trainer

CFG_100M = ArchConfig(
    name="granite-100m", family="dense",
    n_layers=8, d_model=640, n_heads=10, n_kv_heads=2, head_dim=64,
    d_ff=2560, vocab_size=32_000, layer_pattern=(ATTN_GLOBAL,),
    activation="silu", gated_mlp=True, tie_embeddings=True)
PLAN = ExecutionPlan(remat="block", compute_dtype="bfloat16",
                     param_dtype="float32", microbatches=1, logits_chunk=64)


def main(argv=None, *, params=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # cuda must exist
    say = Lines()

    cfg = CFG_100M
    init = weights(cfg, params, dev)
    say(f"{cfg.name}: {param_count_actual(init)/1e6:.1f}M params")
    dirs = [os.path.join(args.ckpt_dir, d) for d in "ab"]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    data = Prefetcher(SyntheticLM(cfg.vocab_size, args.batch, args.seq),
                      depth=2)
    tr = Trainer(cfg, PLAN, data, ckpt_dirs=dirs, ckpt_every=50, lr=3e-4,
                 warmup=50, total_steps=args.steps, device=dev, params=init)
    del init
    start = tr.step
    t0 = clock(dev)
    hist = tr.run(args.steps)
    dt = clock(dev) - t0
    toks = args.steps * args.batch * args.seq
    say(f"\n{args.steps} steps in {dt:.0f}s "
        f"({toks/dt:.0f} tok/s on {device_name(dev)}), "
        f"stragglers: {tr.straggler_events}")
    for h in hist[:: max(1, len(hist) // 12)]:
        say(f"  step {h['step']:4d} loss {h['loss']:.4f} "
            f"gnorm {h['grad_norm']:.2f} ({h['step_time_s']:.2f}s)")
    say(f"final loss {hist[-1]['loss']:.4f} (start {hist[0]['loss']:.4f})")
    tr.ckpt.close()
    data.close()
    return {"lines": say.lines, "history": hist, "start_step": start,
            "step": tr.step, "params": tr.params, "opt_state": tr.opt_state,
            "ckpt_dirs": dirs, "ckpt_capacity": tr.ckpt.capacity,
            "seconds": dt, "tokens": toks,
            "straggler_events": tr.straggler_events}


if __name__ == "__main__":
    main()
