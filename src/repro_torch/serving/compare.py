"""Time a gemma2-2b zero-copy serving decode step of this checkout against
other checkouts', on one card, in turns (needs the card).

    PYTHONPATH=src python -m repro_torch.serving.compare \\
        [--against NAME=DIR ...] [--rounds R] [--steps N]

``DIR`` is the root of another checkout (the parent commit unpacked with
``git archive``, say). Each run is a Python of its own on one checkout's
``src``, its kernels built under that checkout's ``build/``: gemma2-2b at
its published widths and depth, fp32, random weights from seed 0, on the
fused zero-copy engine (two KV replicas, 8 slots, 2 queues, the CUDA
kernels) with 8 requests whose prompts are drawn in [100, 1000] tokens.
The first step admits and prefills all eight; after WARM more steps, N
decode steps are timed one by one on the host clock, the card
synchronised before and after each. The runs go in turns, the order
reversed every round (parent, this, this, parent, ... : R pairs, each
side first in half of them), so a drift of the host falls on both
sides. Each run prints a JSON line; the last line is the summary: each
checkout's run medians, their median, the median step ms over all its
timed steps, and whether every run generated the same tokens.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from statistics import median
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[3]
WARM = 4

# runs on the checkout under test: only what every checkout of the port
# since zero-copy serving has (no module of this one)
CHILD = r"""
import hashlib, json, sys, time
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ExecutionPlan
from repro_torch.kernels import _build
from repro_torch.models import init_params
from repro_torch.serving.engine import GenRequest, ServeEngine

steps, warm = int(sys.argv[1]), int(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all()
dev = torch.device("cuda", 0)
cfg = get_config("gemma2-2b")
params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
eng = ServeEngine(cfg, params, n_slots=8, max_len=2048, n_queues=2,
                  kv_backend="fused", kv_replicas=2, kernel="cuda",
                  plan=ExecutionPlan(attn_impl="cuda",
                                     compute_dtype="float32"), device=dev)
rng = np.random.default_rng(2)
for rid in range(8):
    eng.submit(GenRequest(req_id=rid,
                          prompt=rng.integers(0, cfg.vocab_size,
                                              int(rng.integers(100, 1001))),
                          max_new=steps + warm + 8))
eng.step()                                  # admit and prefill all eight
for _ in range(warm):
    eng.step()
ms = []
for _ in range(steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
toks = [eng.live[r].out_tokens for r in range(8)]
print(json.dumps({"ms": ms, "tokens": hashlib.sha256(
    json.dumps(toks).encode()).hexdigest(), "torch": torch.__version__}))
"""


def run_one(root: Path, steps: int) -> Dict:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    cp = subprocess.run([sys.executable, "-c", CHILD, str(steps), str(WARM)],
                        cwd=root, env=env, capture_output=True, text=True)
    if cp.returncode != 0:
        raise RuntimeError(f"the run on {root} exited {cp.returncode}:\n"
                           f"{cp.stderr[-3000:]}")
    return json.loads(cp.stdout.strip().splitlines()[-1])


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    metavar="NAME=DIR", help="another checkout's root")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    roots = {"this": ROOT}
    for spec in args.against:
        name, _, path = spec.partition("=")
        roots[name] = Path(path).resolve()
    order = list(roots)
    ms: Dict[str, List[float]] = {name: [] for name in roots}
    runs: Dict[str, List[float]] = {name: [] for name in roots}
    tokens = set()
    for r in range(args.rounds):
        for name in (order[::-1] if r % 2 == 0 else order):
            got = run_one(roots[name], args.steps)
            ms[name] += got["ms"]
            runs[name].append(median(got["ms"]))
            tokens.add(got["tokens"])
            print(json.dumps({"run": name, "round": r,
                              "median_ms": median(got["ms"]),
                              "mean_ms": sum(got["ms"]) / len(got["ms"]),
                              "tokens": got["tokens"]}), flush=True)
    summary = {"run_medians_ms": runs,
               "median_of_runs_ms": {n: median(v) for n, v in runs.items()},
               "median_step_ms": {n: median(v) for n, v in ms.items()},
               "mean_step_ms": {n: sum(v) / len(v) for n, v in ms.items()},
               "steps_per_run": args.steps, "rounds": args.rounds,
               "tokens_equal": len(tokens) == 1}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
