"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Port of ``repro/launch/serve.py``, with its flags, on the card (``cuda``)
unless ``--device cpu`` is given. ``main`` draws the reduced (smoke)
config's parameters from a generator seeded with 0 on the device;
``serve(cfg, params, ...)`` takes any parameters (the tests feed it the
reference's through ``core/convert.py params_from_numpy``) and serves the
launcher's requests: seeded prompts of 8 tokens (8 x K on a K-codebook
net), greedy, on the fused zero-copy engine, or on the ``host`` engine for
an attention-free net, whose recurrent state has no KV pages to map.
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, ArchConfig, smoke_config
from repro_torch.models import init_params
from repro_torch.serving import GenRequest, ServeEngine


def serve(cfg: ArchConfig, params, *, requests: int = 6, max_new: int = 8,
          slots: int = 4, queues: int = 2, device="cuda"
          ) -> Dict[int, List[int]]:
    """Serve the launcher's requests with ``params``; ``{req_id: tokens}``."""
    eng = ServeEngine(cfg, params, n_slots=slots, max_len=128,
                      n_queues=queues, device=device,
                      kv_backend="host" if cfg.attention_free else "fused")
    rng = np.random.default_rng(0)
    for rid in range(requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=(8,) if cfg.n_codebooks == 1
                              else (8, cfg.n_codebooks))
        eng.submit(GenRequest(req_id=rid, prompt=prompt, max_new=max_new))
    return eng.run(max_steps=requests * max_new + 20)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--queues", type=int, default=2)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    if cfg.attention_free:
        print(f"note: {cfg.name} is attention-free; the paged-DBS path is "
              "inapplicable — serving uses its O(1) recurrent state on the "
              "host KV backend.")
    dev = torch.device(args.device)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    outs = serve(cfg, params, requests=args.requests, max_new=args.max_new,
                 slots=args.slots, queues=args.queues, device=dev)
    for rid, toks in sorted(outs.items()):
        print(f"req {rid}: {toks}")
    return outs


if __name__ == "__main__":
    main()
