"""Serve a small model with batched requests through the paged-DBS engine.

Port of ``examples/serve_paged.py``: multi-queue admission -> slot table
-> DBS page allocation (control plane) -> paged decode (data plane), with
more requests than slots so continuous batching has to recycle. On the
card every prompt runs through the flash-attention kernel, every decode
step through the paged-attention kernel, every KV write pump through the
DBS write and read kernels.

Run:  python -m repro_torch.examples.serve_paged [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.core import dbs
from repro_torch.core.engine import resolve_device
from repro_torch.examples._common import (SERVE_PLAN, Lines, add_device_arg,
                                          clock, device_name, weights)
from repro_torch.serving import GenRequest, ServeEngine

N_REQUESTS = 10


def main(argv=None, *, params=None, record_logits=False):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # cuda must exist
    say = Lines()

    cfg = smoke_config("gemma2-2b")          # softcaps + local/global layers
    eng = ServeEngine(cfg, weights(cfg, params, dev), n_slots=4, max_len=96,
                      n_queues=2, plan=SERVE_PLAN,
                      record_logits=record_logits, device=dev)
    rng = np.random.default_rng(7)
    reqs = [GenRequest(req_id=rid, prompt=rng.integers(
        0, cfg.vocab_size, size=(6 + rid % 9,)), max_new=8)
        for rid in range(N_REQUESTS)]
    t0 = clock(dev)
    for r in reqs:
        eng.submit(r)
    outs = eng.run(max_steps=80)
    dt = clock(dev) - t0
    total = sum(len(v) for v in outs.values())
    say(f"served {N_REQUESTS} requests / {total} tokens in {dt:.1f}s "
        f"({total/dt:.1f} tok/s on {device_name(dev)}, {eng.n_slots} slots, "
        f"{eng.frontend.ring.n_queues} admission queues)")
    for rid, toks in sorted(outs.items()):
        say(f"  req {rid}: {toks}")
    st = dbs.stats(eng.state)
    say(f"DBS after drain: {st} (no extent leaks)")
    if st["extents_used"] != 0:
        raise AssertionError(f"extents leaked: {st}")
    return {"lines": say.lines, "outs": outs, "dbs": st, "seconds": dt,
            "tokens": total, "engine": eng,
            "logits": {r.req_id: r.logit_trace for r in reqs}}


if __name__ == "__main__":
    main()
