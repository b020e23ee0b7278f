"""Session forking = DBS snapshots + copy-on-write (paper §IV-D on HBM).

Port of ``examples/fork_sessions.py``. A parent session generates; it is
forked twice mid-stream. Forks share the parent's KV pages (no copy) until
one of them writes into the shared frontier page, where the zero-copy
engine's DBS write kernel composes the fresh extent from the shared one
(copy-on-write in the write itself), as Longhorn's snapshots do on disk.
Greedy decoding proves isolation: every fork continues the parent's
stream identically.

Run:  python -m repro_torch.examples.fork_sessions [--device cpu]
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


def main(argv=None, *, params=None, record_logits=False):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # cuda must exist
    say = Lines()

    cfg = smoke_config("granite-3-8b")
    eng = ServeEngine(cfg, weights(cfg, params, dev), n_slots=6, max_len=96,
                      plan=SERVE_PLAN, record_logits=record_logits,
                      device=dev)
    rng = np.random.default_rng(3)
    parent = GenRequest(req_id=0, prompt=rng.integers(
        0, cfg.vocab_size, size=(10,)), max_new=14)
    t0 = clock(dev)
    eng.submit(parent)
    made = 0                                 # tokens the steps emit
    for _ in range(4):
        made += len(eng.step())
    say("parent after 4 steps:", eng.live[0].out_tokens)
    say("DBS:", dbs.stats(eng.state))

    c1 = eng.fork(0, 1, max_new=8)
    c2 = eng.fork(0, 2, max_new=10)
    say(f"forked twice (volumes {c1.volume}, {c2.volume}) — "
        f"pages shared, snapshots: {dbs.stats(eng.state)['snapshots']}")

    for _ in range(16):
        made += len(eng.step())
    dt = clock(dev) - t0

    p = eng.live[0].out_tokens
    say("parent:", p)
    for rid in (1, 2):
        c = eng.live[rid].out_tokens
        marker = "== parent prefix" if c == p[:len(c)] else "!! DIVERGED"
        say(f"fork {rid}: {c}  {marker}")
        if c != p[:len(c)]:
            raise AssertionError("CoW isolation broken")
    final = dbs.stats(eng.state)
    say("final DBS:", final)
    say(f"{made} tokens in {dt:.1f}s ({made/dt:.1f} tok/s on "
        f"{device_name(dev)})")
    say("fork_sessions OK")
    return {"lines": say.lines, "seconds": dt, "tokens": made,
            "outs": {rid: list(g.out_tokens) for rid, g in eng.live.items()},
            "logits": {rid: g.logit_trace for rid, g in eng.live.items()},
            "dbs": final, "engine": eng}


if __name__ == "__main__":
    main()
