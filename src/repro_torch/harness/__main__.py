"""CLI for the chaos harness: ``python -m repro_torch.harness``.

Port of ``repro/harness/__main__.py``. Runs the scenario matrix (plus the
determinism replay) and writes the ``{"trace": ...}`` document, the same
shape as the reference's. ``--check`` applies ``check_trace_gates`` and
exits non-zero on any violation. ``--device`` picks the device the
managers run on (default ``cuda``; ``cpu`` runs every kernel's plain
version).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.harness.runner import SCENARIOS, check_trace_gates, run_matrix


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.harness",
        description="trace-driven chaos harness: scenario matrix + gates")
    ap.add_argument("--smoke", action="store_true",
                    help="short traces (120 ops a scenario)")
    ap.add_argument("--trace-seed", type=int, default=0)
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--scenario", action="append", default=None,
                    metavar="NAME", choices=sorted(SCENARIOS),
                    help="run only this scenario (repeatable)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the trace json document here")
    ap.add_argument("--check", action="store_true",
                    help="apply the harness gates; exit 1 on violation")
    ap.add_argument("--device", default="cuda",
                    help="device the managers run on (default cuda)")
    args = ap.parse_args(argv)

    trace = run_matrix(smoke=args.smoke, trace_seed=args.trace_seed,
                       chaos_seed=args.chaos_seed, scenarios=args.scenario,
                       device=args.device)
    for name, doc in trace.items():
        if name == "determinism":
            print(f"  determinism[{doc['scenario']}]: "
                  f"match={doc['match']} digest={doc['digest_a'][:12]}")
            continue
        lat = doc["latency"]["all"]
        print(f"  {name}: ops={doc['n_ops']} oracle_ok={doc['oracle_ok']} "
              f"checked_reads={doc['checked_reads']} "
              f"events={doc['events_applied']}+{doc['events_skipped']}skip "
              f"lat p50/p99/p999={lat['p50']:g}/{lat['p99']:g}/"
              f"{lat['p999']:g} ticks")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"trace": trace}, f, indent=2, sort_keys=True)
        print(f"wrote {args.out}")
    if args.check:
        problems = check_trace_gates(trace)
        if problems:
            print("HARNESS GATES FAILED:")
            for p in problems:
                print(f"  - {p}")
            return 1
        print("harness gates: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
