"""Trace-driven chaos harness: deterministic load + fault schedules + gates.

Port of ``repro/harness``. The package drives the port's public
``VolumeManager`` API (core/blockdev.py) with a seeded, replayable op
stream while a chaos scheduler injects replica failures, quorum loss,
rebuilds, link degradation, crashes and mid-trace control ops — every run
reproducible from ``(trace_seed, chaos_seed)``, and for the same seeds the
same run as the reference's (same trace, same schedule, same digest):

- ``traces``  — the fio-style trace generator: seq/rand mixes, read
  fraction, burst arrivals, zipf-hot volumes and pages, aligned and
  unaligned byte spans,
- ``chaos``   — the chaos scheduler: trace-indexed fault/control events,
- ``oracle``  — the shadow bytearray oracle: mirrors every acked write,
  checks byte equivalence on every read and, at end of trace, on every
  surviving replica,
- ``stats``   — latency percentiles (P50/P99/P999 in pump ticks via the
  ``Request.latency`` lane) + controller wait-tick tails + transport
  counters,
- ``runner``  — ``run(...)``: one harness execution; the named scenario
  catalog (``SCENARIOS``/``run_scenario``); ``run_matrix`` +
  ``check_trace_gates`` — the ``trace`` document and its gates.

The harness is host code: on the card its device work is the DBS kernels
(``dbs_rw_write``/``dbs_rw_read``, and ``dbs_copy`` on the ``copy`` entry)
that the manager's backends launch. ``python -m repro_torch.harness`` is
the CLI.
"""
from repro_torch.harness.chaos import ChaosConfig, ChaosEvent, schedule_chaos
from repro_torch.harness.oracle import ByteOracle, OracleMismatch
from repro_torch.harness.runner import (SCENARIOS, HarnessResult,
                                        check_trace_gates, run, run_matrix,
                                        run_scenario)
from repro_torch.harness.stats import percentile, summarize
from repro_torch.harness.traces import TraceConfig, TraceOp, generate_trace

__all__ = [
    "ChaosConfig", "ChaosEvent", "schedule_chaos",
    "ByteOracle", "OracleMismatch",
    "SCENARIOS", "HarnessResult", "check_trace_gates", "run", "run_matrix",
    "run_scenario",
    "percentile", "summarize",
    "TraceConfig", "TraceOp", "generate_trace",
]
