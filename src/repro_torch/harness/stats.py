"""Latency/tail statistics + transport counters for harness runs.

Port of ``repro/harness/stats.py`` (pure Python over the port's
``Request.latency`` lane, ``_Waiter.wait_ticks`` and transport counters).

Two latency lanes, deliberately different clocks:

- **pump ticks** — the ``Request.latency`` lane every backend fills at
  completion: how many engine iterations an op spent in flight.
  The harness records each op's fan-out max (``IOFuture.latency()``); the
  percentiles here are what the BENCH ``trace`` key reports per scenario.
- **wait ticks** — the controller-side ``_Waiter.wait_ticks`` counter
  (core/replication.py): *simulated-network* time the controller spent
  waiting on replica links. Wall time barely separates read/write
  policies on a simulated link (ticking is host-cheap); wait ticks are
  the quantity the policies actually trade, so the straggler tail gates
  are expressed in them.

Percentiles use the nearest-rank method on the sorted sample — exact,
deterministic, no interpolation surprises at tiny sample sizes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on an empty sample."""
    if not values:
        return 0.0
    s = sorted(values)
    rank = max(1, -(-len(s) * q // 100))        # ceil(n*q/100), min 1
    return float(s[int(rank) - 1])


def summarize(values: Sequence[float]) -> Dict[str, float]:
    """count/mean/p50/p99/p999/max of a sample (all 0.0 when empty)."""
    if not values:
        return {"count": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0,
                "p999": 0.0, "max": 0.0}
    return {
        "count": len(values),
        "mean": float(sum(values)) / len(values),
        "p50": percentile(values, 50),
        "p99": percentile(values, 99),
        "p999": percentile(values, 99.9),
        "max": float(max(values)),
    }


def transport_counters(storage: Any) -> Optional[Dict[str, Any]]:
    """Aggregate the per-link transport counters (core/transport.py) of a
    replica-group storage: messages sent per opcode, deliveries,
    retransmits and rebuild-stream pages moved. None when the backend has
    no transports (upstream/host/chained/null)."""
    transports = getattr(storage, "transports", None)
    if not transports:
        return None
    sent: Dict[str, int] = {}
    for t in transports:
        for op, n in t.sent.items():
            sent[op] = sent.get(op, 0) + int(n)
    return {
        "sent": dict(sorted(sent.items())),
        "delivered": sum(t.delivered for t in transports),
        "retransmits": sum(t.retransmits for t in transports),
        "pages_moved": sum(t.pages_moved for t in transports),
        "per_link_retransmits": [int(t.retransmits) for t in transports],
    }


def wait_ticks(storage: Any) -> Optional[int]:
    """The controller's accumulated wait-tick counter, when the storage is
    a policy object (``_Waiter``); None otherwise."""
    wt = getattr(storage, "wait_ticks", None)
    return int(wt) if wt is not None else None


def latency_lanes(per_kind: Dict[str, List[float]]) -> Dict[str, Any]:
    """Summaries per op kind plus the pooled sample."""
    pooled: List[float] = []
    out: Dict[str, Any] = {}
    for kind, vals in sorted(per_kind.items()):
        out[kind] = summarize(vals)
        pooled.extend(vals)
    out["all"] = summarize(pooled)
    return out
