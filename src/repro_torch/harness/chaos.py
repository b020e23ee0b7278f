"""The chaos scheduler: seeded, trace-indexed fault and control events.

Port of ``repro/harness/chaos.py``, with the reference's draw order: the
same seed and config give the same event list.

A *chaos schedule* is the failure half of a harness run: a list of
``ChaosEvent`` records, fully determined by ``(chaos_seed, ChaosConfig,
n_ops, n_replicas, n_volumes)``, each pinned to a trace index — the runner
fires every event whose ``index`` equals the next op's, *before*
submitting that op. Because events are indexed into the op stream (not
wall time), a replay hits each fault at exactly the same point in the
load, which is what makes ``(trace_seed, chaos_seed)`` replay
byte-identically.

Event vocabulary (the scenario catalog in ``runner.py`` composes these):

- ``fail`` / ``rebuild``   — replica failure and streamed delta rebuild
  (the controller's ``fail``/``rebuild`` control verbs; rebuilds while
  earlier write-behind traffic is still in flight are the point),
- ``quorum_loss``          — fail every replica but one (writes continue
  degraded under the quorum/async policies),
- ``recover``              — rebuild every failed replica (back-to-back
  delta rebuilds from the lone survivor after a quorum loss),
- ``snapshot`` / ``clone`` / ``discard`` — mid-trace control ops racing
  the data stream (and any in-flight rebuild traffic),
- ``straggler`` / ``heal`` — degrade one simnet link's latency mid-trace /
  restore it,
- ``drop_on`` / ``drop_off`` — raise one simnet link's loss rate / clear it,
- ``crash``               — kill the engine at a pump boundary and recover
  it from the durability journal (repro_torch/durability); scheduled by
  ``ChaosConfig.crash_every`` at fixed trace indices (not by weight — a
  crash must land at predictable pump boundaries), with every second crash
  also tearing a partial record onto the journal tail first (``arg=1``) to
  exercise torn-tail truncation.

The scheduler tracks simulated replica health while generating, so it
emits schedules that are *mostly* valid by construction; the runner still
guards every application (e.g. never failing the last healthy replica)
and counts deterministic skips instead of crashing — an invalid event
must replay as the same skip.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

# action -> default weight (ChaosConfig.weights overrides)
DEFAULT_WEIGHTS: Dict[str, float] = {
    "fail": 3.0, "rebuild": 3.0, "quorum_loss": 1.0, "recover": 2.0,
    "snapshot": 2.0, "clone": 1.0, "discard": 2.0,
    "straggler": 1.0, "heal": 1.0, "drop_on": 1.0, "drop_off": 1.0,
}


@dataclass(frozen=True)
class ChaosConfig:
    """Shape of the schedule. ``n_events`` events are spread uniformly over
    the trace; ``weights`` reweights (or, with zero, disables) actions —
    e.g. link actions are meaningless off simnet, so pure-local scenarios
    zero them out."""

    n_events: int = 8
    weights: Tuple[Tuple[str, float], ...] = ()
    straggler_latency: int = 8
    drop_rate: float = 0.2
    crash_every: int = 0    # >0: crash-and-recover every N trace ops
                            # (journal-enabled runs only); every 2nd crash
                            # tears a partial record onto the tail first


@dataclass(frozen=True)
class ChaosEvent:
    index: int          # fires before trace op `index` is submitted
    action: str
    replica: int = -1   # fail/rebuild/straggler/heal/drop_* target
    vol: int = -1       # snapshot/clone/discard target (trace-local index)
    off: int = 0        # discard span
    nbytes: int = 0
    arg: float = 0.0    # straggler latency / drop rate


def schedule_chaos(chaos_seed: int, cfg: ChaosConfig, *, n_ops: int,
                   n_replicas: int, n_volumes: int,
                   capacity: int = 0) -> List[ChaosEvent]:
    """Generate the event list for one run (module docstring). Sorted by
    ``index``; deterministic in every argument."""
    rng = np.random.default_rng(chaos_seed)
    weights = dict(DEFAULT_WEIGHTS)
    weights.update(dict(cfg.weights))
    if n_replicas < 2:      # no replica to lose -> no replica-fault events
        for a in ("fail", "rebuild", "quorum_loss", "recover"):
            weights[a] = 0.0
    actions = [a for a, w in weights.items() if w > 0]
    w = np.asarray([weights[a] for a in actions], np.float64)
    w /= w.sum()
    n_events = min(cfg.n_events, max(n_ops - 1, 1))
    indices = np.sort(rng.choice(np.arange(1, n_ops), size=n_events,
                                 replace=n_events >= n_ops - 1))
    healthy = [True] * n_replicas       # simulated controller health view
    events: List[ChaosEvent] = []
    for idx in indices:
        action = actions[int(rng.choice(len(actions), p=w))]
        ev = None
        if action == "fail":
            up = [r for r, h in enumerate(healthy) if h]
            if len(up) > 1:
                r = int(up[int(rng.integers(len(up)))])
                healthy[r] = False
                ev = ChaosEvent(int(idx), "fail", replica=r)
        elif action == "rebuild":
            down = [r for r, h in enumerate(healthy) if not h]
            if down:
                r = int(down[int(rng.integers(len(down)))])
                healthy[r] = True
                ev = ChaosEvent(int(idx), "rebuild", replica=r)
        elif action == "quorum_loss":
            up = [r for r, h in enumerate(healthy) if h]
            if len(up) > 1:
                keep = int(up[int(rng.integers(len(up)))])
                for r in up:
                    healthy[r] = r == keep
                ev = ChaosEvent(int(idx), "quorum_loss", replica=keep)
        elif action == "recover":
            if not all(healthy):
                for r in range(n_replicas):
                    healthy[r] = True
                ev = ChaosEvent(int(idx), "recover")
        elif action in ("snapshot", "clone"):
            ev = ChaosEvent(int(idx), action,
                            vol=int(rng.integers(n_volumes)))
        elif action == "discard":
            off = int(rng.integers(max(capacity, 1)))
            nbytes = int(rng.integers(1, max(capacity // 4, 2)))
            ev = ChaosEvent(int(idx), "discard",
                            vol=int(rng.integers(n_volumes)), off=off,
                            nbytes=min(nbytes, max(capacity - off, 1)))
        elif action == "straggler":
            ev = ChaosEvent(int(idx), "straggler",
                            replica=int(rng.integers(n_replicas)),
                            arg=float(cfg.straggler_latency))
        elif action == "heal":
            ev = ChaosEvent(int(idx), "heal",
                            replica=int(rng.integers(n_replicas)))
        elif action == "drop_on":
            ev = ChaosEvent(int(idx), "drop_on",
                            replica=int(rng.integers(n_replicas)),
                            arg=float(cfg.drop_rate))
        elif action == "drop_off":
            ev = ChaosEvent(int(idx), "drop_off",
                            replica=int(rng.integers(n_replicas)))
        if ev is not None:
            events.append(ev)
    if cfg.crash_every > 0:
        # fixed-index crash points (trace-indexed pump boundaries), torn
        # tail on every second one; merged in index order with the rest
        for k, idx in enumerate(range(cfg.crash_every, n_ops,
                                      cfg.crash_every)):
            events.append(ChaosEvent(int(idx), "crash", arg=float(k % 2)))
        events.sort(key=lambda e: e.index)
    return events
