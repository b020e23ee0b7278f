"""The harness runner: replay a trace under a chaos schedule, check bytes.

Port of ``repro/harness/runner.py`` over the port's ``VolumeManager``.
``run()`` is THE entry point — the tests, the CLI (``python -m
repro_torch.harness``) and the card's smoke run all drive it, so every
consumer stresses the same engine code path: the public ``VolumeManager``
byte API over a registered backend, transport and write/read policy.
``run(device=...)`` picks the device (``None``: the card, with no CPU
fallback, as everywhere in the port); the same seeds give the same digest
on either device and in either package.

One run:

1. generate the op stream from ``(trace_seed, TraceConfig, geometry)`` and
   the event list from ``(chaos_seed, ChaosConfig)`` — or take both
   pre-built (the edge-case tests hand-craft ``ChaosEvent`` lists),
2. replay: submit each burst asynchronously, firing due chaos events
   before the op they are pinned to; flush at burst boundaries; check
   every read against the shadow oracle (expected bytes captured at
   submission — the API's ordering point) and assert **no hung
   ``IOFuture``** (every future a chaos run hands out must resolve),
3. verify: drain the transports (write-behind stragglers land), rebuild
   every still-failed replica, read every volume end-to-end through the
   normal path, then — on host-dispatch replica groups — force the read
   path onto EACH replica in turn (fail the others, read, rebuild) so a
   stale rebuilt copy cannot hide behind a healthy peer,
4. report: pump-tick latency percentiles, controller wait-tick tails,
   transport counters, and a replay ``digest`` (sha1 over per-op
   completion ticks, the verification read-back bytes and the retransmit
   counters) — two runs with identical seeds/config MUST produce identical
   digests, the determinism gate ``check_trace_gates`` enforces.

**Seed threading (replay determinism).** The harness owns the one seed
rule: on ``transport="simnet"`` it threads ``chaos_seed`` into the
transport's ``seed`` opt unless the caller pinned one, so the simulated
network's drop/reorder decisions replay with the run — identical
``(trace_seed, chaos_seed, transport_opts)`` is byte-identical end to end
(``tests/test_torch_harness.py::test_replay_determinism_chaos_simnet``).

``SCENARIOS`` is the named catalog ``run_matrix`` runs; adding a scenario
is adding one entry.
"""
from __future__ import annotations

import gc
import hashlib
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.blockdev import IOFuture, Volume, VolumeManager
from repro_torch.harness import stats
from repro_torch.harness.chaos import ChaosConfig, ChaosEvent, schedule_chaos
from repro_torch.harness.oracle import ByteOracle, OracleMismatch
from repro_torch.harness.traces import (TraceConfig, TraceOp, generate_trace,
                                  payload_bytes)

# default tiny geometry: big enough for multi-page spans and CoW pressure,
# small enough that the full-capacity per-replica verification reads stay
# cheap on a CPU smoke box
GEOMETRY = dict(block_bytes=16, page_blocks=4, n_pages=32, batch=16,
                n_extents=2048, max_volumes=12, n_queues=4, n_slots=256)


@dataclass
class HarnessResult:
    """Everything one run measured (module docstring, step 4)."""

    n_ops: int
    completed: int                      # engine SQE completions
    checked_reads: int
    oracle_failures: List[str]
    harness_failures: List[str]         # hung futures / bad statuses
    events_applied: List[str]
    events_skipped: List[str]
    completion_ticks: List[int]         # per trace op, in pump ticks
    latency: Dict[str, Any]             # pump-tick percentiles per kind
    wait: Dict[str, Any]                # wait-tick percentiles (1-op bursts)
    counters: Optional[Dict[str, Any]]  # transport counters (None w/o links)
    wall_s: float
    digest: str
    compute_checked: int = 0            # COMPUTE SQEs checked vs mirrors
    crashes: int = 0                    # crash-and-recover events applied

    @property
    def ok(self) -> bool:
        return not self.oracle_failures and not self.harness_failures

    def raise_if_failed(self) -> None:
        if not self.ok:
            raise OracleMismatch(
                "harness run failed:\n  "
                + "\n  ".join((self.oracle_failures
                               + self.harness_failures)[:20]))

    def to_dict(self) -> Dict[str, Any]:
        """The ``trace``-document shape (compact: tick lists become the
        digest)."""
        return {
            "n_ops": self.n_ops, "completed": self.completed,
            "checked_reads": self.checked_reads,
            "compute_checked": self.compute_checked,
            "crashes": self.crashes,
            "oracle_ok": self.ok,
            "failures": (self.oracle_failures + self.harness_failures)[:5],
            "events_applied": len(self.events_applied),
            "events_skipped": len(self.events_skipped),
            "latency": self.latency, "wait": self.wait,
            "counters": self.counters, "wall_s": self.wall_s,
            "ops_per_s": (self.n_ops / self.wall_s if self.wall_s else 0.0),
            "digest": self.digest,
        }


def _healthy_replicas(storage) -> Optional[List[int]]:
    """Indices of healthy replicas when the storage is a host-dispatch
    ``ReplicaGroup`` (the plane replica-level chaos targets); None on
    backends whose health lives elsewhere (sharded masks — see
    ``_Run.sharded`` — or no replicas at all)."""
    reps = getattr(storage, "replicas", None)
    if reps is None:
        return None
    return [i for i, r in enumerate(reps) if r.healthy]


class _Run:
    """One harness execution's mutable state (``run()`` drives it)."""

    def __init__(self, mgr: VolumeManager, oracle: ByteOracle,
                 trace_seed: int, journal_path: Optional[str] = None,
                 mgr_kwargs: Optional[Dict[str, Any]] = None):
        self.mgr = mgr
        self.oracle = oracle
        self.trace_seed = trace_seed
        self.journal_path = journal_path    # crash events need the WAL...
        self.mgr_kwargs = mgr_kwargs or {}  # ...and the geometry to recover
        self.crashes = 0
        self.storage = mgr.engine.backend
        # sharded replica plane: health is a dense (S, R) mask, not a list
        # of Replica objects — replica chaos mirrors each verb across ALL
        # shards so the S slices stay in lock-step. Gated strictly on
        # comm="sharded": the ring backend stacks the same storage but
        # serves control in-band, and its scenario digest must not move.
        self.sharded = mgr.engine.cfg.comm == "sharded"
        self.vols: List[Volume] = []
        self.clones: List[Volume] = []
        # (op-or-None, future, expected-bytes-or-None) awaiting the flush
        self.pending: List[Tuple[Optional[TraceOp], IOFuture,
                                 Optional[bytes]]] = []
        # (context, future, expected (value, status, aux)) COMPUTE calls
        self.pending_compute: List[Tuple[str, IOFuture, tuple]] = []
        self.compute_checked = 0
        self._n_comp = 0
        self.latency: Dict[str, List[float]] = {"read": [], "write": []}
        self.wait: Dict[str, List[float]] = {"read": [], "write": []}
        self.completion_ticks: List[int] = []
        self.harness_failures: List[str] = []
        self.applied: List[str] = []
        self.skipped: List[str] = []
        self._base_latency: Dict[int, int] = {}
        self._base_drop: Dict[int, float] = {}

    # -- chaos event application (guarded; a skip replays as a skip) --------
    def _simnet_link(self, replica: int):
        ts = getattr(self.storage, "transports", None)
        if ts is None or not 0 <= replica < len(ts):
            return None
        t = ts[replica]
        return t if hasattr(t, "latency") else None   # simnet links only

    def _sharded_repl_event(self, ev: ChaosEvent) -> bool:
        """Apply one replica-plane event across every shard of a sharded
        group (all-shard mirror keeps health uniform). Returns True when
        the event applied, False for a deterministic skip."""
        ctl = self.mgr.engine.control
        g = self.storage
        S, R = g.n_shards, g.n_replicas
        h = g.healthy                                   # (S, R) bool
        if ev.action == "fail":
            if (not 0 <= ev.replica < R
                    or not bool(h[:, ev.replica].all())
                    or int(h.sum(axis=1).min()) < 2):
                return False
            for s in range(S):
                ctl("fail", shard=s, replica=ev.replica)
        elif ev.action == "rebuild":
            if not 0 <= ev.replica < R or bool(h[:, ev.replica].any()):
                return False
            for s in range(S):
                ctl("rebuild", shard=s, replica=ev.replica)
        elif ev.action == "quorum_loss":
            up = [r for r in range(R) if bool(h[:, r].all())]
            if len(up) < 2:
                return False
            keep = ev.replica if ev.replica in up else up[0]
            for r in up:
                if r != keep:
                    for s in range(S):
                        ctl("fail", shard=s, replica=r)
        else:                                           # recover
            if bool(h.all()):
                return False
            for s in range(S):
                for r in range(R):
                    if not h[s, r]:
                        ctl("rebuild", shard=s, replica=r)
        return True

    def _crash(self, torn: bool) -> None:
        """Kill the engine at a pump boundary and recover it from the WAL.

        The crash point is a pump boundary by construction: every pending
        future is flushed and checked first (exactly the state the journal's
        last seal covers), then the journal is fsynced and the manager is
        ABANDONED — never closed, like a dead process. With ``torn`` a
        half-written record is appended to the journal file first (a crash
        mid-group-commit), which recovery must detect and truncate. The
        recovered manager, storage and volume handles replace the dead
        ones and the trace keeps replaying into them; a recovery that
        diverges (``RecoveryError`` / id mismatch) aborts the run — unlike
        guarded chaos verbs, a bad recovery must never replay as a skip."""
        from repro_torch.core.transport import MSG_WRITE, WireMsg
        from repro_torch.durability.journal import encode_record
        from repro_torch.durability.recovery import recover
        import numpy as np
        self.flush_burst(None)                  # settle + check in-flight
        self.mgr.flush(durable=True)            # seal + fsync the WAL
        dead, jpath = self.mgr, self.journal_path
        if torn:
            rec = encode_record(10 ** 9, WireMsg(
                op=MSG_WRITE, volume=0,
                pages=np.asarray([0], np.int32),
                blocks=np.asarray([0], np.int32),
                payload=np.zeros((1, 4), np.float32)))
            with open(jpath, "ab") as f:        # crash mid-append: half a
                f.write(rec[:len(rec) // 2])    # record past the last seal
        del dead                                # abandoned, not closed
        new = recover(jpath, **self.mgr_kwargs)
        self.mgr = new
        self.storage = new.engine.backend
        self.vols = [new.open(v.vid) for v in self.vols]
        self.clones = [new.open(v.vid) for v in self.clones]
        self.crashes += 1
        # a dead process's memory is freed with it: collect the abandoned
        # manager (its reference cycles hold its device pools), so two
        # managers' pools coexist only during a recovery
        gc.collect()

    def apply_event(self, ev: ChaosEvent) -> None:
        name = f"@{ev.index} {ev.action}"
        if ev.action == "crash":
            if self.journal_path is None:
                self.skipped.append(name + " (no journal)")
                return
            torn = ev.arg >= 1.0
            self._crash(torn)
            self.applied.append(name + (" torn" if torn else ""))
            return
        ctl = self.mgr.engine.control
        healthy = _healthy_replicas(self.storage)
        try:
            if ev.action in ("fail", "rebuild", "quorum_loss", "recover"):
                if healthy is None:
                    if self.sharded:
                        if self._sharded_repl_event(ev):
                            self.applied.append(name)
                        else:
                            self.skipped.append(name)
                        return
                    self.skipped.append(name + " (no replica plane)")
                    return
                if ev.action == "fail":
                    if ev.replica not in healthy or len(healthy) < 2:
                        self.skipped.append(name)
                        return
                    ctl("fail", replica=ev.replica)
                elif ev.action == "rebuild":
                    n = len(self.storage.replicas)
                    if ev.replica in healthy or not 0 <= ev.replica < n:
                        self.skipped.append(name)
                        return
                    ctl("rebuild", replica=ev.replica)
                elif ev.action == "quorum_loss":
                    keep = (ev.replica if ev.replica in healthy
                            else healthy[0])
                    for r in healthy:
                        if r != keep:
                            ctl("fail", replica=r)
                else:                                   # recover
                    n = len(self.storage.replicas)
                    for r in range(n):
                        if r not in healthy:
                            ctl("rebuild", replica=r)
            elif ev.action == "snapshot":
                self.mgr.snapshot(self.vols[ev.vol % len(self.vols)])
            elif ev.action == "clone":
                src = self.vols[ev.vol % len(self.vols)]
                child = self.mgr.clone(src)
                if child is None:                       # volume table full
                    self.skipped.append(name + " (table full)")
                    return
                self.oracle.clone(src.vid, child.vid)
                self.clones.append(child)
            elif ev.action == "discard":
                v = self.vols[ev.vol % len(self.vols)]
                fut = v.discard(ev.off, ev.nbytes)
                self.oracle.discard(v.vid, ev.off, ev.nbytes)
                self.pending.append((None, fut, None))
            elif ev.action in ("straggler", "heal", "drop_on", "drop_off"):
                link = self._simnet_link(ev.replica)
                if link is None:
                    self.skipped.append(name + " (no simnet link)")
                    return
                if ev.action == "straggler":
                    self._base_latency.setdefault(ev.replica, link.latency)
                    link.latency = max(int(ev.arg), 1)
                elif ev.action == "heal":
                    link.latency = self._base_latency.get(ev.replica,
                                                          link.latency)
                elif ev.action == "drop_on":
                    self._base_drop.setdefault(ev.replica, link.drop)
                    link.drop = float(ev.arg)
                else:
                    link.drop = self._base_drop.get(ev.replica, 0.0)
            else:
                self.skipped.append(name + " (unknown action)")
                return
        except (RuntimeError, ValueError, IndexError) as e:
            # a guarded-but-still-invalid event must replay as the same
            # deterministic skip, never abort the run
            self.skipped.append(name + f" ({e})")
            return
        self.applied.append(name)

    # -- burst replay -------------------------------------------------------
    def submit(self, op: TraceOp) -> None:
        v = self.vols[op.vol]
        if op.kind == "write":
            data = payload_bytes(self.trace_seed, op.index, op.nbytes)
            fut = v.pwrite(op.off, data)
            self.oracle.write(v.vid, op.off, data)
            self.pending.append((op, fut, None))
        else:
            expected = self.oracle.expected(v.vid, op.off, op.nbytes)
            fut = v.pread(op.off, op.nbytes)
            self.pending.append((op, fut, expected))

    # -- in-band compute mixing ---------------------------------------------
    # deterministic rotation through the built-ins: every ``compute_every``
    # trace ops one COMPUTE SQE rides the same volume's queue, its expected
    # (value, status, payload) captured at submission by running the
    # entry's pure-Python mirror against the byte-oracle shadow — the same
    # ordering point the read/write oracle uses. compare_and_write's mirror
    # mutates the shadow on match, so subsequent reads check against the
    # CAS-committed bytes.
    _FN_CYCLE = ("checksum", "scan_count", "filter_pages",
                 "verify_on_read", "compare_and_write")

    def submit_compute(self, op: TraceOp) -> None:
        from repro_torch.compute import make_storage_fn
        from repro_torch.compute.functions import py_blocksum, py_i32
        mgr = self.mgr
        i = self._n_comp
        self._n_comp += 1
        fn = self._FN_CYCLE[i % len(self._FN_CYCLE)]
        entry = make_storage_fn(fn)
        v = self.vols[op.vol]
        shadow = self.oracle.shadow[v.vid]
        pby, bb = mgr.page_bytes, mgr.block_bytes
        n_pages = mgr.capacity // pby
        arg, data = 0, None
        if entry.scope == "range":
            p0 = (i * 5 + self.trace_seed) % n_pages
            cnt = n_pages - p0
            off, nbytes = p0 * pby, cnt * pby
            page, count = p0, cnt
            if fn != "checksum":
                arg = -1 if i % 7 == 0 else (self.trace_seed * 31
                                             + i * 17) % 256
            expected = entry.mirror(shadow, pby, bb, page, count, arg, None)
        else:
            ab = (i * 13 + self.trace_seed) % (mgr.capacity // bb)
            off, nbytes = ab * bb, bb
            page, block = ab // mgr.page_blocks, ab % mgr.page_blocks
            cur = py_blocksum(shadow[off:off + bb])
            if fn == "compare_and_write":
                data = payload_bytes(self.trace_seed, 100_000 + i, bb)
                # alternate matching and stale expectations: both the
                # committed and the ST_MISMATCH path replay under chaos
                arg = cur if i % 2 == 0 else py_i32((cur + 1) & 0xFFFFFFFF)
            else:                          # verify_on_read
                arg = cur if i % 2 == 0 else 0
            expected = entry.mirror(shadow, pby, bb, page, block, arg, data)
        fut = v.compute(fn, off, nbytes, arg=arg, data=data)
        self.pending_compute.append(
            (f"compute {fn}@{i} vol{v.vid}[{off}:{off + nbytes}]",
             fut, expected))

    def _check_computes(self) -> None:
        for ctx, fut, (e_val, e_stt, e_aux) in self.pending_compute:
            if not fut.done():
                self.harness_failures.append(
                    f"{ctx}: IOFuture hung after a full flush")
                continue
            try:
                res = fut.result()
            except OSError as e:
                self.harness_failures.append(f"{ctx}: {e}")
                continue
            self.compute_checked += 1
            if (res.value, res.status) != (int(e_val), int(e_stt)):
                self.oracle.failures.append(
                    f"{ctx}: (value, status) = ({res.value}, {res.status}), "
                    f"mirror expected ({int(e_val)}, {int(e_stt)})")
            elif e_aux is not None:
                got = (res.pages() if res.fn == "filter_pages"
                       else res.data())
                want = (list(e_aux) if res.fn == "filter_pages"
                        else bytes(e_aux))
                if got != want:
                    self.oracle.failures.append(
                        f"{ctx}: payload {got!r} != mirror {want!r}")
        self.pending_compute.clear()

    def flush_burst(self, wait_before: Optional[int]) -> None:
        self.mgr.flush()
        wait_after = stats.wait_ticks(self.storage)
        trace_ops = [p for p in self.pending if p[0] is not None]
        for op, fut, expected in self.pending:
            if not fut.done():
                self.harness_failures.append(
                    f"op {op.index if op else '(chaos)'}: IOFuture hung "
                    "after a full flush")
                continue
            try:
                val = fut.result()
            except OSError as e:
                self.harness_failures.append(
                    f"op {op.index if op else '(chaos)'}: {e}")
                continue
            if expected is not None and op is not None:
                v = self.vols[op.vol]
                self.oracle.check(
                    val, expected,
                    f"op {op.index} read vol{v.vid}[{op.off}:"
                    f"{op.off + op.nbytes}]")
            if op is not None:
                self.latency[op.kind].append(float(fut.latency()))
                self.completion_ticks.append(fut.completion_tick())
        if (wait_before is not None and wait_after is not None
                and len(trace_ops) == 1):
            # singleton burst: the controller wait-tick delta is THIS op's
            # (the clock the straggler tail gates are expressed in)
            self.wait[trace_ops[0][0].kind].append(
                float(wait_after - wait_before))
        self.pending.clear()
        if self.pending_compute:
            self._check_computes()

    # -- end-of-trace verification ------------------------------------------
    def verify(self) -> bytes:
        """Final oracle sweep (module docstring, step 3). Returns the
        concatenated read-back bytes (digest input)."""
        mgr, oracle = self.mgr, self.oracle
        mgr.flush()
        if hasattr(self.storage, "drain_transports"):
            self.storage.drain_transports()
        ctl = mgr.engine.control
        healthy = _healthy_replicas(self.storage)
        if healthy is not None:
            for r in range(len(self.storage.replicas)):
                if r not in healthy:
                    ctl("rebuild", replica=r)           # final rebuild
        elif self.sharded:
            h = self.storage.healthy
            for s in range(self.storage.n_shards):
                for r in range(self.storage.n_replicas):
                    if not h[s, r]:
                        ctl("rebuild", shard=s, replica=r)
        volumes = self.vols + self.clones
        blob = bytearray()

        def read_all(tag: str) -> None:
            for v in volumes:
                got = v.read(0, mgr.capacity)
                blob.extend(got)
                oracle.check(got, oracle.expected(v.vid, 0, mgr.capacity),
                             f"{tag} vol{v.vid}")

        read_all("end-of-trace")
        if healthy is not None:
            n = len(self.storage.replicas)
        elif self.sharded:
            n = self.storage.n_replicas
        else:
            n = 0
        if n > 1 and not mgr.engine.cfg.null_storage:
            # force the read path onto EACH surviving replica in turn
            # (every shard at once on the sharded plane)
            def repl_ctl(kind: str, r: int) -> None:
                if self.sharded:
                    for s in range(self.storage.n_shards):
                        ctl(kind, shard=s, replica=r)
                else:
                    ctl(kind, replica=r)

            for serve in range(n):
                others = [r for r in range(n) if r != serve]
                for r in others:
                    repl_ctl("fail", r)
                read_all(f"replica {serve}")
                for r in others:
                    repl_ctl("rebuild", r)
        return bytes(blob)


def run(*, trace_seed: int = 0, chaos_seed: int = 0,
        trace: Optional[TraceConfig] = None,
        chaos: Optional[ChaosConfig] = None,
        trace_ops: Optional[List[TraceOp]] = None,
        chaos_events: Optional[List[ChaosEvent]] = None,
        backend: str = "slots", n_replicas: int = 2, n_shards: int = 1,
        kernel: str = "auto", transport: str = "local",
        write_policy: str = "all", read_policy: str = "rr",
        transport_opts: Optional[Dict[str, Any]] = None,
        geometry: Optional[Dict[str, int]] = None,
        verify_replicas: bool = True, strict: bool = False,
        compute_every: int = 0, journal: bool = False,
        device: Any = None) -> HarnessResult:
    """One harness execution (module docstring). ``trace_ops`` /
    ``chaos_events`` bypass the generators (hand-crafted tests); otherwise
    both derive from the seeds. ``strict=True`` raises ``OracleMismatch``
    at the end instead of returning a failed result. ``compute_every=N``
    mixes one COMPUTE SQE (rotating through the built-in storage
    functions) into the stream every N trace ops, each checked against
    its pure-Python mirror over the oracle shadow; 0 (the default) leaves
    the stream — and the replay digest — untouched. ``journal=True``
    attaches a write-ahead journal (repro_torch/durability) in a temp dir —
    required by ``crash`` chaos events (``ChaosConfig.crash_every``),
    which abandon the manager mid-trace and recover it from the WAL.
    ``device`` goes to the manager and to every recovery (``None``: the
    card; it raises when there is none)."""
    trace = trace or TraceConfig()
    geo = dict(GEOMETRY)
    geo.update(geometry or {})
    if transport == "simnet":
        # THE seed rule: the simulated network's drop/reorder stream is part
        # of the replay identity — derive it from chaos_seed unless pinned
        transport_opts = dict(transport_opts or {})
        transport_opts.setdefault("seed", chaos_seed)
    mgr_kwargs = dict(
        backend=backend, n_shards=n_shards, n_replicas=n_replicas,
        payload_elems=geo["block_bytes"], page_blocks=geo["page_blocks"],
        max_pages=geo["n_pages"], n_extents=geo["n_extents"],
        max_volumes=geo["max_volumes"], n_queues=geo["n_queues"],
        n_slots=geo["n_slots"], batch=geo["batch"], kernel=kernel,
        transport=transport, write_policy=write_policy,
        read_policy=read_policy, transport_opts=transport_opts,
        device=device)
    jdir = journal_path = None
    if journal:
        jdir = tempfile.mkdtemp(prefix="repro-torch-harness-wal-")
        journal_path = os.path.join(jdir, "wal.dbsj")
    mgr = VolumeManager(journal=journal_path, **mgr_kwargs)
    oracle = ByteOracle(mgr.capacity)
    st = _Run(mgr, oracle, trace_seed, journal_path=journal_path,
              mgr_kwargs=mgr_kwargs)
    if trace_ops is None:
        trace_ops = generate_trace(
            trace_seed, trace, block_bytes=geo["block_bytes"],
            page_blocks=geo["page_blocks"], n_pages=geo["n_pages"])
    if chaos_events is None:
        chaos_events = [] if chaos is None else schedule_chaos(
            chaos_seed, chaos, n_ops=len(trace_ops) or 1,
            n_replicas=n_replicas, n_volumes=trace.n_volumes,
            capacity=mgr.capacity)
    by_index: Dict[int, List[ChaosEvent]] = {}
    for ev in chaos_events:
        by_index.setdefault(ev.index, []).append(ev)
    for _ in range(trace.n_volumes):
        oracle.add_volume(mgr.create().vid)
    st.vols = [mgr.open(vid) for vid in sorted(oracle.shadow)]
    del mgr             # st.mgr from here: a crash replaces it, and the
                        # dead one's pools must not outlive its recovery
    t0 = time.perf_counter()
    wait_before = stats.wait_ticks(st.storage)
    try:
        for op in trace_ops:
            for ev in by_index.pop(op.index, ()):
                st.apply_event(ev)
            st.submit(op)
            if compute_every and (op.index + 1) % compute_every == 0:
                st.submit_compute(op)
            if op.last_in_burst:
                st.flush_burst(wait_before)
                wait_before = stats.wait_ticks(st.storage)
        for idx in sorted(by_index):                    # post-trace events
            for ev in by_index[idx]:
                st.apply_event(ev)
        st.flush_burst(wait_before)
        blob = st.verify() if verify_replicas else b""
        counters = stats.transport_counters(st.storage)
        wall = time.perf_counter() - t0
        h = hashlib.sha1()
        h.update(b"ticks:" + ",".join(
            map(str, st.completion_ticks)).encode())
        h.update(b"|bytes:" + blob)
        if counters is not None:
            h.update(b"|retx:" + ",".join(
                map(str, counters["per_link_retransmits"])).encode())
        result = HarnessResult(
            n_ops=len(trace_ops), completed=st.mgr.engine.completed,
            checked_reads=oracle.checked_reads,
            compute_checked=st.compute_checked, crashes=st.crashes,
            oracle_failures=list(oracle.failures),
            harness_failures=st.harness_failures,
            events_applied=st.applied, events_skipped=st.skipped,
            completion_ticks=st.completion_ticks,
            latency=stats.latency_lanes(st.latency),
            wait=stats.latency_lanes(st.wait),
            counters=counters, wall_s=wall, digest=h.hexdigest())
    finally:
        st.mgr.close()          # a crash may have replaced the manager
        if jdir is not None:
            shutil.rmtree(jdir, ignore_errors=True)
    if strict:
        result.raise_if_failed()
    return result


# ---------------------------------------------------------------------------
# the scenario catalog (name -> run() kwargs; run_matrix sizes n_ops per
# mode)
# ---------------------------------------------------------------------------
_CTRL_ONLY = (("fail", 0.0), ("rebuild", 0.0), ("quorum_loss", 0.0),
              ("recover", 0.0), ("straggler", 0.0), ("heal", 0.0),
              ("drop_on", 0.0), ("drop_off", 0.0))

STRAGGLER_LATENCY = 8
_STRAGGLER = dict(
    backend="slots", n_replicas=3, transport="simnet",
    write_policy="quorum",
    trace=TraceConfig(n_ops=160, n_volumes=4, read_frac=0.75, seq_frac=0.3,
                      unaligned_frac=0.0, mean_burst=1),
    transport_opts=dict(latency=[1, 1, STRAGGLER_LATENCY], window=64),
    chaos=None)

SCENARIOS: Dict[str, Dict[str, Any]] = {
    # clean replay on the default transport: the oracle must hold with no
    # faults at all before chaos results mean anything
    "steady/local": dict(
        backend="slots", n_replicas=2, transport="local",
        trace=TraceConfig(n_ops=200, n_volumes=4, read_frac=0.4,
                          unaligned_frac=0.15),
        chaos=None),
    # the adversarial core: quorum writes over a lossy simulated network
    # with replica fails, quorum loss, rebuilds, link degradation and
    # mid-trace control ops
    "chaos/simnet": dict(
        backend="slots", n_replicas=3, transport="simnet",
        write_policy="quorum",
        trace=TraceConfig(n_ops=200, n_volumes=4, read_frac=0.4,
                          unaligned_frac=0.1),
        chaos=ChaosConfig(n_events=10),
        transport_opts=dict(latency=2, window=16, drop=0.05)),
    # write-behind: acked-at-post writes racing fails/rebuilds
    "chaos/async": dict(
        backend="slots", n_replicas=3, transport="simnet",
        write_policy="async",
        trace=TraceConfig(n_ops=160, n_volumes=4, read_frac=0.3),
        chaos=ChaosConfig(n_events=8),
        transport_opts=dict(latency=2, window=16)),
    # the in-program plane: snapshot/clone/discard chaos riding the ring's
    # in-band control path (replica chaos is host-dispatch-only)
    "control/ring": dict(
        backend="ring", n_shards=2, n_replicas=2,
        trace=TraceConfig(n_ops=160, n_volumes=4, read_frac=0.4,
                          unaligned_frac=0.1),
        chaos=ChaosConfig(n_events=8, weights=_CTRL_ONLY),
        verify_replicas=True),
    # the tail-latency pair: one straggler link, singleton bursts (per-op
    # wait ticks), rr vs latency-weighted reads — the P99/P999 gates
    "straggler/rr": dict(read_policy="rr", **_STRAGGLER),
    "straggler/latency": dict(read_policy="latency", **_STRAGGLER),
    # the serving shape: KV-append traffic over the sharded pool —
    # write-heavy, sequential, zipf-hot volumes (prompt-prefix sharing),
    # block-aligned like the decode scatter; clone-boosted chaos (session
    # fork) plus all-shard replica fail/rebuild mid-stream — a replica
    # dying mid-decode must not corrupt any session's bytes. Link actions
    # are zeroed (stacked endpoints ride the device transport, no simnet).
    "serve/steady": dict(
        backend="sharded", n_shards=2, n_replicas=2,
        trace=TraceConfig(n_ops=160, n_volumes=6, read_frac=0.25,
                          seq_frac=0.9, unaligned_frac=0.0, zipf_a=1.2),
        chaos=ChaosConfig(n_events=8,
                          weights=(("clone", 3.0), ("straggler", 0.0),
                                   ("heal", 0.0), ("drop_on", 0.0),
                                   ("drop_off", 0.0))),
        verify_replicas=True),
    # computational storage (repro_torch/compute): COMPUTE SQEs — rotating
    # through all five built-ins, including committed and mismatching
    # compare_and_write — mixed into ring traffic under snapshot/clone/
    # discard chaos, every result checked against the pure-Python mirror
    # over the oracle shadow at submission time
    "compute/steady": dict(
        backend="ring", n_shards=2, n_replicas=2,
        trace=TraceConfig(n_ops=160, n_volumes=4, read_frac=0.4,
                          unaligned_frac=0.1),
        chaos=ChaosConfig(n_events=8, weights=_CTRL_ONLY),
        compute_every=5, verify_replicas=True),
    # the durability plane (repro_torch/durability): a write-ahead journal
    # rides the run and the engine is KILLED at fixed pump boundaries (every
    # second crash first tears a half-written record onto the WAL tail),
    # recovered by journal replay, and the trace keeps going — snapshot/
    # clone/discard chaos and mutating COMPUTE SQEs ride along so replay
    # exercises the id-asserting control path and OP_COMPUTE records too.
    # The end-of-trace sweep proves every recovered volume byte-identical
    # to the shadow oracle. Replica and link actions are zeroed: recovery
    # rebuilds an all-healthy plane, so mid-trace health chaos would just
    # skip nondeterministically relative to the crash points.
    "crash/journal": dict(
        backend="slots", n_replicas=2, transport="local",
        trace=TraceConfig(n_ops=160, n_volumes=4, read_frac=0.4,
                          unaligned_frac=0.15),
        chaos=ChaosConfig(n_events=6, crash_every=40,
                          weights=(("fail", 0.0), ("rebuild", 0.0),
                                   ("quorum_loss", 0.0), ("recover", 0.0),
                                   ("straggler", 0.0), ("heal", 0.0),
                                   ("drop_on", 0.0), ("drop_off", 0.0))),
        journal=True, compute_every=8),
}

# the replay-determinism gate re-runs this scenario and compares digests
DETERMINISM_SCENARIO = "chaos/simnet"


def run_scenario(name: str, *, trace_seed: int = 0, chaos_seed: int = 0,
                 n_ops: Optional[int] = None, **overrides) -> HarnessResult:
    """Run one catalog scenario; ``n_ops`` rescales its trace (smoke)."""
    kw = dict(SCENARIOS[name])
    kw.update(overrides)
    if n_ops is not None:
        from dataclasses import replace
        kw["trace"] = replace(kw["trace"], n_ops=n_ops)
    return run(trace_seed=trace_seed, chaos_seed=chaos_seed, **kw)


def run_matrix(*, smoke: bool = True, trace_seed: int = 0,
               chaos_seed: int = 0,
               scenarios: Optional[List[str]] = None,
               device: Any = None) -> Dict[str, Any]:
    """Run the scenario matrix + the determinism replay — the ``trace``
    document (``check_trace_gates`` gates it), on ``device``."""
    names = scenarios or list(SCENARIOS)
    n_ops = 120 if smoke else None
    out: Dict[str, Any] = {}
    results: Dict[str, HarnessResult] = {}
    for name in names:
        res = run_scenario(name, trace_seed=trace_seed,
                           chaos_seed=chaos_seed, n_ops=n_ops,
                           device=device)
        results[name] = res
        out[name] = res.to_dict()
    if DETERMINISM_SCENARIO in results:
        first = results[DETERMINISM_SCENARIO]
        again = run_scenario(DETERMINISM_SCENARIO, trace_seed=trace_seed,
                             chaos_seed=chaos_seed, n_ops=n_ops,
                             device=device)
        out["determinism"] = {
            "scenario": DETERMINISM_SCENARIO,
            "digest_a": first.digest, "digest_b": again.digest,
            "ticks_match": first.completion_ticks == again.completion_ticks,
            "match": (first.digest == again.digest
                      and first.completion_ticks == again.completion_ticks),
        }
    return out


# straggler-scenario tail bounds, in controller wait ticks: the latency-
# weighted policy must keep P99 under half the straggler's link latency
# (it reads the fast links, ~1-2 ticks) and P999 inside 2x the straggler
# (a bounded worst case even while the ewma is still learning)
P99_BOUND = STRAGGLER_LATENCY / 2
P999_BOUND = 2 * STRAGGLER_LATENCY


def check_trace_gates(trace: Dict[str, Any]) -> List[str]:
    """The harness gates: every scenario's oracle
    clean, the determinism replay digest-identical, and the straggler
    tail bounded — latency-weighted reads beat rr at P99 and stay under
    ``P99_BOUND``/``P999_BOUND`` wait ticks."""
    problems = []
    for name, doc in trace.items():
        if name == "determinism":
            continue
        if not doc.get("oracle_ok", False):
            problems.append(
                f"trace {name}: oracle violations {doc.get('failures')}")
    det = trace.get("determinism")
    if det is not None and not det["match"]:
        problems.append(
            f"trace determinism: {det['scenario']} replayed to a different "
            f"digest ({det['digest_a'][:12]} vs {det['digest_b'][:12]}, "
            f"ticks_match={det['ticks_match']})")
    rr = trace.get("straggler/rr")
    lat = trace.get("straggler/latency")
    if rr is not None and lat is not None:
        rr_p99 = rr["wait"]["read"]["p99"]
        lat_p99 = lat["wait"]["read"]["p99"]
        lat_p999 = lat["wait"]["read"]["p999"]
        if lat_p99 >= rr_p99:
            problems.append(
                f"trace straggler: latency-weighted read P99 ({lat_p99:g} "
                f"wait ticks) does not beat rr ({rr_p99:g})")
        if lat_p99 > P99_BOUND:
            problems.append(
                f"trace straggler: latency-weighted read P99 {lat_p99:g} "
                f"wait ticks > bound {P99_BOUND:g}")
        if lat_p999 > P999_BOUND:
            problems.append(
                f"trace straggler: latency-weighted read P999 {lat_p999:g} "
                f"wait ticks > bound {P999_BOUND:g}")
    return problems
