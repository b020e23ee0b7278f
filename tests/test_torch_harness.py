"""Port parity: the chaos harness (twin of tests/test_harness.py).

The port's ``repro_torch.harness`` against the JAX package's
``repro.harness``, on the CPU (``device="cpu"``: the DBS kernel wrappers
run their plain versions; the JAX engines run as the JAX tests run them).

- **generators** — ``generate_trace`` and ``schedule_chaos`` (with
  ``crash_every``) give the reference's lists field by field for the same
  seeds; ``payload_bytes``, ``percentile``/``summarize``/``latency_lanes``
  and ``ByteOracle`` agree with the reference's on seeded inputs,
- **runs** — replay determinism, the straggler tail gate, the four
  hand-crafted chaos edge cases and the hung-future check run on the port
  as the reference's tests run them, and each also gives the reference's
  digest (sha1 over per-op completion ticks, the verification read-back
  bytes and per-link retransmits) and applied/skipped event lists,
- **the CLI** — ``python -m repro_torch.harness`` writes the reference's
  document for the same arguments, timings aside,
- **the device rule** — ``run()`` with no ``device`` targets the card and
  raises where there is none; the package imports no JAX.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import harness as J  # noqa: E402
from repro.harness import __main__ as J_cli  # noqa: E402
from repro.harness import oracle as J_oracle  # noqa: E402
from repro.harness import runner as J_runner  # noqa: E402
from repro.harness import stats as J_stats  # noqa: E402
from repro.harness import traces as J_traces  # noqa: E402
from repro_torch import harness as T  # noqa: E402
from repro_torch.harness import __main__ as T_cli  # noqa: E402
from repro_torch.harness import oracle as T_oracle  # noqa: E402
from repro_torch.harness import runner as T_runner  # noqa: E402
from repro_torch.harness import stats as T_stats  # noqa: E402
from repro_torch.harness import traces as T_traces  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GEO = dict(block_bytes=16, page_blocks=4, n_pages=32)   # capacity 2048 B
CAP = GEO["n_pages"] * GEO["page_blocks"] * GEO["block_bytes"]
# the result fields a port run must share with the reference's (wall_s
# aside: it is host time)
SAME = ("digest", "completion_ticks", "completed", "checked_reads",
        "compute_checked", "crashes", "events_applied", "events_skipped",
        "oracle_failures", "harness_failures", "latency", "wait", "counters")


def _fields(items):
    return [dataclasses.astuple(x) for x in items]


def assert_same_run(port, ref):
    """Every deterministic field of two ``HarnessResult``s equal."""
    for name in SAME:
        assert getattr(port, name) == getattr(ref, name), name


# ---------------------------------------------------------------------------
# generators (no engine)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,cfg,geo", [
    (7, dict(n_ops=64, unaligned_frac=0.2), GEO),
    (0, dict(), GEO),
    (5, dict(n_ops=120, n_volumes=6, read_frac=0.25, seq_frac=0.9,
             unaligned_frac=0.0, zipf_a=1.2), GEO),
    (3, dict(n_ops=90, mean_burst=1, read_frac=0.75, zipf_a=0.0),
     dict(block_bytes=4096, page_blocks=32, n_pages=64)),
])
def test_trace_generator_matches_reference(seed, cfg, geo):
    port = T_traces.generate_trace(seed, T.TraceConfig(**cfg), **geo)
    ref = J_traces.generate_trace(seed, J.TraceConfig(**cfg), **geo)
    assert _fields(port) == _fields(ref)
    assert port == T_traces.generate_trace(seed, T.TraceConfig(**cfg), **geo)
    assert port != T_traces.generate_trace(seed + 1, T.TraceConfig(**cfg),
                                           **geo)
    cap = geo["n_pages"] * geo["page_blocks"] * geo["block_bytes"]
    for op in port:
        assert op.kind in ("read", "write")
        assert 0 <= op.off and op.off + op.nbytes <= cap and op.nbytes > 0
    assert port[-1].last_in_burst


@pytest.mark.parametrize("seed,cfg,kw", [
    (3, dict(n_events=12), dict(n_ops=100, n_replicas=3, n_volumes=4,
                                capacity=2048)),
    (9, dict(n_events=10), dict(n_ops=200, n_replicas=3, n_volumes=4,
                                capacity=2048)),
    (0, dict(n_events=8, weights=(("clone", 3.0), ("straggler", 0.0))),
     dict(n_ops=160, n_replicas=2, n_volumes=6, capacity=2048)),
    (1, dict(n_events=6, crash_every=40,
             weights=tuple((a, 0.0) for a in ("fail", "rebuild",
                                                 "quorum_loss", "recover"))),
     dict(n_ops=160, n_replicas=2, n_volumes=4, capacity=2048)),
    (4, dict(n_events=30, crash_every=7), dict(n_ops=40, n_replicas=3,
                                               n_volumes=2, capacity=512)),
])
def test_chaos_schedule_matches_reference(seed, cfg, kw):
    port = T.schedule_chaos(seed, T.ChaosConfig(**cfg), **kw)
    ref = J.schedule_chaos(seed, J.ChaosConfig(**cfg), **kw)
    assert _fields(port) == _fields(ref)
    assert port == T.schedule_chaos(seed, T.ChaosConfig(**cfg), **kw)
    assert port != T.schedule_chaos(seed + 1, T.ChaosConfig(**cfg), **kw)
    assert all(1 <= ev.index < kw["n_ops"] for ev in port)
    assert [ev.index for ev in port] == sorted(ev.index for ev in port)
    crashes = [ev for ev in port if ev.action == "crash"]
    if cfg.get("crash_every"):
        assert [ev.arg for ev in crashes] == [
            float(k % 2) for k in range(len(crashes))]
        assert len(crashes) == len(range(cfg["crash_every"], kw["n_ops"],
                                         cfg["crash_every"]))
    else:
        assert not crashes


def test_chaos_schedule_no_replica_faults_single_replica():
    kw = dict(n_ops=64, n_replicas=1, n_volumes=2, capacity=2048)
    port = T.schedule_chaos(0, T.ChaosConfig(n_events=16), **kw)
    assert _fields(port) == _fields(
        J.schedule_chaos(0, J.ChaosConfig(n_events=16), **kw))
    assert all(ev.action not in ("fail", "rebuild", "quorum_loss",
                                 "recover") for ev in port)


def test_payload_bytes_and_stats_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(32):
        seed, index = (int(x) for x in rng.integers(0, 10 ** 6, 2))
        n = int(rng.integers(0, 600))
        assert (T_traces.payload_bytes(seed, index, n)
                == J_traces.payload_bytes(seed, index, n))
    assert T_traces.payload_bytes(3, 4, 0) == b""
    for n in (0, 1, 2, 7, 99, 100, 101, 999, 1000, 1001, 2500):
        vals = [float(x) for x in rng.integers(0, 50, n)]
        for q in (0, 1, 50, 99, 99.9, 100):
            assert T_stats.percentile(vals, q) == J_stats.percentile(vals, q)
        assert T_stats.summarize(vals) == J_stats.summarize(vals)
    lanes = {"read": [float(x) for x in rng.integers(1, 9, 40)],
             "write": [float(x) for x in rng.integers(1, 30, 61)]}
    assert T_stats.latency_lanes(lanes) == J_stats.latency_lanes(lanes)
    assert T_stats.latency_lanes({"read": [], "write": []}) == \
        J_stats.latency_lanes({"read": [], "write": []})
    assert T_traces.zipf_weights(9, 1.1).tolist() == \
        J_traces.zipf_weights(9, 1.1).tolist()


def test_byte_oracle_matches_reference():
    """One seeded op sequence through both oracles: the same shadows, the
    same comparison verdicts and failure strings, and the same raise."""
    rng = np.random.default_rng(1)
    oracles = (T_oracle.ByteOracle(256), J_oracle.ByteOracle(256))
    for o in oracles:
        o.add_volume(0)
        o.add_volume(3)
    for i in range(200):
        kind = int(rng.integers(0, 5))
        vid = (0, 3)[int(rng.integers(0, 2))]
        off = int(rng.integers(0, 256))
        n = int(rng.integers(0, 256 - off + 1))
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        verdicts = []
        for o in oracles:
            if kind == 0:
                o.write(vid, off, data)
            elif kind == 1:
                o.discard(vid, off, n)
            elif kind == 2:
                got = o.expected(vid, off, n)
                if i % 3 == 0 and n:          # corrupt one byte
                    got = got[:-1] + bytes([(got[-1] + 1) % 256])
                verdicts.append(o.check(got, o.expected(vid, off, n),
                                        f"op {i}"))
            elif kind == 3 and i % 40 == 0:
                o.clone(vid, 7)
            elif kind == 4 and 7 in o.shadow and i % 50 == 0:
                o.delete(7)
        assert len(set(verdicts)) <= 1
    port, ref = oracles
    assert port.shadow == ref.shadow
    assert port.failures == ref.failures and port.failures
    assert port.checked_reads == ref.checked_reads and not port.ok
    with pytest.raises(T_oracle.OracleMismatch) as e_port:
        port.raise_if_failed()
    with pytest.raises(J_oracle.OracleMismatch) as e_ref:
        ref.raise_if_failed()
    assert str(e_port.value) == str(e_ref.value)
    clean = T_oracle.ByteOracle(16)
    clean.raise_if_failed()
    assert clean.ok


def test_storage_function_mirrors_match_reference():
    """The mirrors ``submit_compute`` checks COMPUTE results against: the
    port's (numpy over each page of a range) against the reference's
    per-byte loops, on seeded shadows with zero, sparse and dense pages."""
    from repro.compute import make_storage_fn as j_fn
    from repro_torch.compute import make_storage_fn as t_fn
    rng = np.random.default_rng(2)
    for pb, bb, n_pages in ((64, 16, 8), (256, 32, 6)):
        shadow = bytearray(rng.integers(0, 256, pb * n_pages, np.uint8))
        shadow[:pb] = bytes(pb)                           # a hole page
        shadow[2 * pb:3 * pb] = bytes(pb)
        shadow[2 * pb + 5] = 77                           # one byte set
        for fn in ("checksum", "scan_count", "filter_pages"):
            for page, count in ((0, n_pages), (1, 3), (2, 1), (n_pages - 1,
                                                              5), (0, 0)):
                for arg in (-1, 0, 77, 77 + 256, int(shadow[-1])):
                    got = t_fn(fn).mirror(bytearray(shadow), pb, bb, page,
                                          count, arg, None)
                    want = j_fn(fn).mirror(bytearray(shadow), pb, bb, page,
                                           count, arg, None)
                    assert got == want, (fn, page, count, arg)


# ---------------------------------------------------------------------------
# replay determinism (simnet seed threading)
# ---------------------------------------------------------------------------
def test_replay_determinism_chaos_simnet():
    """Identical ``(trace_seed, chaos_seed, transport_opts)`` must replay
    byte-identically on the port — and to the reference's run."""
    a = T_runner.run_scenario("chaos/simnet", trace_seed=5, chaos_seed=9,
                              n_ops=60, device="cpu")
    b = T_runner.run_scenario("chaos/simnet", trace_seed=5, chaos_seed=9,
                              n_ops=60, device="cpu")
    assert a.ok, a.oracle_failures + a.harness_failures
    assert a.completion_ticks == b.completion_ticks
    assert a.digest == b.digest
    assert a.events_applied == b.events_applied
    assert a.events_skipped == b.events_skipped
    assert a.counters == b.counters
    ref = J_runner.run_scenario("chaos/simnet", trace_seed=5, chaos_seed=9,
                                n_ops=60)
    assert_same_run(a, ref)


# ---------------------------------------------------------------------------
# tail-latency invariant (the straggler gate)
# ---------------------------------------------------------------------------
def test_straggler_latency_policy_beats_rr_p99():
    rr = T_runner.run_scenario("straggler/rr", trace_seed=3, chaos_seed=0,
                               n_ops=120, device="cpu")
    lat = T_runner.run_scenario("straggler/latency", trace_seed=3,
                                chaos_seed=0, n_ops=120, device="cpu")
    assert rr.ok and lat.ok
    rr_p99 = rr.wait["read"]["p99"]
    lat_p99 = lat.wait["read"]["p99"]
    assert rr.wait["read"]["count"] > 50          # singleton bursts landed
    assert lat_p99 < rr_p99, \
        f"latency-weighted P99 {lat_p99} must beat rr {rr_p99} wait ticks"
    assert lat_p99 <= T_runner.P99_BOUND
    assert lat.wait["read"]["p999"] <= T_runner.P999_BOUND
    assert (T_runner.P99_BOUND, T_runner.P999_BOUND) == (
        J_runner.P99_BOUND, J_runner.P999_BOUND)
    for name, port in (("straggler/rr", rr), ("straggler/latency", lat)):
        assert_same_run(port, J_runner.run_scenario(
            name, trace_seed=3, chaos_seed=0, n_ops=120))


# ---------------------------------------------------------------------------
# chaos edge cases (hand-crafted schedules)
# ---------------------------------------------------------------------------
def _writes(pkg, indices, vol=0, stride=64, nbytes=32, flush_at=()):
    """Block-aligned writes walking the volume; flush only at ``flush_at``
    (everything else stays in one open burst so chaos events race
    genuinely in-flight traffic)."""
    return [pkg.TraceOp(index=i, kind="write", vol=vol,
                        off=(i * stride) % (CAP - nbytes), nbytes=nbytes,
                        last_in_burst=(i in flush_at))
            for i in indices]


def _run_edge(events, *, write_policy="async", n_ops=20):
    """The edge case on the port and on the reference; both returned."""
    out = []
    for pkg, kw in ((T, dict(device="cpu")), (J, {})):
        ops = _writes(pkg, range(n_ops), flush_at={n_ops - 1})
        evs = [pkg.ChaosEvent(**dataclasses.asdict(e)) for e in events]
        out.append(pkg.run(
            trace_seed=11, chaos_seed=0, trace=pkg.TraceConfig(n_volumes=2),
            trace_ops=ops, chaos_events=evs, backend="slots", n_replicas=3,
            transport="simnet", write_policy=write_policy,
            transport_opts=dict(latency=3, window=64, seed=4), **kw))
    return out


def test_fail_then_rebuild_racing_inflight_write_behind():
    """Fail a replica mid-burst, then rebuild it while the survivors'
    write-behind traffic from the same burst is still on the links."""
    res, ref = _run_edge([T.ChaosEvent(5, "fail", replica=2),
                          T.ChaosEvent(12, "rebuild", replica=2)])
    assert res.ok, res.oracle_failures + res.harness_failures
    assert [e.split()[1] for e in res.events_applied] == ["fail", "rebuild"]
    assert_same_run(res, ref)


def test_quorum_loss_then_recovery():
    """Fail down to a single survivor under quorum writes, keep writing
    degraded, then recover with back-to-back delta rebuilds."""
    res, ref = _run_edge([T.ChaosEvent(6, "quorum_loss", replica=0),
                          T.ChaosEvent(14, "recover")],
                         write_policy="quorum")
    assert res.ok, res.oracle_failures + res.harness_failures
    kinds = [e.split()[1] for e in res.events_applied]
    assert kinds == ["quorum_loss", "recover"]
    assert_same_run(res, ref)


def test_unmap_and_clone_racing_rebuild_stream():
    """Discard and clone land between a fail and its rebuild; the clone's
    shadow must equal the source's at the (flushed) clone point and every
    replica must converge."""
    res, ref = _run_edge([T.ChaosEvent(4, "fail", replica=1),
                          T.ChaosEvent(8, "discard", vol=0, off=64,
                                       nbytes=256),
                          T.ChaosEvent(10, "clone", vol=0),
                          T.ChaosEvent(15, "rebuild", replica=1)])
    assert res.ok, res.oracle_failures + res.harness_failures
    kinds = [e.split()[1] for e in res.events_applied]
    assert kinds == ["fail", "discard", "clone", "rebuild"]
    assert res.checked_reads >= 2
    assert_same_run(res, ref)


def test_hung_future_is_reported_not_deadlocked():
    """A run over a healthy engine reports zero hung futures while having
    exercised the check on every burst."""
    kw = dict(trace_seed=2, chaos_seed=0, backend="slots", n_replicas=2,
              transport="local")
    res = T.run(trace=T.TraceConfig(n_ops=40, n_volumes=2, mean_burst=4),
                device="cpu", **kw)
    assert res.harness_failures == []
    assert res.completed > 0 and len(res.completion_ticks) == 40
    assert_same_run(res, J.run(
        trace=J.TraceConfig(n_ops=40, n_volumes=2, mean_burst=4), **kw))


# ---------------------------------------------------------------------------
# the CLI and the device rule
# ---------------------------------------------------------------------------
def test_cli_writes_the_reference_document(tmp_path):
    args = ["--smoke", "--check", "--scenario", "steady/local"]
    port_out, ref_out = tmp_path / "port.json", tmp_path / "ref.json"
    assert T_cli.main(args + ["--device", "cpu", "--out",
                              str(port_out)]) == 0
    assert J_cli.main(args + ["--out", str(ref_out)]) == 0
    port = json.loads(port_out.read_text())
    ref = json.loads(ref_out.read_text())
    assert list(port) == ["trace"] and list(port["trace"]) == ["steady/local"]
    doc, want = port["trace"]["steady/local"], ref["trace"]["steady/local"]
    assert sorted(doc) == sorted(want)
    for timing in ("wall_s", "ops_per_s"):
        doc.pop(timing)
        want.pop(timing)
    assert doc == want
    assert doc["oracle_ok"] and doc["n_ops"] == 120


def test_run_needs_the_card_unless_told_otherwise():
    """With no ``device`` a run targets the card: here, without one, it
    raises before any op runs. The package imports nothing of JAX."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            T.run(trace=T.TraceConfig(n_ops=4))
    code = ("import sys, repro_torch.harness, repro_torch.harness.__main__; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
