"""Port parity: the chaos harness's scenario catalog, run by both packages.

Every ``SCENARIOS`` entry at ``n_ops=60``: the port's ``HarnessResult``
(``device="cpu"``) equals the JAX package's in its digest (sha1 over
per-op completion ticks, the verification read-back bytes and per-link
retransmits), completion ticks, checked reads and computes, crashes,
applied and skipped events, pump-tick and wait-tick summaries and
transport counters, and both are oracle-clean. Also the twins of
``tests/test_durability.py::test_harness_crash_scenario`` and
``tests/test_dbs_rw.py::test_harness_scenario_kernel_pallas`` (the ring
scenario on each of the port's kernel entries against the reference's
Pallas entry), and the extra ``run()`` calls the card's smoke run makes
(``fused`` on the ``cuda`` and ``copy`` entries, the ring at one shard) at
the catalog geometry.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.harness import runner as J  # noqa: E402
from repro_torch.harness import runner as T  # noqa: E402
from repro_torch.harness.chaos import ChaosConfig  # noqa: E402

SAME = ("digest", "completion_ticks", "completed", "checked_reads",
        "compute_checked", "crashes", "events_applied", "events_skipped",
        "oracle_failures", "harness_failures", "latency", "wait", "counters")
N_OPS = 60
# the port's DBS kernel entries and the reference's counterpart of each
JAX_KERNEL = {"cuda": "pallas", "torch": "xla", "ref": "ref", "copy": "copy"}
_LINKS_OFF = (("straggler", 0.0), ("heal", 0.0), ("drop_on", 0.0),
              ("drop_off", 0.0))
# the chip run's extra run() calls: the chaos/simnet trace with ten events,
# the link actions zeroed (these backends have no simnet links)
EXTRA = {
    "fused-cuda": dict(backend="fused", kernel="cuda"),
    "fused-copy": dict(backend="fused", kernel="copy"),
    "ring-s1": dict(backend="ring", n_shards=1, kernel="auto"),
}


def extra_kwargs(case):
    """``run()`` arguments of one extra case (the chip run's too)."""
    return dict(trace=T.SCENARIOS["chaos/simnet"]["trace"],
                chaos=ChaosConfig(n_events=10, weights=_LINKS_OFF),
                n_replicas=3, **EXTRA[case])


def assert_same_run(port, ref):
    assert port.ok, port.oracle_failures + port.harness_failures
    assert ref.ok, ref.oracle_failures + ref.harness_failures
    for name in SAME:
        assert getattr(port, name) == getattr(ref, name), name


@pytest.fixture(scope="module")
def ring_pallas():
    """The reference's ``control/ring`` run on its Pallas entry, shared by
    the four kernel-entry cases."""
    return J.run_scenario("control/ring", n_ops=N_OPS, kernel="pallas")


def test_catalogs_agree():
    assert list(T.SCENARIOS) == list(J.SCENARIOS)
    assert T.DETERMINISM_SCENARIO == J.DETERMINISM_SCENARIO
    assert T.GEOMETRY == J.GEOMETRY
    for name, kw in T.SCENARIOS.items():
        ref = J.SCENARIOS[name]
        assert sorted(kw) == sorted(ref), name
        for k, v in kw.items():
            if k in ("trace", "chaos"):
                assert repr(v) == repr(ref[k]), (name, k)
            else:
                assert v == ref[k], (name, k)


@pytest.mark.parametrize("name", list(J.SCENARIOS))
def test_scenario_matches_reference(name):
    port = T.run_scenario(name, n_ops=N_OPS, device="cpu")
    assert_same_run(port, J.run_scenario(name, n_ops=N_OPS))
    assert port.checked_reads > 0 and len(port.completion_ticks) == N_OPS


def test_harness_crash_scenario():
    """The crash/journal scenario: killed at fixed pump boundaries (one
    torn), recovered from the port's journal, oracle sweep clean — and the
    reference's run for the same seeds."""
    res = T.run_scenario("crash/journal", n_ops=80, device="cpu")
    res.raise_if_failed()
    assert res.crashes == 1
    assert any("crash" in e for e in res.events_applied)
    assert_same_run(res, J.run_scenario("crash/journal", n_ops=80))


@pytest.mark.parametrize("kernel", list(JAX_KERNEL))
def test_harness_scenario_kernel_entries(kernel, ring_pallas):
    """The ring scenario on each of the port's kernel entries (on the CPU
    each runs its plain version) gives the reference's Pallas run."""
    res = T.run_scenario("control/ring", n_ops=N_OPS, kernel=kernel,
                         device="cpu")
    res.raise_if_failed()
    assert res.checked_reads > 0
    assert_same_run(res, ring_pallas)


@pytest.mark.parametrize("case", list(EXTRA))
def test_extra_runs_match_reference(case):
    kw = extra_kwargs(case)
    port = T.run(device="cpu", **kw)
    kw["chaos"] = J.ChaosConfig(n_events=10, weights=_LINKS_OFF)
    kw["trace"] = J.SCENARIOS["chaos/simnet"]["trace"]
    if kw["kernel"] in JAX_KERNEL:
        kw["kernel"] = JAX_KERNEL[kw["kernel"]]
    assert_same_run(port, J.run(**kw))
    assert port.checked_reads > 0 and port.events_applied
