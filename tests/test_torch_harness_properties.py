"""Port parity, property test: random traces x random chaos schedules
(twin of tests/test_harness_properties.py; hypothesis).

The same five (transport, write_policy, read_policy) combos of the
host-dispatch ``slots`` plane and the same strategies as the reference's
test. Each drawn ``(trace_seed, chaos_seed, trace, chaos)`` runs through
the port's harness (``device="cpu"``) and the JAX package's: both must be
oracle-clean (every acked read returns the oracle's bytes, every replica
converges after the final rebuild, no ``IOFuture`` hangs) and give the
same digest, completion ticks and applied/skipped events. The draws are
derandomized, so every run tests the same examples.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="hypothesis not installed")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro import harness as J  # noqa: E402
from repro_torch import harness as T  # noqa: E402

COMBOS = [
    ("local", "all", "rr"),
    ("device", "all", "rr"),
    ("simnet", "all", "rr"),
    ("simnet", "quorum", "latency"),
    ("simnet", "async", "rr"),
]

_SHAPE = dict(
    n_ops=st.integers(10, 28),
    n_volumes=st.integers(1, 3),
    read_frac=st.sampled_from([0.0, 0.3, 0.6]),
    seq_frac=st.sampled_from([0.0, 0.5]),
    unaligned_frac=st.sampled_from([0.0, 0.25]),
    mean_burst=st.integers(1, 6),
)


@pytest.mark.parametrize("transport,write_policy,read_policy", COMBOS)
@settings(max_examples=4, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture,
                                 HealthCheck.too_slow])
@given(trace_seed=st.integers(0, 2**16), chaos_seed=st.integers(0, 2**16),
       shape=st.fixed_dictionaries(_SHAPE), n_events=st.integers(0, 5))
def test_property_random_trace_random_chaos_matches_reference(
        transport, write_policy, read_policy, trace_seed, chaos_seed, shape,
        n_events):
    runs = []
    for pkg, kw in ((T, dict(device="cpu")), (J, {})):
        res = pkg.run(
            trace_seed=trace_seed, chaos_seed=chaos_seed,
            trace=pkg.TraceConfig(**shape),
            chaos=pkg.ChaosConfig(n_events=n_events), backend="slots",
            n_replicas=3, transport=transport, write_policy=write_policy,
            read_policy=read_policy,
            transport_opts=(dict(latency=2, window=16, drop=0.1)
                            if transport == "simnet" else None), **kw)
        assert res.ok, "\n".join(res.oracle_failures + res.harness_failures)
        assert len(res.completion_ticks) == shape["n_ops"]
        runs.append(res)
    port, ref = runs
    assert port.digest == ref.digest
    assert port.completion_ticks == ref.completion_ticks
    assert port.events_applied == ref.events_applied
    assert port.events_skipped == ref.events_skipped
    assert port.counters == ref.counters
