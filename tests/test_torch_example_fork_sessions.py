"""Twin of ``examples/fork_sessions.py``: the reference example as a user
runs it (JAX on the CPU) against ``repro_torch.examples.fork_sessions``
on ``device="cpu"`` with the reference's weights: the parent's tokens
after 4 steps and at the end (the serving twins' top-2 margin rule), each
fork a prefix of its parent in both, the fork volumes, and the DBS stats
before the forks, after them and at the end."""
import re

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro_torch.examples import fork_sessions  # noqa: E402
from torch_example_twins import (assert_tokens_match,  # noqa: E402
                                 literal_after, parsed, run_reference)

FORK = r"^fork (\d+): (\[[^\]]*\])"


def _forked(lines):
    line = next(x for x in lines if x.startswith("forked twice"))
    return re.search(r"\(volumes (\d+), (\d+)\).*snapshots: (\d+)",
                     line).groups()


def test_fork_sessions_matches_reference():
    want = run_reference("fork_sessions.py")
    assert want[-1] == "fork_sessions OK"
    params = jax.device_get(j_init(jax.random.PRNGKey(0),
                                   j_smoke("granite-3-8b")))
    got = fork_sessions.main(["--device", "cpu"], params=params,
                             record_logits=True)
    lines = got["lines"]
    assert lines[-1] == "fork_sessions OK"
    parent = literal_after(want, "parent:")
    assert literal_after(lines, "parent:") == got["outs"][0]
    assert_tokens_match({0: got["outs"][0]}, {0: parent}, got["logits"])
    assert literal_after(lines, "parent after 4 steps:") == \
        literal_after(want, "parent after 4 steps:")
    ref_forks, forks = parsed(want, FORK), parsed(lines, FORK)
    assert sorted(ref_forks) == sorted(forks) == [1, 2]
    for rid in (1, 2):
        assert ref_forks[rid] == parent[:len(ref_forks[rid])]
        assert forks[rid] == got["outs"][0][:len(forks[rid])]
        assert len(forks[rid]) == len(ref_forks[rid])
    assert _forked(lines) == _forked(want)
    for prefix in ("DBS:", "final DBS:"):
        assert literal_after(lines, prefix) == literal_after(want, prefix)
    assert got["dbs"] == literal_after(want, "final DBS:")
