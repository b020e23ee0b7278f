"""Twin of ``examples/quickstart.py``: the reference example as a user
runs it (JAX on the CPU) against ``repro_torch.examples.quickstart`` on
``device="cpu"``, its trainer started from the reference's weights: the
first and last training losses as printed (3 decimals: within half a unit
of the last place, plus fp32's drift over 15 steps), the step resumed
from the replicated checkpoint, and the tokens served from the resumed
params (the serving twins' top-2 margin rule)."""
import re

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from torch_example_twins import (assert_tokens_match,  # noqa: E402
                                 parsed, run_reference)

REQ = r"^request (\d+): (\[.*\])"
LOSS = r"^loss: ([0-9.]+) -> ([0-9.]+) \((\d+) steps"
PRINTED = 5e-4 + 1e-4        # the printed rounding, then the drift


def _loss_line(lines):
    m = next(re.search(LOSS, x) for x in lines if re.search(LOSS, x))
    return float(m.group(1)), float(m.group(2)), int(m.group(3))


def test_quickstart_matches_reference():
    want = run_reference("quickstart.py")
    assert want[-1] == "quickstart OK"
    params = jax.device_get(j_init(jax.random.PRNGKey(0),
                                   j_smoke("granite-3-8b")))
    got = quickstart.main(["--device", "cpu"], params=params,
                          record_logits=True)
    lines = got["lines"]
    assert lines[-1] == "quickstart OK"
    first, last, steps = _loss_line(want)
    hist = got["history"]
    assert steps == len(hist) == got["resumed"] == quickstart.TRAIN_STEPS
    assert abs(hist[0]["loss"] - first) <= PRINTED
    assert abs(hist[-1]["loss"] - last) <= PRINTED
    assert _loss_line(lines)[2] == steps
    assert f"resumed at step {steps}" in want
    assert f"resumed at step {steps}" in lines
    ref_tokens = parsed(want, REQ)
    assert parsed(lines, REQ) == got["outs"]
    assert len(ref_tokens) == 3
    assert_tokens_match(got["outs"], ref_tokens, got["logits"])
