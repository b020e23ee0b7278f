"""Twin of ``examples/serve_paged.py``: the reference example as a user
runs it (JAX on the CPU) against ``repro_torch.examples.serve_paged`` on
``device="cpu"`` (the kernel wrappers run their plain versions) with the
reference's weights: every request's tokens (the serving twins' top-2
margin rule) and the DBS stats after the drain, no extent leaked."""
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro_torch.examples import serve_paged  # noqa: E402
from torch_example_twins import (assert_tokens_match,  # noqa: E402
                                 literal_after, parsed, run_reference)

REQ = r"^\s+req (\d+): (\[.*\])"


def test_serve_paged_matches_reference():
    want = run_reference("serve_paged.py")
    params = jax.device_get(j_init(jax.random.PRNGKey(0),
                                   j_smoke("gemma2-2b")))
    got = serve_paged.main(["--device", "cpu"], params=params,
                           record_logits=True)
    ref_tokens = parsed(want, REQ)
    assert len(ref_tokens) == serve_paged.N_REQUESTS
    assert parsed(got["lines"], REQ) == got["outs"]
    assert_tokens_match(got["outs"], ref_tokens, got["logits"])
    stats = literal_after(want, "DBS after drain:")
    assert got["dbs"] == stats and stats["extents_used"] == 0
    assert literal_after(got["lines"], "DBS after drain:") == stats


def test_serve_paged_needs_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve_paged.main([])
