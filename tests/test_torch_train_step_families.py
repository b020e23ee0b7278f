"""Port parity: one train step at smoke width on the MoE, MLA, hybrid and
RWKV archs (granite-moe with its aux loss, deepseek-v3 with its MTP loss,
hymba, rwkv6-3b), the second half of test_torch_train_step.py's twin of
``test_forward_and_train_step``, with its checks and tolerances. hymba
and rwkv6-3b train at all because the Mamba scan builds new tensors under
autograd and the RWKV block no longer writes into forward's fresh state.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_step import (check_descends,  # noqa: E402
                                   check_gradients, reference_step)

ARCHS = ["deepseek-v3-671b", "granite-moe-3b-a800m", "hymba-1.5b",
         "rwkv6-3b"]


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return reference_step(request.param)


def test_gradients_match_reference(ref):
    check_gradients(ref)


def test_train_step_descends(ref):
    check_descends(ref)
