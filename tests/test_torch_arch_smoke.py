"""Port parity: per-architecture smoke tests, the twin of
tests/test_arch_smoke.py, over every arch of ``configs/`` (deepseek-v3 with
its MLA layers and MTP head, musicgen with its four codebooks: tokens of
shape (B, S, 4), logits (B, 4, V)).

Each arch's reduced same-family config on the CPU: the port's ``forward``
(its own weights, drawn from a ``torch.Generator``) gives finite hidden
states of the right shape; on the reference's weights (crossed with
``core/convert.py params_from_numpy``) its hidden states and aux loss equal
the reference's ``forward`` within atol 1e-4 and rtol 1e-4 (fp32, a whole
model); and decode after prefill through the paged cache path equals
``forward`` of the extended sequence within the reference test's 2e-3.
The reference test's train-step half waits for the port's training slice.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import ExecutionPlan as JPlan  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import ExecutionPlan  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.models import (decode_step, default_block_tables,  # noqa: E402
                                forward, init_cache, init_params, prefill,
                                with_block_tables)
from repro_torch.models.layers import lm_logits, rms_norm  # noqa: E402
from repro_torch.models.model import param_count_actual  # noqa: E402

E2E = dict(atol=1e-4, rtol=1e-4)
DEC = dict(atol=2e-3, rtol=2e-3)     # tests/test_arch_smoke.py's
SERVED = list(ALL_ARCHS)
PLAN = ExecutionPlan(remat="none", attn_impl="chunked",
                     compute_dtype="float32")
J_PLAN = JPlan(remat="block", attn_impl="chunked", compute_dtype="float32",
               microbatches=1, logits_chunk=0)


def _tokens(cfg, seed, b, s):
    k = cfg.n_codebooks
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s, k) if k > 1 else (b, s))


@pytest.fixture(scope="module", params=SERVED)
def arch(request):
    """(JAX config, port config, JAX params, the port's copy of them)."""
    jc, tc = j_smoke(request.param), t_smoke(request.param)
    jp = j_init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(tc, jax.device_get(jp), "cpu")


def test_forward_shapes_and_finite(arch):
    _, tc, _, _ = arch
    params = init_params(torch.Generator().manual_seed(0), tc)
    assert param_count_actual(params) > 0
    b, s = 2, 32
    h, aux = forward(params, torch.from_numpy(_tokens(tc, 0, b, s)), tc,
                     PLAN)
    assert h.shape == (b, s, tc.d_model)
    assert torch.isfinite(h).all(), "NaN in forward"
    assert aux.shape == () and torch.isfinite(aux)


def test_forward_matches_reference(arch):
    jc, tc, jp, tp = arch
    tok = _tokens(jc, 1, 2, 32)
    h_j, aux_j = j_forward(jp, jax.numpy.asarray(tok), jc, J_PLAN)
    h_t, aux_t = forward(tp, torch.from_numpy(tok), tc, PLAN)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **E2E)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **E2E)
    assert (float(aux_t) > 0) == (tc.moe is not None
                                  and not tc.moe.router_aux_free)


def test_prefill_decode_matches_forward(arch):
    """decode(t+1 | prefill(0..t)) equals forward(0..t+1) at position t+1,
    through the paged pools with default block tables, the window rings
    and the recurrent states."""
    _, cfg, _, params = arch
    b = 2
    s = 2 * cfg.page_blocks          # page-aligned prompt
    tokens = torch.from_numpy(_tokens(cfg, 2, b, s + 1))
    prompt, nxt = tokens[:, :s], tokens[:, s]
    max_len = s + cfg.page_blocks
    caches = init_cache(cfg, b, max_len, paged=True, dtype=torch.float32)
    caches = with_block_tables(caches, default_block_tables(cfg, b, max_len))
    _, caches = prefill(params, prompt, cfg, PLAN, caches)
    pos = torch.full((b,), s, dtype=torch.int32)
    logits_dec, _ = decode_step(params, nxt, pos, cfg, PLAN, caches)
    h, _ = forward(params, tokens, cfg, PLAN)
    h_n = rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps,
                   gemma_style=cfg.name.startswith("gemma"))
    logits_fwd = lm_logits(params["embed"], h_n, cfg)[:, 0]
    np.testing.assert_allclose(logits_dec.numpy(), logits_fwd.numpy(), **DEC)
