"""Port parity: serving deepseek-v3 (MLA layers, one latent KV head of keys
kv_rank + rope and values kv_rank, zero-padded to the engine pool's width)
and musicgen (four codebooks: ``(S, K)`` prompts, codebook 0's argmax fed
back to every codebook) on ``ServeEngine``'s zero-copy ``fused`` path and
its copy-based ``host`` baseline.

The same seeded requests go to the JAX ``ServeEngine`` and the port's
(``device="cpu"``; every kernel wrapper runs its plain version); weights
cross with ``core/convert.py params_from_numpy``. Three requests on two
slots, so the third runs in a recycled slot. Compared: every request's
tokens (equal) and its recorded logits, within atol 1e-4 and rtol 1e-4
(fp32; the packages sum in other orders), against the reference's
``fused`` engine, which has neither of its baseline's faults.

The reference's baseline misserves deepseek-v3's recycled slot: with
these prompts its request 2 (volume 0 again, after request 0 freed it)
differs from its own ``fused`` engine's, and holding volume 0 with an
empty volume removes the difference. That is the fault
tests/test_torch_serving_host.py pins (idle decode lanes write into
volume 0's pages; ROADMAP queue 3); ``test_reference_baseline_fault_on_
deepseek`` pins it here, and the port's baseline serves the reference's
``fused`` tokens. A 1-D prompt to musicgen fails inside the reference's
step; the port refuses it at ``submit``. Forks (after two decode steps,
both sides CoW the shared frontier page) and recycled slots are compared
between the port's two backends, and a fork's streams against an
independent decode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serving import GenRequest as JGen  # noqa: E402
from repro.serving import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.core import dbs as TD  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import GenRequest, ServeEngine  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
GEOM = dict(n_slots=2, max_len=64)
DEEPSEEK, MUSICGEN = "deepseek-v3-671b", "musicgen-large"


def _prompts(cfg, seed, n=3):
    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(5, 30)) for _ in range(n)]
    k = cfg.n_codebooks
    return [rng.integers(0, cfg.vocab_size, (s, k) if k > 1 else (s,))
            for s in lens]


def _serve(eng, gen, prompts, hold_volume_0=False):
    """Serve ``prompts`` (request r makes 4 + 2r tokens); returns
    {rid: (tokens, stacked logits)}."""
    if hold_volume_0:
        assert eng.volumes.create().vid == 0
    for rid, pr in enumerate(prompts):
        eng.submit(gen(req_id=rid, prompt=pr.copy(), max_new=4 + 2 * rid))
    eng.run(max_steps=64)
    return {rid: (list(g.out_tokens), np.stack(g.logit_trace))
            for rid, g in eng.live.items()}


def _models(name):
    jc, tc = j_smoke(name), t_smoke(name)
    jp = j_init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(tc, jax.device_get(jp), "cpu")


@pytest.fixture(scope="module")
def deepseek():
    """The models and the reference's runs: ``fused``, ``host``, and
    ``host`` with volume 0 held."""
    jc, tc, jp, tp = _models(DEEPSEEK)
    prompts = _prompts(jc, 1)
    runs = {(kv, hold): _serve(
        JServe(jc, jp, kv_backend=kv, record_logits=True, **GEOM), JGen,
        prompts, hold) for kv, hold in (("fused", False), ("host", False),
                                        ("host", True))}
    return tc, tp, prompts, runs


@pytest.fixture(scope="module")
def musicgen():
    jc, tc, jp, tp = _models(MUSICGEN)
    prompts = _prompts(jc, 2)
    want = _serve(JServe(jc, jp, record_logits=True, **GEOM), JGen, prompts)
    return jc, jp, tc, tp, prompts, want


def _port(tc, tp, kv_backend, **kw):
    return ServeEngine(tc, tp, kv_backend=kv_backend, record_logits=True,
                       device="cpu", **{**GEOM, **kw})


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid][0] == want[rid][0], rid
        np.testing.assert_allclose(got[rid][1], want[rid][1], **TOL)


def _leak_free(eng):
    st = TD.stats(eng.state)
    assert st["volumes"] == 0 and st["extents_used"] == 0, st


@pytest.mark.parametrize("kv_backend", ["fused", "host"])
def test_deepseek_serving_matches_reference(deepseek, kv_backend):
    """deepseek-v3's smoke config on both backends equals the reference's
    zero-copy engine, the recycled slot included; no extent leaks."""
    tc, tp, prompts, runs = deepseek
    eng = _port(tc, tp, kv_backend)
    _equal(_serve(eng, GenRequest, prompts), runs[("fused", False)])
    _leak_free(eng)
    if kv_backend == "fused":
        n_planes = 2 * tc.n_layers
        m = tc.mla
        assert eng._payload_shape == (n_planes, 1,
                                      m.kv_lora_rank + m.rope_head_dim)
    else:
        pool_k, pool_v = eng.caches[0]["pool_k"], eng.caches[0]["pool_v"]
        assert pool_k.shape[2:] == (1, tc.mla.kv_lora_rank
                                    + tc.mla.rope_head_dim)
        assert pool_v.shape[2:] == (1, tc.mla.kv_lora_rank)


def test_reference_baseline_fault_on_deepseek(deepseek):
    """The reference's copy-based baseline serves request 2 (volume 0,
    recycled) differently from its own zero-copy engine; with volume 0
    held it does not (module note)."""
    _, _, _, runs = deepseek
    fused, host, held = (runs[k] for k in (("fused", False),
                                           ("host", False), ("host", True)))
    for rid in (0, 1):
        assert host[rid][0] == fused[rid][0]
    assert host[2][0] != fused[2][0]
    assert float(np.abs(host[2][1] - fused[2][1]).max()) > 1e-2
    _equal(held, fused)


@pytest.mark.parametrize("kv_backend", ["fused", "host"])
def test_musicgen_serving_matches_reference(musicgen, kv_backend):
    """musicgen's smoke config, (S, 4) prompts: tokens (codebook 0's
    argmax) and the (K, V) logits a step equal the reference's."""
    _, _, tc, tp, prompts, want = musicgen
    eng = _port(tc, tp, kv_backend)
    got = _serve(eng, GenRequest, prompts)
    assert got[0][1].shape[1:] == (tc.n_codebooks, tc.vocab_size)
    _equal(got, want)
    _leak_free(eng)


def test_musicgen_one_dimensional_prompt(musicgen):
    """A prompt without its codebook axis: the reference's step fails in
    the embedding; the port refuses it at submit, and a (S, 3) one too."""
    jc, jp, tc, tp, _, _ = musicgen
    flat = np.arange(9) % jc.vocab_size
    je = JServe(jc, jp, **GEOM)
    je.submit(JGen(req_id=0, prompt=flat, max_new=2))
    with pytest.raises((ValueError, TypeError, IndexError)):
        je.step()
    eng = _port(tc, tp, "fused")
    for bad in (flat, np.zeros((9, 3), np.int64)):
        with pytest.raises(ValueError, match="prompt of shape"):
            eng.submit(GenRequest(req_id=0, prompt=bad, max_new=2))


@pytest.mark.parametrize("name", [DEEPSEEK, MUSICGEN])
def test_fork_and_recycled_slot_host_equals_fused(deepseek, musicgen, name):
    """A fork after two decode steps (three slots) and a request in the
    slot request 1 freed, on the port's two backends: the same tokens and logits within TOL; the
    forked streams equal an independent decode of the same prompt."""
    tc, tp = (deepseek[:2] if name == DEEPSEEK else musicgen[2:4])
    prompts = _prompts(tc, 3)
    out = {}
    for kv in ("fused", "host"):
        eng = _port(tc, tp, kv, n_slots=3)
        eng.submit(GenRequest(req_id=0, prompt=prompts[0].copy(), max_new=8))
        eng.submit(GenRequest(req_id=1, prompt=prompts[1].copy(), max_new=3))
        for _ in range(2):
            eng.step()
        child = eng.fork(0, 9, max_new=5)
        assert child is not None
        eng.submit(GenRequest(req_id=2, prompt=prompts[2].copy(), max_new=4))
        eng.run(max_steps=40)
        out[kv] = {rid: (list(g.out_tokens), np.stack(g.logit_trace))
                   for rid, g in eng.live.items()}
        _leak_free(eng)
    _equal(out["host"], out["fused"])
    alone = _port(tc, tp, "fused", n_slots=4)
    for rid in (0, 1):
        alone.submit(GenRequest(req_id=rid, prompt=prompts[0].copy(),
                                max_new=8))
    alone.run(max_steps=20)
    par, chi = out["fused"][0][0], out["fused"][9][0]
    assert par == alone.live[0].out_tokens
    assert chi == alone.live[1].out_tokens[:len(chi)]
