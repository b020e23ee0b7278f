"""Port parity: the copy-based serving baseline on a bf16 plan, through a
fork.

The baseline (``kv_backend="host"``) keeps its model-owned K/V pools in
the plan's compute dtype and copies them on write (CoW) through
``dbs_copy`` once per pool at the first step after a fork, as the
reference's baseline does through its Pallas ``dbs_copy``
(``repro/serving/engine.py`` ``_alloc_pages``). On a bf16 plan those pools
are bf16, which the Pallas kernel takes; before the port's kernels moved
bytes its wrapper took fp32 alone and this test raised ``TypeError`` at
that step.

The twin of ``tests/test_torch_serving_host.py::
test_fork_matches_reference_in_lock_step`` on the bf16 plan (granite-3-8b
at smoke width, no window layers; volume 0 held in every engine, as
there): the port's bf16 engine (``attn_impl="cuda"``: flash's plain
version in prefill here), the reference's bf16 engine and its fp32 engine
(``attn_impl="chunked"``) step in lock step, a session forked after 3
steps, 12 more steps. Each step's emitted tokens equal the reference bf16
engine's except where that engine's top-2 logit margin is under MARGIN (a
near tie, after which the request is not compared); the extent map and
``dbs.stats`` are equal. The logits meet the yardstick of
``tests/test_torch_bf16.py``: over the steps where all three engines'
tokens still agree, the port's largest distance to the reference's fp32
logits is at most RATIO times the reference bf16 engine's. The fork's CoW
makes one plain ``dbs_copy`` per pool on the bf16 pools (K and V of every
layer).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.configs.base import ExecutionPlan as JPlan  # noqa: E402
from repro.core import dbs as JD  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serving import GenRequest as JGen  # noqa: E402
from repro.serving import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import ExecutionPlan  # noqa: E402
from repro_torch.core import dbs as TD  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.dbs import copy_kernel  # noqa: E402
from repro_torch.serving import GenRequest, ServeEngine  # noqa: E402

RATIO = 1.5          # tests/test_torch_bf16.py's yardstick
MARGIN = 0.05        # a closer bf16 top-2 step may pick either token
BF16 = dict(remat="none", compute_dtype="bfloat16")


def _margin(logits):
    top = np.sort(np.asarray(logits, np.float32))[-2:]
    return float(top[1] - top[0])


def test_bf16_fork_matches_reference_in_lock_step():
    jc, tc = j_smoke("granite-3-8b"), t_smoke("granite-3-8b")
    jp = j_init(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(tc, jax.device_get(jp), "cpu")
    kw = dict(kv_backend="host", record_logits=True, n_slots=4, max_len=64)
    te = ServeEngine(tc, tp, plan=ExecutionPlan(attn_impl="cuda", **BF16),
                     device="cpu", **kw)
    jb = JServe(jc, jp, plan=JPlan(attn_impl="chunked", **BF16), **kw)
    j32 = JServe(jc, jp, plan=JPlan(remat="none", attn_impl="chunked",
                                    compute_dtype="float32"), **kw)
    engines = (te, jb, j32)
    assert {e.volumes.create().vid for e in engines} == {0}
    pools = [c[k] for c in te.caches if c is not None and "pool_k" in c
             for k in ("pool_k", "pool_v")]
    assert len(pools) == 2 * tc.n_layers
    assert all(p.dtype == torch.bfloat16 for p in pools)
    prompt = np.random.default_rng(1).integers(0, jc.vocab_size, size=(9,))
    te.submit(GenRequest(req_id=0, prompt=prompt.copy(), max_new=10))
    for e in (jb, j32):
        e.submit(JGen(req_id=0, prompt=prompt.copy(), max_new=10))
    tokens = {}              # rid -> three token lists (port, bf16, fp32)
    tied, parted = set(), set()   # past a bf16 near tie; past bf16 != fp32
    d_port = d_ref = 0.0
    compared, measured, ties = 0, 0, {}

    def lockstep(steps):
        nonlocal d_port, d_ref, compared, measured
        for _ in range(steps):
            outs = [e.step() for e in engines]
            assert [r for r, _ in outs[0]] == [r for r, _ in outs[1]]
            for i, out in enumerate(outs):
                for rid, tok in out:
                    tokens.setdefault(rid, ([], [], []))[i].append(tok)
            for rid, _ in outs[0]:
                if rid in tied:
                    continue
                port, ref, fp32 = (np.asarray(e.live[rid].logit_trace[-1],
                                              np.float32) for e in engines)
                tt, jt, ft = (t[-1] for t in tokens[rid])
                compared += 1
                if rid not in parted:
                    d_port = max(d_port, float(np.abs(port - fp32).max()))
                    d_ref = max(d_ref, float(np.abs(ref - fp32).max()))
                    measured += 1
                if tt != jt:
                    assert _margin(ref) < MARGIN, (rid, tt, jt, _margin(ref))
                    ties[rid] = _margin(ref)
                    tied.add(rid)
                if jt != ft:
                    parted.add(rid)
            assert np.array_equal(te.state.table.numpy(),
                                  np.asarray(jax.device_get(jb.state.table)))
            assert TD.stats(te.state) == JD.stats(jb.state)

    lockstep(3)
    kids = [e.fork(0, 1, max_new=5) for e in engines]
    assert all(k is not None for k in kids)
    assert len({(k.slot, k.volume) for k in kids}) == 1
    copy_kernel.reset_counts()
    lockstep(12)
    # the first step after the fork CoWs the frontier page: one plain copy
    # per bf16 pool (K and V of each layer)
    assert copy_kernel.PLAIN_CALLS["dbs_copy"] == 2 * tc.n_layers
    par, chi = te.live[0].out_tokens, te.live[1].out_tokens
    assert len(par) == 10 and len(chi) == 5
    assert chi == par[:len(chi)], (par, chi)
    print(f"tokens compared {compared} of "
          f"{sum(len(t[0]) for t in tokens.values())}, logits measured "
          f"{measured}, port "
          f"bf16 - fp32 {d_port:.4g}, reference bf16 - fp32 {d_ref:.4g}, "
          f"near ties {ties}")
    assert compared == sum(len(t[0]) for t in tokens.values()) or ties
    assert measured >= 4 and 0.0 < d_ref
    assert d_port <= RATIO * d_ref
