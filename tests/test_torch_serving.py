"""Port parity: zero-copy serving, ``ServeEngine(kv_backend="fused")`` and
``kv_backend="sharded"``.

Twins of tests/test_serving.py's continuous-batching, fork, replica-failure
and multi-queue tests. Each feeds the same seeded requests to the JAX
``ServeEngine`` and to the port's (``device="cpu"``: the kernel wrappers run
their plain versions) and steps both in lock step. After every step:

- the emitted token streams are equal,
- the DBS metadata is bit-identical: the extent maps
  (``device_extent_map``) and ``dbs.stats`` of replica 0,
- the logits agree within atol 1e-4 and rtol 1e-4 (fp32; the packages sum
  in other orders),
- the KV pools agree on every mapped extent row within the same tolerance
  (the pool's last row is the DBS dump row, which inactive lanes scatter
  into in both packages and no reader takes data from).

Where a greedy step's top-2 logit margin in JAX is under 1e-3, that step's
token is not compared (only its logits), since a tie that close may break
either way. The port's own fork test is bit-identical, as in JAX.

On the sharded KV store (two shards) the same lock step holds, with replica
0's whole stacked ``DBSState`` compared instead of its stats; the clone
route's watermark inheritance, the dump rows and a mid-decode failover
(where the port corrects the reference: ROADMAP queue 3) are checked too.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.configs.base import ExecutionPlan as JPlan  # noqa: E402
from repro.core import dbs as JD  # noqa: E402
from repro.core.frontend import MultiQueueFrontend as JFrontend  # noqa: E402
from repro.core.frontend import Request as JRequest  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serving import GenRequest as JGen  # noqa: E402
from repro.serving import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import ExecutionPlan  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import dbs as TD  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.core.frontend import MultiQueueFrontend, Request  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as PK  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.blocks import layer_sigs  # noqa: E402
from repro_torch.serving import GenRequest, ServeEngine  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3


@pytest.fixture(scope="module", params=["granite-3-8b", "gemma2-2b"])
def model(request):
    return _models(request.param)


def _models(name):
    jc, tc = j_smoke(name), t_smoke(name)
    jp = j_init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(tc, jax.device_get(jp), "cpu")


@pytest.fixture(scope="module")
def granite():
    return _models("granite-3-8b")


@pytest.fixture(scope="module")
def gemma2():
    return _models("gemma2-2b")


def _pair(m, **kw):
    jc, tc, jp, tp = m
    jplan = kw.pop("jplan", None)
    tplan = kw.pop("tplan", None)
    je = JServe(jc, jp, record_logits=True, plan=jplan, **kw)
    te = ServeEngine(tc, tp, record_logits=True, plan=tplan, device="cpu",
                     **kw)
    return je, te


def _submit(je, te, rid, prompt, max_new):
    je.submit(JGen(req_id=rid, prompt=prompt.copy(), max_new=max_new))
    te.submit(GenRequest(req_id=rid, prompt=prompt.copy(), max_new=max_new))


def _margin(logits):
    top = np.sort(np.asarray(logits))[-2:]
    return float(top[1] - top[0])


def _check(je, te, jo, to):
    """One lock step's comparison (see the module note)."""
    assert [r for r, _ in jo] == [r for r, _ in to]
    for (rid, jt), (_, tt) in zip(jo, to):
        jl = je.live[rid].logit_trace[-1]
        np.testing.assert_allclose(te.live[rid].logit_trace[-1], jl, **TOL)
        if _margin(jl) >= MARGIN:
            assert jt == tt, (rid, jt, tt)
        else:
            print(f"request {rid}: top-2 margin {_margin(jl):.2e} < "
                  f"{MARGIN}: logits compared, not the token")
    jt_map = np.asarray(jax.device_get(je.volumes.device_extent_map()))
    tt_map = te.volumes.device_extent_map().numpy()
    np.testing.assert_array_equal(tt_map, jt_map)
    if te._sharded:                 # replica 0's stacked (S, ...) state
        jst = jax.device_get(dataclasses.asdict(je.state))
        tst = convert.to_numpy(te.state)
        for k in jst:
            if k != "free":
                np.testing.assert_array_equal(tst[k], np.asarray(jst[k]))
    else:
        assert TD.stats(te.state) == JD.stats(je.state)
    rows = np.unique(jt_map[jt_map >= 0])
    # the engines' live pools: the reference holds its decode scatters in
    # the engine until the next pump commits them to the replicas; the
    # port's scatters land in the replicas' own tensors (on the sharded
    # pool, views of them)
    jpools = jax.device_get(je._pools)
    tpools = te.volumes.device_pools()
    assert all((a.data_ptr() == b.data_ptr()) if te._sharded else a is b
               for a, b in zip(tpools, te._pools))
    assert len(jpools) == len(tpools)
    for jp_, tp_ in zip(jpools, tpools):
        np.testing.assert_allclose(tp_.numpy()[rows], np.asarray(jp_)[rows],
                                   **TOL)


def _lockstep(je, te, steps):
    for _ in range(steps):
        jo, to = je.step(), te.step()
        _check(je, te, jo, to)


def _drain(je, te, max_steps=64):
    for _ in range(max_steps):
        _lockstep(je, te, 1)
        if all(g.done for g in te.live.values()) and te.frontend.depth() == 0:
            break
    assert all(g.done for g in je.live.values())


def test_continuous_batching_completes_all(model):
    """More requests than slots: every request ends with its tokens, equal
    to the reference's, and no extent or volume leaks."""
    jc = model[0]
    je, te = _pair(model, n_slots=4, max_len=64)
    rng = np.random.default_rng(0)
    n_req = 6
    for rid in range(n_req):
        _submit(je, te, rid, rng.integers(0, jc.vocab_size, size=(8 + rid,)),
                4)
    _drain(je, te, 40)
    outs = {rid: g.out_tokens for rid, g in te.live.items()}
    assert len(outs) == n_req
    assert all(len(v) == 4 for v in outs.values()), outs
    st = TD.stats(te.state)
    assert st["extents_used"] == 0, f"extent leak: {st}"
    assert st["volumes"] == 0
    assert te.volumes.engine.backend.consistent()


def test_fork_shares_prefix_and_diverges_safely(granite):
    jc = granite[0]
    je, te = _pair(granite, n_slots=4, max_len=64)
    rng = np.random.default_rng(1)
    _submit(je, te, 0, rng.integers(0, jc.vocab_size, size=(9,)), 10)
    _lockstep(je, te, 3)
    jchild, child = je.fork(0, 1, max_new=5), te.fork(0, 1, max_new=5)
    assert child is not None and jchild is not None
    assert (child.slot, child.volume) == (jchild.slot, jchild.volume)
    shared = list(child.out_tokens)
    _lockstep(je, te, 12)
    parent_toks = te.live[0].out_tokens
    child_toks = te.live[1].out_tokens
    # greedy decoding from a shared prefix must continue identically
    assert child_toks[:len(shared)] == shared
    assert child_toks == parent_toks[:len(child_toks)], \
        (parent_toks, child_toks)
    assert child_toks == je.live[1].out_tokens
    assert parent_toks == je.live[0].out_tokens


def test_fork_cow_shares_prefix_extents_and_matches_reference(granite):
    """Fork mid-decode shares the prefix EXTENTS (the clone's extent-map row
    equals the parent's), diverging writes CoW only the frontier page, both
    sessions track the JAX engine, and their post-fork logits are
    bit-identical to two sessions decoded independently by the port."""
    jc, tc, _, tp = granite
    page = tc.page_blocks
    je, eng = _pair(granite, n_slots=4, max_len=64)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jc.vocab_size, size=(9,))
    _submit(je, eng, 0, prompt, 12)
    _lockstep(je, eng, 4)
    parent = eng.live[0]
    child = eng.fork(0, 1, max_new=8)
    assert child is not None and je.fork(0, 1, max_new=8) is not None
    tbl = eng.volumes.device_extent_map().numpy()
    prow, crow = tbl[parent.volume].copy(), tbl[child.volume].copy()
    np.testing.assert_array_equal(prow, crow)      # shared, not copied
    assert (prow >= 0).sum() >= 2                  # a real prefix exists
    frontier = (9 + 4) // page                     # page holding fork pos
    _lockstep(je, eng, 2)                          # diverge both sides
    tbl2 = eng.volumes.device_extent_map().numpy()
    prow2, crow2 = tbl2[parent.volume], tbl2[child.volume]
    # frontier page CoW'd apart; full prefix pages still shared
    assert prow2[frontier] != crow2[frontier], (prow2, crow2)
    for p in range(frontier):
        assert prow2[p] == crow2[p] == prow[p]
    _lockstep(je, eng, 16)
    # the same two streams decoded independently by the port
    ref = ServeEngine(tc, tp, n_slots=4, max_len=64, record_logits=True,
                      device="cpu")
    ref.submit(GenRequest(req_id=0, prompt=prompt.copy(), max_new=12))
    ref.submit(GenRequest(req_id=1, prompt=prompt.copy(), max_new=12))
    ref.run(max_steps=20)
    assert eng.live[0].out_tokens == ref.live[0].out_tokens[:12]
    # the child's trace starts at the fork step (absolute step 4)
    np.testing.assert_array_equal(
        np.stack(eng.live[0].logit_trace[4:]),
        np.stack(ref.live[0].logit_trace[4:12]))
    np.testing.assert_array_equal(
        np.stack(eng.live[1].logit_trace),
        np.stack(ref.live[1].logit_trace[4:4 + len(eng.live[1].logit_trace)]))


def test_serving_zero_copy_replica_failure_mid_decode(granite):
    """Failing a replica mid-decode corrupts no session: tokens and logits
    stay bit-identical to an undisturbed port engine, and the JAX engine
    failed at the same step agrees. The survivors stay consistent. Then the
    streamed delta rebuild mid-decode, in both packages: every replica's
    metadata and watermarks equal the JAX package's bit for bit, and the
    replicas that never failed equal the JAX package's pools within the
    module's tolerance on every mapped row (the K/V values themselves
    differ within it). The reference's delta leaves stale the rows the
    decode wrote since the failure into pages mapped before it (ROADMAP
    queue 3); the port also streams every row of a live session, so its
    rebuilt replica equals its donor bit for bit on every mapped row. Both
    replicas are consistent, and with replica 0 failed afterwards
    the rebuilt replica serves the rest of the decode to the undisturbed
    engine's tokens and logits."""
    jc, tc, _, tp = granite
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, jc.vocab_size, size=(7,))
    je, eng = _pair(granite, n_slots=2, max_len=64)
    _submit(je, eng, 0, prompt, 10)
    ref = ServeEngine(tc, tp, n_slots=2, max_len=64, record_logits=True,
                      device="cpu")
    ref.submit(GenRequest(req_id=0, prompt=prompt.copy(), max_new=10))
    for _ in range(3):
        _lockstep(je, eng, 1)
        ref.step()
    je.control("fail", replica=1)                   # mid-decode failure
    eng.control("fail", replica=1)
    assert len(eng.volumes.device_pools()) == 1
    for _ in range(3):
        _lockstep(je, eng, 1)
        ref.step()
    assert eng.volumes.engine.backend.consistent()
    je.control("rebuild", replica=1)                # mid-decode rebuild
    eng.control("rebuild", replica=1)
    jg, tg = je.volumes.engine.backend, eng.volumes.engine.backend
    assert len(eng.volumes.device_pools()) == 2 and tg.consistent()
    jmap = np.asarray(jax.device_get(jg.replicas[0].state.table))
    rows = np.unique(jmap[jmap >= 0])
    live = np.unique(jmap[eng.live[0].volume])
    live = live[live >= 0]
    assert rows.size and live.size
    # the reference's delta, then one resync of the live session's rows
    assert tg.transports[1].pages_moved == \
        jg.transports[1].pages_moved + live.size
    for i, (jr, tr) in enumerate(zip(jg.replicas, tg.replicas)):
        jst = jax.device_get(dataclasses.asdict(jr.state))
        tst = convert.to_numpy(tr.state)
        for k in jst:
            if k != "free":
                np.testing.assert_array_equal(tst[k], np.asarray(jst[k]))
        np.testing.assert_array_equal(tr.page_rev.numpy(),
                                      np.asarray(jr.page_rev))
        if i != 1:
            np.testing.assert_allclose(tr.pool.numpy()[rows],
                                       np.asarray(jr.pool)[rows], **TOL)

    def stale(g, host):
        a, b = (host(g.replicas[i].pool)[rows] for i in (1, 0))
        return (a != b).reshape(len(rows), -1).any(1)
    # reference fault, corrected in the port: the decode program scatters
    # each token's K/V with no watermark stamp, so the reference's delta
    # leaves those rows stale on the rebuilt replica
    assert stale(jg, np.asarray).any()
    assert not stale(tg, lambda t: t.numpy()).any()
    eng.control("fail", replica=0)                  # the rebuilt one serves
    assert eng.volumes.engine.backend.healthy_indices() == [1]
    while not eng.live[0].done:
        eng.step()
    while not ref.live[0].done:
        ref.step()
    assert eng.live[0].out_tokens == ref.live[0].out_tokens
    np.testing.assert_array_equal(np.stack(eng.live[0].logit_trace),
                                  np.stack(ref.live[0].logit_trace))
    assert tg.consistent()


def test_multiqueue_frontend_backpressure():
    """``poll_batch`` admits at most the free slots, requeues the rest at
    the front, and ``complete`` frees them: the same admissions and slot
    ids as the reference's frontend."""
    fe = MultiQueueFrontend(n_queues=2, n_slots=4, batch=8, device="cpu")
    jfe = JFrontend(n_queues=2, n_slots=4, batch=8)
    for i in range(10):
        fe.submit(Request(req_id=i, kind="read", volume=0, page=0))
        jfe.submit(JRequest(req_id=i, kind="read", volume=0, page=0))
    ids, admitted = fe.poll_batch()
    jids, jadmitted = jfe.poll_batch()
    assert len(admitted) == 4                   # slot-bounded admission
    assert fe.depth() == 6 == jfe.depth()
    assert [r.req_id for r in admitted] == [r.req_id for r in jadmitted]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    done = fe.complete(ids[:4])
    assert [r.req_id for r in done] == [r.req_id for r in admitted]
    jfe.complete(jids[:4])
    ids2, admitted2 = fe.poll_batch()
    jids2, jadmitted2 = jfe.poll_batch()
    assert len(admitted2) == 4
    assert [r.req_id for r in admitted2] == [r.req_id for r in jadmitted2]
    np.testing.assert_array_equal(ids2.numpy(), np.asarray(jids2))


def test_prefill_through_the_flash_kernel_wrapper(model):
    """``attn_impl="cuda"`` sends prefill through the flash kernel's wrapper
    (its plain version on the CPU); the reference runs ``"pallas"`` in
    interpret mode. The decode path goes through the paged kernel's
    wrapper (``kernel="auto"``), never its plain version directly."""
    jc = model[0]
    je, te = _pair(model, n_slots=2, max_len=32,
                   jplan=JPlan(remat="none", attn_impl="pallas",
                               compute_dtype="float32"),
                   tplan=ExecutionPlan(remat="none", attn_impl="cuda",
                                       compute_dtype="float32"))
    rng = np.random.default_rng(5)
    for rid in range(3):
        _submit(je, te, rid, rng.integers(0, jc.vocab_size, size=(5 + rid,)),
                3)
    calls = PK.PLAIN_CALLS["paged_attention"]
    _drain(je, te, 20)
    n_paged = sum(s.window == 0 for s in layer_sigs(model[1]))
    assert PK.PLAIN_CALLS["paged_attention"] - calls == n_paged * te._steps


@pytest.mark.parametrize("kernel", ["torch", "ref"])
def test_plain_kernels_match_the_default(granite, kernel):
    """``kernel="torch"``/``"ref"`` (plain paged attention and plain DBS
    data plane) give the default engine's tokens and logits bit for bit on
    the CPU, without going through the paged kernel's wrapper."""
    jc, tc, _, tp = granite
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jc.vocab_size, size=(6 + r,)) for r in range(3)]
    outs = []
    for kern in ("auto", kernel):
        e = ServeEngine(tc, tp, n_slots=2, max_len=32, record_logits=True,
                        kernel=kern, device="cpu")
        for rid, p in enumerate(prompts):
            e.submit(GenRequest(req_id=rid, prompt=p.copy(), max_new=3))
        calls = PK.PLAIN_CALLS["paged_attention"]
        e.run(max_steps=20)
        assert (PK.PLAIN_CALLS["paged_attention"] > calls) == (kern == "auto")
        outs.append(e)
    for rid in range(3):
        assert outs[0].live[rid].out_tokens == outs[1].live[rid].out_tokens
        np.testing.assert_array_equal(np.stack(outs[0].live[rid].logit_trace),
                                      np.stack(outs[1].live[rid].logit_trace))


def test_dump_row_is_never_read(granite):
    """Inactive lanes scatter their K/V into the pool's last row (the DBS
    dump row). Filled with NaN before decoding, it must not reach any
    logit: no reader takes data from it."""
    jc, tc, _, tp = granite
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, jc.vocab_size, size=(6,))
    engines = []
    for poison in (False, True):
        e = ServeEngine(tc, tp, n_slots=4, max_len=32, record_logits=True,
                        device="cpu")
        e.submit(GenRequest(req_id=0, prompt=prompt.copy(), max_new=6))
        if poison:
            for p in e.volumes.device_pools():
                p[-1] = float("nan")
        e.run(max_steps=20)
        engines.append(e)
    assert all(torch.isnan(p[-1]).any() for p in engines[1]._pools)
    np.testing.assert_array_equal(np.stack(engines[0].live[0].logit_trace),
                                  np.stack(engines[1].live[0].logit_trace))
    assert engines[1].volumes.engine.backend.consistent()


def test_device_views_are_the_live_pools(granite):
    """``payload_shape=`` is accepted; ``device_pools`` returns the
    replicas' own tensors and ``set_device_pools`` stores what it is
    given."""
    _, tc, _, tp = granite
    e = ServeEngine(tc, tp, n_slots=2, max_len=32, device="cpu")
    mgr = e.volumes
    assert mgr.payload_shape == e._payload_shape
    pools = mgr.device_pools()
    for p, r in zip(pools, mgr.engine.backend.replicas):
        assert p is r.pool
    fresh = tuple(p.clone() for p in pools)
    mgr.set_device_pools(fresh)
    assert all(a is b for a, b in zip(mgr.device_pools(), fresh))
    with pytest.raises(ValueError, match="shape"):
        mgr.set_device_pools(tuple(p[:-1] for p in fresh))
    assert mgr.device_extent_map() is mgr.engine.backend.replicas[0].state.table


def test_unported_serving_configuration_raises(granite):
    """Every arch serves now: musicgen (four codebooks) on the zero-copy
    path (tests/test_torch_serving_mla.py holds it against the
    reference); what the engine cannot serve still raises: a pure
    recurrent net on ``fused``, a prompt of the wrong shape, and (with no
    card) the default device."""
    _, tc, _, tp = granite
    ring = ServeEngine(tc, tp, kv_backend="ring", device="cpu")
    assert ring._sharded and ring.volumes.backend_name == "ring"
    mg = t_smoke("musicgen-large")
    mp = TM.init_params(torch.Generator().manual_seed(0), mg)
    eng = ServeEngine(mg, mp, n_slots=2, max_len=32, device="cpu")
    eng.submit(GenRequest(req_id=0, prompt=np.zeros((5, mg.n_codebooks),
                                                    np.int64), max_new=2))
    assert len(eng.run(max_steps=8)[0]) == 2
    with pytest.raises(ValueError, match="prompt of shape"):
        eng.submit(GenRequest(req_id=1, prompt=np.zeros((5,), np.int64)))
    rw = t_smoke("rwkv6-3b")
    with pytest.raises(ValueError, match="paged-attention layer"):
        ServeEngine(rw, TM.init_params(torch.Generator().manual_seed(0), rw),
                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeEngine(tc, tp)


def test_fork_copies_the_window_ring_caches(gemma2):
    """gemma2's local layers keep their K/V in per-slot ring caches, outside
    the volume. A fork must hand the child a copy of the parent's ring, or
    the child reads its slot's stale ring (the reference skips the copy:
    its gemma2 forks diverge, ROADMAP queue 3). With slots left stale by
    earlier requests, the port's forked streams are bit-identical to two
    sessions decoded independently."""
    _, tc, _, tp = gemma2
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, tc.vocab_size, size=(30,))
    eng = ServeEngine(tc, tp, n_slots=4, max_len=64, record_logits=True,
                      device="cpu")
    for r in range(3):                     # leave stale rings in the slots
        eng.submit(GenRequest(req_id=100 + r, prompt=rng.integers(
            0, tc.vocab_size, size=(20,)), max_new=3))
    eng.run(max_steps=10)
    eng.submit(GenRequest(req_id=0, prompt=prompt.copy(), max_new=12))
    for _ in range(4):
        eng.step()
    child = eng.fork(0, 1, max_new=8)
    assert child is not None and child.slot != eng.live[0].slot
    eng.run(max_steps=20)
    ref = ServeEngine(tc, tp, n_slots=4, max_len=64, record_logits=True,
                      device="cpu")
    for rid in (0, 1):
        ref.submit(GenRequest(req_id=rid, prompt=prompt.copy(), max_new=12))
    ref.run(max_steps=20)
    assert eng.live[0].out_tokens == ref.live[0].out_tokens
    n = len(eng.live[1].logit_trace)
    assert eng.live[1].out_tokens == ref.live[1].out_tokens[:len(
        eng.live[1].out_tokens)]
    np.testing.assert_array_equal(np.stack(eng.live[1].logit_trace),
                                  np.stack(ref.live[1].logit_trace[4:4 + n]))


def test_gemma2_fork_matches_reference_in_lock_step(gemma2):
    """A gemma2 fork (local and global layers) into a slot that has never
    held a request, against the JAX engine in lock step: tokens, logits,
    extent maps, DBS stats and pool rows after every step. The reference's
    fork leaves the child's sliding-window rings empty (ROADMAP queue 3);
    the test copies the parent's ring rows into the reference's child slot,
    the one step the port's fork adds, so the rest of the fork path (clone,
    frontier CoW, decode of both sides) is held against the reference."""
    jc = gemma2[0]
    je, te = _pair(gemma2, n_slots=4, max_len=64)
    rng = np.random.default_rng(8)
    # 30 tokens: past the smoke window (16), so the rings have wrapped
    _submit(je, te, 0, rng.integers(0, jc.vocab_size, size=(30,)), 12)
    _lockstep(je, te, 4)
    jchild, child = je.fork(0, 1, max_new=8), te.fork(0, 1, max_new=8)
    assert child is not None and jchild is not None
    assert (child.slot, child.volume) == (jchild.slot, jchild.volume)
    parent_slot = te.live[0].slot
    n_ring = 0
    for c in je.caches:
        if c is not None and "ring_k" in c:
            n_ring += 1
            for key in ("ring_k", "ring_v", "ring_pos"):
                c[key] = c[key].at[child.slot].set(c[key][parent_slot])
    assert n_ring == sum(s.window > 0 for s in layer_sigs(gemma2[1])) > 0
    _drain(je, te, 20)
    assert te.live[1].out_tokens == je.live[1].out_tokens
    assert te.live[0].out_tokens == je.live[0].out_tokens
    assert len(te.live[1].out_tokens) == 8


# ---------------------------------------------------------------------------
# the sharded KV store
# ---------------------------------------------------------------------------
SHARDED = dict(kv_backend="sharded", kv_shards=2)


def test_sharded_serving_matches_jax(granite):
    """More requests than slots, their volumes spread over two shards: each
    lock step gives the reference's tokens and logits, extent map, stacked
    metadata and pools (the module note); at the end nothing leaks and the
    replicas agree on every shard."""
    jc = granite[0]
    je, te = _pair(granite, n_slots=4, max_len=64, **SHARDED)
    rng = np.random.default_rng(5)
    for rid in range(6):
        _submit(je, te, rid, rng.integers(0, jc.vocab_size, size=(8 + rid,)),
                4)
    _drain(je, te, 40)
    assert all(len(g.out_tokens) == 4 for g in te.live.values())
    st = convert.to_numpy(te.state)
    assert (st["extent_owner"] < 0).all() and (st["vol_head"] < 0).all()
    assert te.volumes.engine.backend.consistent()
    assert {g.volume % 2 for g in te.live.values()} == {0, 1}


def test_clone_inherits_page_rev_on_serving_route():
    """tests/test_serving.py's check on the sharded pool, in both packages:
    ``VolumeManager.clone`` keeps the clone on its source's shard with the
    source's watermark row, so a replica rebuilt after the clone diverged
    serves the clone's prefix fresh. The watermarks and the final stacked
    metadata equal the reference's."""
    from repro.core.blockdev import VolumeManager as JManager
    from repro_torch.core.blockdev import VolumeManager

    def run(make, host):
        with make(backend="sharded", n_shards=2, n_replicas=2,
                  payload_elems=8, page_blocks=4, n_extents=64,
                  max_volumes=8, max_pages=8) as mgr:
            vol = mgr.create()
            data = bytes(range(32))                 # one full page
            vol.write(0, data)
            clone = vol.clone()
            assert clone is not None
            shard = vol.vid % 2
            assert clone.vid % 2 == shard           # shard-local clone
            revs = np.stack([host(r) for r in
                             mgr.engine.backend.device_page_revs()])
            src_l, cl_l = vol.vid // 2, clone.vid // 2
            assert revs[0, shard, src_l].max() > 0
            np.testing.assert_array_equal(revs[:, shard, cl_l],
                                          revs[:, shard, src_l])
            mgr.flush()
            mgr.engine.control("fail", shard=shard, replica=0)
            clone.write(32, b"\xff" * 8)            # diverge while degraded
            mgr.engine.control("rebuild", shard=shard, replica=0)
            mgr.engine.control("fail", shard=shard, replica=1)
            assert clone.read(0, 32) == data
            assert clone.read(32, 8) == b"\xff" * 8
            mgr.engine.control("rebuild", shard=shard, replica=1)
            g = mgr.engine.backend
            return revs, [host(r) for r in g.device_page_revs()], [
                host(st.table) for st in g.states]
    jout = run(JManager, lambda x: np.asarray(jax.device_get(x)))
    tout = run(lambda **kw: VolumeManager(device="cpu", **kw),
               lambda x: x.numpy())
    np.testing.assert_array_equal(tout[0], jout[0])
    for a, b in zip(tout[1] + tout[2], jout[1] + jout[2]):
        np.testing.assert_array_equal(a, b)


def test_sharded_dump_rows_are_never_read(granite):
    """Every shard's dump row (flattened row ``s*(E+1)+E``) filled with NaN
    before decoding reaches no logit; inactive lanes scatter into the last
    one, as the reference's wrapped index -1 does."""
    jc, tc, _, tp = granite
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jc.vocab_size, size=(6 + i,)) for i in (0, 1)]
    engines = []
    for poison in (False, True):
        e = ServeEngine(tc, tp, n_slots=4, max_len=32, record_logits=True,
                        device="cpu", **SHARDED)
        for rid, pr in enumerate(prompts):
            e.submit(GenRequest(req_id=rid, prompt=pr.copy(), max_new=6))
        rows = e.volumes.engine.backend.pools[0].shape[1]
        dumps = [s * rows + rows - 1 for s in range(2)]
        if poison:
            for p in e.volumes.device_pools():
                p[dumps] = float("nan")
        e.run(max_steps=20)
        engines.append(e)
    assert all(torch.isnan(p[dumps]).all(dim=0).any()
               for p in engines[1]._pools)
    for rid in range(2):
        np.testing.assert_array_equal(
            np.stack(engines[0].live[rid].logit_trace),
            np.stack(engines[1].live[rid].logit_trace))


def test_sharded_failover_reads_healthy_replicas(granite):
    """A shard's replica 0 fails mid-decode and two more sessions are
    admitted, one of them on that shard; later that replica is rebuilt and
    shard 0's replica 1 fails. The port reads each shard's extent map from
    a healthy replica and attends through a replica healthy on every shard,
    so every session's tokens and logits equal an undisturbed engine's bit
    for bit; the rebuild moves rows of shard 0 only. The reference reads
    replica 0's map and pool whatever their health: the session admitted
    on the failed shard finds no extent for its prompt, and its logits
    leave the undisturbed ones (ROADMAP queue 3)."""
    jc, tc, _, tp = granite
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jc.vocab_size, size=(7 + i,))
               for i in range(3)]
    je, te = _pair(granite, n_slots=4, max_len=64, **SHARDED)
    ref = ServeEngine(tc, tp, n_slots=4, max_len=64, record_logits=True,
                      device="cpu", **SHARDED)

    def submit(rid):
        _submit(je, te, rid, prompts[rid], 6)
        ref.submit(GenRequest(req_id=rid, prompt=prompts[rid].copy(),
                              max_new=6))

    def step(n, engines):
        for _ in range(n):
            for e in engines:
                e.step()
    submit(0)
    _lockstep(je, te, 2)
    step(2, [ref])
    je.control("fail", shard=0, replica=0)
    te.control("fail", shard=0, replica=0)
    submit(1)
    submit(2)
    step(3, [je, te, ref])
    on0, = (rid for rid in (1, 2) if te.live[rid].volume % 2 == 0)
    assert je.live[on0].volume == te.live[on0].volume
    g = te.volumes.engine.backend
    moved = dict(g.transports[0].pages_moved_by_shard)
    te.control("rebuild", shard=0, replica=0)  # mid-decode, delta + resync
    assert set(g.transports[0].pages_moved_by_shard) == {0}
    assert g.transports[0].pages_moved_by_shard[0] > moved.get(0, 0)
    te.control("fail", shard=0, replica=1)     # the rebuilt one serves
    assert te._attn == 0 and g.consistent()
    step(12, [je, te, ref])
    for rid in range(3):
        assert te.live[rid].done and ref.live[rid].done
        assert te.live[rid].out_tokens == ref.live[rid].out_tokens
        np.testing.assert_array_equal(np.stack(te.live[rid].logit_trace),
                                      np.stack(ref.live[rid].logit_trace))
    # the reference's session on the failed shard attends no prompt K/V
    assert not np.allclose(np.stack(je.live[on0].logit_trace),
                           np.stack(ref.live[on0].logit_trace), **TOL)


def test_sharded_fail_refused_before_it_applies(granite):
    """Two KV replicas over two shards: failing (shard 0, replica 1) and
    then (shard 1, replica 0) leaves each shard a healthy replica but none
    healthy on both, so no pool could serve the one decode. The second fail
    is refused with nothing changed: the health mask, the pool the decode
    attends through, and the tokens, which still equal an undisturbed
    engine's bit for bit."""
    jc, tc, _, tp = granite
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, jc.vocab_size, size=(7 + i,))
               for i in range(2)]
    engines = [ServeEngine(tc, tp, n_slots=4, max_len=64,
                           record_logits=True, device="cpu", **SHARDED)
               for _ in range(2)]
    for e in engines:
        for rid, pr in enumerate(prompts):
            e.submit(GenRequest(req_id=rid, prompt=pr.copy(), max_new=6))
        for _ in range(3):
            e.step()
    te = engines[0]
    g = te.volumes.engine.backend
    te.control("fail", shard=0, replica=1)
    assert te._attn == 0
    before = g.healthy.copy()
    with pytest.raises(RuntimeError, match="no KV replica healthy"):
        te.control("fail", shard=1, replica=0)
    np.testing.assert_array_equal(g.healthy, before)
    assert te._attn == 0
    for e in engines:
        e.run(max_steps=20)
    for rid in range(2):
        assert te.live[rid].done
        assert te.live[rid].out_tokens == engines[1].live[rid].out_tokens
        np.testing.assert_array_equal(
            np.stack(te.live[rid].logit_trace),
            np.stack(engines[1].live[rid].logit_trace))


# ---------------------------------------------------------------------------
# the ring KV store (the reference's default block-device backend)
# ---------------------------------------------------------------------------
def _ring_scenario(m, shards, fork):
    jc = m[0]
    je, te = _pair(m, n_slots=3, max_len=64, kv_backend="ring",
                   kv_shards=shards)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jc.vocab_size, size=(6 + rid,))
               for rid in range(4)]
    for rid in range(2):
        _submit(je, te, rid, prompts[rid], 4)
    _lockstep(je, te, 2)
    if fork:
        assert je.fork(0, 100, 3) is not None
        assert te.fork(0, 100, 3) is not None
    for rid in range(2, 4):                # more requests than slots
        _submit(je, te, rid, prompts[rid], 4)
    _drain(je, te, 40)
    assert {rid: g.out_tokens for rid, g in je.live.items()} == \
        {rid: g.out_tokens for rid, g in te.live.items()}
    st = convert.to_numpy(te.state)
    assert (st["extent_owner"] < 0).all() and (st["vol_head"] < 0).all()
    assert te.volumes.engine.backend.consistent()
    return te


@pytest.mark.parametrize("shards", [1, 2])
def test_ring_serving_matches_jax(granite, shards):
    """``kv_backend="ring"``: the KV writes, a fork's clone and the
    sessions' deletes ride the ring's requests in-band. More requests than
    slots and a fork: each lock step gives the reference's tokens and
    logits, extent map, stacked metadata and pools (the module note); at
    the end nothing leaks and the replicas agree."""
    te = _ring_scenario(granite, shards, fork=True)
    assert te.volumes.engine.pool.step_counts.get(("read", "vol", "write"))


def test_ring_serving_matches_jax_gemma2(gemma2):
    """The same on gemma2-2b's smoke config (local and global layers, logit
    caps), without a fork: the reference's gemma2 forks read stale window
    rings (ROADMAP queue 3)."""
    _ring_scenario(gemma2, 1, fork=False)
