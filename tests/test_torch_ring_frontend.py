"""Port parity: the host half of the ring — ``RingFrontend``'s drain.

The same seeded request stream (reads, writes and control ops over several
volumes, shards and queues, with requeued starved suffixes) goes into the
JAX and the port ``RingFrontend``. Every drain returns the same requests in
the same lanes, the same staged lanes (``_stage``; ``drain_ring`` moves
them to the device), the same opcode classes, and stamps the same
submission ticks and drain latencies: the batch-ordering contract (data
before control, a replica op closes the batch, at most CTRL_TAIL control
ops) is the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.frontend import Request as JRequest  # noqa: E402
from repro.core.ring import RingFrontend as JRing  # noqa: E402
from repro_torch.core.frontend import Request  # noqa: E402
from repro_torch.core.ring import RingFrontend  # noqa: E402

KINDS = ["read", "write", "write", "read", "noop", "snapshot", "clone",
         "unmap", "delete", "fail", "rebuild"]


def _stream(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = KINDS[rng.integers(len(KINDS))] if rng.random() < 0.3 \
            else ("read", "write")[rng.integers(2)]
        pay = (rng.integers(0, 256, 4).astype(np.float32)
               if kind == "write" else None)
        out.append(dict(req_id=i, kind=kind, volume=int(rng.integers(0, 6)),
                        page=int(rng.integers(0, 8)),
                        block=int(rng.integers(0, 4)), payload=pay,
                        shard=(int(rng.integers(0, 2))
                               if kind in ("fail", "rebuild") else None)))
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n_shards,n_queues,batch", [(1, 4, 8), (2, 3, 5)])
def test_ring_drain_matches_jax(seed, n_shards, n_queues, batch):
    jr = JRing(n_shards, n_queues, n_slots=16, batch=batch, with_table=False)
    tr = RingFrontend(n_shards, n_queues, n_slots=16, batch=batch)
    stream = _stream(seed, 60)
    jreqs = [JRequest(**kw) for kw in stream]
    treqs = [Request(**kw) for kw in stream]
    rng = np.random.default_rng(seed + 10)
    for step in range(40):
        for _ in range(int(rng.integers(0, 4))):       # trickle submissions
            if jreqs:
                jr.submit(jreqs.pop(0))
                tr.submit(treqs.pop(0))
        jd, jst, jcls = jr._stage((4,))
        if step % 2:
            td, tst, tcls = tr.drain_ring((4,), device="cpu")
            tst = None if tst is None else {k: v.numpy()
                                            for k, v in tst.items()}
        else:
            td, tst, tcls = tr._stage((4,))
        assert jcls == tcls
        assert [[r.req_id for r in s] for s in jd] == \
            [[r.req_id for r in s] for s in td]
        assert (jst is None) == (tst is None)
        if jst is not None:
            assert jst.keys() == tst.keys()
            for k in jst:
                assert np.array_equal(jst[k], tst[k]), k
        for js, ts in zip(jd, td):
            for a, b in zip(js, ts):
                assert (a.tick, a.latency) == (b.tick, b.latency)
            # starve the suffix of every other batch, as admission does
            if step % 3 == 0 and len(js) > 1:
                jr.requeue_all(js[len(js) // 2:])
                tr.requeue_all(ts[len(ts) // 2:])
    assert jr.depth() == tr.depth()


def test_compute_kind_lands_later():
    """COMPUTE requests resolve their function name to the registry id at
    submit, as the reference's do (the same ids: both registries list the
    built-ins in one order), and a writing function closes the batch's
    compute window; unknown names and kinds raise at submit."""
    jr, tr = JRing(1, 2, 8, with_table=False), RingFrontend(1, 2, 8)
    for ring, R in ((jr, JRequest), (tr, Request)):
        for i, fn in enumerate(("checksum", "compare_and_write",
                                "verify_on_read")):
            ring.submit(R(req_id=i, kind="compute", volume=0, fn=fn))
        with pytest.raises(ValueError, match="unknown storage function"):
            ring.submit(R(req_id=9, kind="compute", volume=0, fn="nope"))
        with pytest.raises(ValueError, match="unknown request kind"):
            ring.submit(R(req_id=9, kind="bogus", volume=0))
    jd, jst, jcls = jr._stage((4,))
    td, tst, tcls = tr._stage((4,))
    assert jcls == tcls == {"compute"}
    assert [r.fnid for r in jd[0]] == [r.fnid for r in td[0]] == [0, 3]
    for k in jst:
        assert np.array_equal(jst[k], tst[k]), k
    assert jr.depth() == tr.depth() == 1
