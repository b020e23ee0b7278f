"""Port parity, property test: fail -> streamed delta rebuild under random
write load (twin of tests/test_transport_properties.py; hypothesis).

Random block-aligned byte writes go through the public ``VolumeManager``
of both packages on the host-dispatch engine (``slots``), with replica 1
failed mid-stream, more writes landing on the survivor, and the failed
replica delta-rebuilt through the transport — over ``local``, ``device``
and ``simnet`` with drops (the same seed, so the same drops in both). In
both packages: ``pages_moved`` equals the distinct pages written while the
replica was down, reads forced onto each replica in turn match a
bytearray oracle, and the two packages' transports count the same
messages, deliveries and retransmits.
"""
import pytest

torch = pytest.importorskip("torch")
hyp = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core.blockdev import VolumeManager as JManager  # noqa: E402
from repro_torch.core.blockdev import VolumeManager  # noqa: E402

BB = 8          # block_bytes
PB = 4          # page_blocks -> page_bytes = 32
PAGES = 12      # capacity = 384 bytes

_W = st.tuples(st.integers(0, PAGES - 1), st.integers(0, PB - 1),
               st.integers(0, 250))

_MGRS = {}


def _pat(seed: int) -> bytes:
    return bytes((seed * 31 + i) % 251 for i in range(BB))


def _mgrs(transport: str):
    if transport not in _MGRS:      # reuse: keeps the JAX programs warm
        opts = (dict(latency=2, window=8, drop=0.2, seed=11)
                if transport == "simnet" else None)
        kw = dict(backend="slots", transport=transport, transport_opts=opts,
                  payload_elems=BB, page_blocks=PB, max_pages=PAGES,
                  n_extents=1024, max_volumes=16, batch=16)
        _MGRS[transport] = (JManager(**kw), VolumeManager(**kw,
                                                          device="cpu"))
    return _MGRS[transport]


def _counters(group):
    return [(dict(t.sent), t.delivered, t.retransmits, t.pages_moved)
            for t in group.transports] + [group.wait_ticks]


@pytest.mark.parametrize("transport", ["local", "device", "simnet"])
@settings(max_examples=10, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(pre=st.lists(_W, max_size=12), post=st.lists(_W, max_size=12))
def test_property_fail_delta_rebuild_under_load(transport, pre, post):
    mgrs = _mgrs(transport)
    vols = [m.create() for m in mgrs]
    ref = bytearray(mgrs[1].capacity)
    post_pages = {p for p, _, _ in post}
    all_pages = post_pages | {p for p, _, _ in pre}
    try:
        for m, v in zip(mgrs, vols):
            group = m.engine.backend
            for page, block, seed in pre:
                v.pwrite((page * PB + block) * BB, _pat(seed))
            m.flush()
            m.engine.control("fail", replica=1)    # mid-stream failure
            for page, block, seed in post:
                v.pwrite((page * PB + block) * BB, _pat(seed))
            m.flush()
            moved0 = group.transports[1].pages_moved
            m.engine.control("rebuild", replica=1)
            moved = group.transports[1].pages_moved - moved0
            assert moved == len(post_pages)
            if all_pages - post_pages:
                assert moved < len(all_pages)
        for page, block, seed in pre + post:
            off = (page * PB + block) * BB
            ref[off:off + BB] = _pat(seed)
        for m, v in zip(mgrs, vols):
            assert v.read(0, m.capacity) == bytes(ref)
            for serve, bench in ((1, 0), (0, 1)):
                m.engine.control("fail", replica=bench)
                assert v.read(0, m.capacity) == bytes(ref), \
                    f"replica {serve} diverged from the oracle"
                m.engine.control("rebuild", replica=bench)
            assert m.engine.backend.consistent()
        assert _counters(mgrs[0].engine.backend) == \
            _counters(mgrs[1].engine.backend)
    finally:
        for m, v in zip(mgrs, vols):
            m.delete(v)
