"""Port parity, property test: random byte spans through the public block
device (twin of tests/test_blockdev_properties.py's ``fused`` case, and the
same property on the ``upstream`` baseline; hypothesis).

Random interleavings of ``pwrite``/``pread``/``discard`` byte spans, biased
toward page edges, sub-block offsets and cross-extent lengths, go through
the JAX package's manager and the port's (``device="cpu"``) alike. Async
reads must return the bytearray reference's content at submission time in
both, and the whole device must read back equal to it.
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
PAGES = 8       # capacity = 256 bytes
_CAP = PAGES * PB * BB

_EDGES = sorted({0, 1, BB - 1, BB, BB + 1, PB * BB - 1, PB * BB,
                 PB * BB + 1, 2 * PB * BB - 1, _CAP - 1})
_OFF = st.one_of(st.sampled_from(_EDGES), st.integers(0, _CAP - 1))
_LEN = st.one_of(st.integers(0, 3 * BB), st.integers(0, 2 * PB * BB))
_OP = st.one_of(
    st.tuples(st.just("write"), _OFF, _LEN, st.integers(0, 250)),
    st.tuples(st.just("read"), _OFF, _LEN),
    st.tuples(st.just("discard"), _OFF, _LEN),
    st.tuples(st.just("flush")),
)

_MGRS = {}


def _pat(seed: int, n: int) -> bytes:
    return bytes((seed * 37 + i) % 251 for i in range(n))


def _mgrs(backend: str):
    if backend not in _MGRS:        # reuse: keeps the JAX programs warm
        kw = dict(backend=backend, payload_elems=BB, page_blocks=PB,
                  max_pages=PAGES, n_extents=512, max_volumes=16, batch=16)
        _MGRS[backend] = (JManager(**kw), VolumeManager(**kw, device="cpu"))
    return _MGRS[backend]


@pytest.mark.parametrize("backend", ["fused", "upstream", "ring"])
@settings(max_examples=15, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(ops=st.lists(_OP, max_size=14))
def test_property_random_byte_spans(backend, ops):
    mgrs = _mgrs(backend)
    vols = [m.create() for m in mgrs]
    assert vols[0].vid == vols[1].vid
    try:
        for m, v in zip(mgrs, vols):
            ref = bytearray(m.capacity)
            checks = []
            for op in ops:
                if op[0] == "write":
                    _, off, n, seed = op
                    n = min(n, m.capacity - off)
                    data = _pat(seed, n)
                    v.pwrite(off, data)
                    ref[off:off + n] = data
                elif op[0] == "read":
                    _, off, n = op
                    n = min(n, m.capacity - off)
                    checks.append((v.pread(off, n), bytes(ref[off:off + n])))
                elif op[0] == "discard":
                    _, off, n = op
                    n = min(n, m.capacity - off)
                    v.discard(off, n)
                    ref[off:off + n] = bytes(n)
                else:
                    m.flush()
            m.flush()
            for fut, want in checks:
                assert fut.result() == want
            assert v.read(0, m.capacity) == bytes(ref)
    finally:
        for m, v in zip(mgrs, vols):
            m.delete(v)
