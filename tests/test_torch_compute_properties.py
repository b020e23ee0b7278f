"""Port parity, property test: random byte writes followed by random
``Volume.compute`` calls (twin of tests/test_compute_properties.py;
hypothesis). The same examples go through the JAX package's manager and
the port's (``device="cpu"``) on the host oracle and the fused / sharded /
ring backends; every result must equal the other package's and the
registry's pure-Python mirror over a bytearray shadow that tracks the
volume byte for byte (a matching ``compare_and_write`` commits to the
shadow too), and the whole volume must read back as the shadow.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="hypothesis not installed")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core.blockdev import VolumeManager as JManager  # noqa: E402
from repro_torch.compute import make_storage_fn  # noqa: E402
from repro_torch.compute.functions import py_blocksum, py_i32  # noqa: E402
from repro_torch.core.blockdev import VolumeManager  # noqa: E402

BB = 16         # block_bytes
PB = 2          # page_blocks -> page_bytes = 32
PAGES = 8       # capacity = 256 bytes
CAP = BB * PB * PAGES

JAX_KERNEL = {"cuda": "pallas", "torch": "xla"}
MATRIX = [("host", 1, "cuda"), ("fused", 1, "cuda"), ("fused", 1, "torch"),
          ("sharded", 2, "cuda"), ("ring", 2, "cuda"), ("ring", 2, "torch"),
          ("ring", 1, "cuda")]

_MGRS = {}      # (backend, n_shards, kernel) -> [(manager, volume)] x 2


def _vols(backend, n_shards, kernel):
    key = (backend, n_shards, kernel)
    if key not in _MGRS:            # reused: keeps the JAX programs warm
        kw = dict(backend=backend, n_shards=n_shards, payload_elems=BB,
                  page_blocks=PB, max_pages=PAGES, n_extents=256,
                  max_volumes=16, batch=16, n_replicas=2)
        mgrs = (JManager(kernel=JAX_KERNEL[kernel], **kw),
                VolumeManager(kernel=kernel, device="cpu", **kw))
        _MGRS[key] = [(m, m.create()) for m in mgrs]
    return _MGRS[key]


_FNS = ("checksum", "scan_count", "filter_pages", "compare_and_write",
        "verify_on_read")

ops_st = st.lists(
    st.tuples(st.sampled_from(("write",) + _FNS),
              st.integers(0, 2 ** 30),      # position seed
              st.integers(0, 2 ** 30),      # arg / length seed
              st.binary(min_size=BB, max_size=BB)),
    min_size=1, max_size=6)


def _run(mgr, vol, base, ops):
    """The reference test's body on one manager; returns every result."""
    pby = mgr.page_bytes
    n_pages = CAP // pby
    vol.write(0, base)
    shadow = bytearray(base)
    out = []
    for kind, pos, aseed, blob in ops:
        if kind == "write":
            off = pos % CAP
            n = 1 + aseed % (CAP - off)
            data = (blob * (n // BB + 1))[:n]
            vol.write(off, data)
            shadow[off:off + n] = data
            continue
        entry = make_storage_fn(kind)
        if entry.scope == "range":
            p0 = pos % n_pages
            cnt = 1 + aseed % (n_pages - p0)
            off, nbytes = p0 * pby, cnt * pby
            arg = 0 if kind == "checksum" else (
                -1 if aseed % 5 == 0 else aseed % 256)
            want = entry.mirror(shadow, pby, BB, p0, cnt, arg, None)
            res = vol.compute(kind, off, nbytes, arg=arg).result()
        else:
            ab = pos % (CAP // BB)
            off = ab * BB
            cur = py_blocksum(shadow[off:off + BB])
            data = None
            if kind == "compare_and_write":
                data = blob
                arg = cur if aseed % 2 else py_i32((cur + 1) & 0xFFFFFFFF)
            else:
                arg = cur if aseed % 2 else py_i32(aseed or 1)
            want = entry.mirror(shadow, pby, BB, ab // PB, ab % PB, arg,
                                data)
            res = vol.compute(kind, off, arg=arg, data=data).result()
        assert (res.value, res.status) == (int(want[0]), int(want[1])), kind
        if want[2] is not None:
            if kind == "filter_pages":
                assert res.pages() == list(want[2])
            else:
                assert res.data() == bytes(want[2])
        out.append((res.value, res.status, res.payload.tolist()))
    assert vol.read(0, CAP) == bytes(shadow)
    return out


@pytest.mark.parametrize("backend,n_shards,kernel", MATRIX,
                         ids=[f"{b}{s}-{k}" for b, s, k in MATRIX])
@settings(max_examples=6, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(base=st.binary(min_size=CAP, max_size=CAP), ops=ops_st)
def test_random_computes_match_bytearray_oracle(backend, n_shards, kernel,
                                                base, ops):
    (jm, jv), (tm, tv) = _vols(backend, n_shards, kernel)
    assert _run(jm, jv, base, ops) == _run(tm, tv, base, ops)
