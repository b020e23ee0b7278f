"""Port parity: computational storage — the storage-function registry
(``repro_torch/compute``), the COMPUTE opcode class and ``Volume.compute``.

Twins of tests/test_compute.py. Each case runs the same byte traffic and
storage-function calls through the JAX package's ``VolumeManager`` and the
port's (``device="cpu"``: the kernel wrappers run their plain versions) on
the port's ``MATRIX`` (the host oracle; ``fused``, ``sharded`` at 2 shards
and ``ring`` at 2 shards, each on the ``cuda``, ``copy`` and ``torch``
kernel entries, against the reference's ``pallas``, ``copy`` and ``xla``)
and requires every result — value, status and payload lanes — bit for bit
equal between the packages and to the pure-Python mirror over a bytearray
shadow. The multi-chunk cases cut the port's ``VolumeView`` chunk to one
page, so every range function folds across chunk boundaries as it does at
the 1 GiB width.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.compute import register_storage_fn as j_register  # noqa: E402
from repro.compute import available_storage_fns as j_fns  # noqa: E402
from repro.core.blockdev import VolumeManager as JManager  # noqa: E402
from repro.core.frontend import Request as JRequest  # noqa: E402
from repro_torch.compute import (ST_MISMATCH,  # noqa: E402
                                 available_storage_fns, make_storage_fn,
                                 register_storage_fn, storage_fn_id)
from repro_torch.compute import phase  # noqa: E402
from repro_torch.compute.functions import py_blocksum, py_i32  # noqa: E402
from repro_torch.core.blockdev import VolumeManager  # noqa: E402
from repro_torch.core.frontend import Request  # noqa: E402

BB = 16         # block_bytes
PB = 4          # page_blocks -> page_bytes = 64
PAGES = 8       # capacity = 512 bytes

JAX_KERNEL = {"cuda": "pallas", "copy": "copy", "torch": "xla"}
MATRIX = [("host", 1, "cuda")] + [
    (b, s, k) for b, s in (("fused", 1), ("sharded", 2), ("ring", 2))
    for k in ("cuda", "copy", "torch")]
IDS = [f"{b}-{k}" for b, _, k in MATRIX]


def _mgrs(backend: str, n_shards: int = 1, kernel: str = "cuda", **kw):
    base = dict(backend=backend, n_shards=n_shards, payload_elems=BB,
                page_blocks=PB, max_pages=PAGES, n_extents=256,
                max_volumes=16, batch=16, n_replicas=2)
    base.update(kw)
    return (JManager(kernel=JAX_KERNEL[kernel], **base),
            VolumeManager(kernel=kernel, device="cpu", **base))


def _pat(seed: int, n: int) -> bytes:
    return bytes((seed * 37 + i * 11) % 251 for i in range(n))


def _mirror(fn: str, shadow: bytearray, page, block, arg=0, data=None):
    return make_storage_fn(fn).mirror(shadow, PB * BB, BB, page, block, arg,
                                      data)


def _res(r):
    return (r.fn, r.value, r.status, np.asarray(r.payload).tolist())


def _both(scenario, *mgr_args, **mgr_kw):
    """``scenario(mgr)`` on both packages' managers: the same results."""
    outs = []
    for mgr in _mgrs(*mgr_args, **mgr_kw):
        with mgr:
            outs.append(scenario(mgr))
    assert outs[0] == outs[1]
    return outs[1]


# ---------------------------------------------------------------------------
# 1. every built-in, bit-identical across packages and to the mirror
# ---------------------------------------------------------------------------
def _builtins(mgr):
    vol = mgr.create()
    shadow = bytearray(mgr.capacity)
    data = _pat(3, mgr.capacity - mgr.page_bytes)   # leave a hole page
    vol.write(0, data)
    shadow[:len(data)] = data
    n_pages = mgr.capacity // mgr.page_bytes
    out = []
    for p0, cnt in ((0, n_pages), (2, 3), (7, 1)):
        res = vol.compute("checksum", p0 * mgr.page_bytes,
                          cnt * mgr.page_bytes).result()
        assert (res.value, res.status) == _mirror("checksum", shadow, p0,
                                                  cnt)[:2]
        out.append(_res(res))
    present = data[5]
    for arg in (present, 250 if present != 250 else 249, -1, 0):
        res = vol.compute("scan_count", arg=arg).result()
        assert (res.value, res.status) == _mirror("scan_count", shadow, 0,
                                                  n_pages, arg)[:2], arg
        out.append(_res(res))
        res = vol.compute("filter_pages", arg=arg).result()
        want = _mirror("filter_pages", shadow, 0, n_pages, arg)
        assert (res.value, res.status) == want[:2], arg
        assert res.pages() == want[2], arg
        out.append(_res(res))
    off = 3 * BB
    cur = py_blocksum(shadow[off:off + BB])
    for arg in (0, cur):
        res = vol.compute("verify_on_read", off, arg=arg).result()
        want = _mirror("verify_on_read", shadow, (off // BB) // PB,
                       (off // BB) % PB, arg)
        assert res.ok and res.value == want[0]
        assert res.data() == bytes(want[2])
        out.append(_res(res))
    res = vol.compute("verify_on_read", off,
                      arg=py_i32((cur + 1) & 0xFFFFFFFF)).result()
    assert res.status == ST_MISMATCH and not res.ok and res.value == cur
    out.append(_res(res))
    hole = vol.compute("verify_on_read", (PAGES - 1) * PB * BB).result()
    assert hole.data() == bytes(BB)
    out.append(_res(hole))
    return out


@pytest.mark.parametrize("backend,n_shards,kernel", MATRIX, ids=IDS)
def test_builtins_match_mirror_on_every_backend(backend, n_shards, kernel):
    _both(_builtins, backend, n_shards, kernel)


@pytest.mark.parametrize("backend,n_shards", [("ring", 2), ("ring", 1),
                                              ("fused", 1), ("host", 1)])
def test_builtins_fold_across_chunks(backend, n_shards, monkeypatch):
    """One page a chunk: every range function folds across chunk
    boundaries, as at the block device's width (64 pages a chunk)."""
    monkeypatch.setattr(phase, "CHUNK_BYTES", PB * BB * 4)
    _both(_builtins, backend, n_shards)


def _cas(mgr):
    vol = mgr.create()
    vol.write(0, _pat(7, mgr.capacity))
    off = 2 * BB
    old = vol.read(off, BB)
    new = _pat(9, BB)
    res = vol.compute("compare_and_write", off, data=new,
                      arg=py_i32((py_blocksum(old) + 1) & 0xFFFFFFFF)
                      ).result()
    assert res.status == ST_MISMATCH
    assert res.value == py_blocksum(old)
    assert vol.read(off, BB) == old
    out = [_res(res)]
    res = vol.compute("compare_and_write", off, data=new,
                      arg=py_blocksum(old)).result()
    assert res.ok and res.value == py_blocksum(old)
    assert vol.read(off, BB) == new
    out.append(_res(res))
    return out + [vol.read(0, mgr.capacity)]


@pytest.mark.parametrize("backend,n_shards,kernel", MATRIX, ids=IDS)
def test_compare_and_write_commit_and_mismatch(backend, n_shards, kernel):
    _both(_cas, backend, n_shards, kernel)


def test_cas_is_cow_snapshot_preserved():
    def scenario(mgr):
        vol = mgr.create()
        vol.write(0, _pat(1, mgr.capacity))
        old = vol.read(0, BB)
        snap = vol.snapshot()
        new = _pat(2, BB)
        res = vol.compute("compare_and_write", 0, data=new,
                          arg=py_blocksum(old)).result()
        assert res.ok and vol.read(0, BB) == new
        child = vol.clone()
        assert child is not None and child.read(0, BB) == new
        return [snap, child.vid, _res(res)]
    _both(scenario, "ring", 2)


# ---------------------------------------------------------------------------
# 3. in-band ordering on the ring
# ---------------------------------------------------------------------------
def test_ring_compute_ordered_with_writes_in_one_drain():
    def scenario(mgr):
        vol = mgr.create()
        a, b = _pat(4, BB), _pat(5, BB)
        f1 = vol.pwrite(0, a)
        c1 = vol.compute("verify_on_read", 0)
        f2 = vol.pwrite(0, b)
        c2 = vol.compute("verify_on_read", 0)
        mgr.flush()
        assert (f1.result(), f2.result()) == (BB, BB)
        assert c1.result().data() == a and c2.result().data() == b
        return [_res(c1.result()), _res(c2.result())]
    _both(scenario, "ring", 2)


def test_ring_compute_with_control_on_sibling_shard():
    def scenario(mgr):
        v0, v1 = mgr.create(), mgr.create()
        data = _pat(6, mgr.capacity)
        v1.write(0, data)
        mgr.flush()
        R = Request if isinstance(mgr, VolumeManager) else JRequest
        r = R(req_id=1 << 20, kind="snapshot", volume=v0.vid)
        mgr.engine.submit(r)
        fut = v1.compute("verify_on_read", 0)
        mgr.flush()
        assert r.status == 0 and fut.result().data() == data[:BB]
        return [r.result, _res(fut.result())]
    _both(scenario, "ring", 2)


def test_ring_batch_mixes_data_and_compute_lanes():
    def scenario(mgr):
        vol = mgr.create()
        old = _pat(8, BB)
        vol.write(0, old)
        new = _pat(9, BB)
        f_cas = vol.compute("compare_and_write", 0, data=new,
                            arg=py_blocksum(old))
        f_read = vol.pread(0, BB)
        mgr.flush()
        assert f_cas.result().ok and f_read.result() == new
        return [_res(f_cas.result()), f_read.result()]
    _both(scenario, "ring", 1)


# ---------------------------------------------------------------------------
# 4. registry + API surface
# ---------------------------------------------------------------------------
def test_registry_order_defines_fn_ids():
    fns = available_storage_fns()
    assert fns[:5] == ("checksum", "scan_count", "filter_pages",
                       "compare_and_write", "verify_on_read")
    assert fns[:5] == j_fns()[:5]
    for i, name in enumerate(fns):
        assert storage_fn_id(name) == i
    assert make_storage_fn("compare_and_write").writes
    assert make_storage_fn("verify_on_read").scope == "block"


def test_unknown_fn_raises_naming_registered():
    with pytest.raises(ValueError, match="checksum"):
        make_storage_fn("nope")
    for mgr in _mgrs("host"):
        vol = mgr.create()
        with pytest.raises(ValueError, match="unknown storage function"):
            vol.compute("nope")
    with pytest.raises(ValueError, match="duplicate storage function"):
        register_storage_fn("checksum", apply=lambda *a: None)
    with pytest.raises(ValueError, match="scope"):
        register_storage_fn("bad_scope", apply=lambda *a: None, scope="x")


def test_compute_validates_scope_alignment_and_data():
    for mgr in _mgrs("ring"):
        vol = mgr.create()
        with pytest.raises(ValueError, match="page-aligned"):
            vol.compute("checksum", 3)
        with pytest.raises(ValueError, match="block-aligned"):
            vol.compute("verify_on_read", 5)
        with pytest.raises(ValueError, match="exactly one block"):
            vol.compute("verify_on_read", 0, 2 * BB)
        with pytest.raises(ValueError, match="pass data="):
            vol.compute("compare_and_write", 0)
        with pytest.raises(ValueError, match="one block"):
            vol.compute("compare_and_write", 0, data=b"x")
        with pytest.raises(ValueError, match="does not take data"):
            vol.compute("checksum", data=b"y" * BB)
        with pytest.raises(ValueError, match="outside"):
            vol.compute("verify_on_read", mgr.capacity)


def _j_sum(content, page, block, arg, payload):
    s = content.reshape(-1).astype(jnp.int32).sum()
    return s, jnp.int32(0), jnp.zeros_like(payload), jnp.asarray(False)


def _t_sum(view, page, block, arg, payload):
    """The same function in the port's idiom: a fold over the view's
    chunks of the whole volume."""
    s = torch.zeros((), dtype=torch.int32, device=view.device)
    for _p0, lanes in view.chunks(0, view.n_pages):
        s = s + lanes.to(torch.int32).sum(dtype=torch.int32)
    return s, 0, torch.zeros_like(payload), False


def _sum_mirror(shadow, page_bytes, block_bytes, page, block, arg, data):
    return sum(shadow), 0, None


@pytest.mark.parametrize("backend,n_shards", [("ring", 1), ("ring", 2),
                                              ("fused", 1), ("host", 1)])
def test_custom_storage_fn_registers_and_runs(backend, n_shards):
    """The embedder surface: the same function registered in both packages
    runs on a live manager (after the built-ins already ran on it) and
    agrees with its mirror."""
    name = "test_byte_sum"
    if name not in j_fns():
        j_register(name, apply=_j_sum, host_ref=_j_sum, mirror=_sum_mirror)
    if name not in available_storage_fns():
        register_storage_fn(name, apply=_t_sum, mirror=_sum_mirror)
    assert storage_fn_id(name) == j_fns().index(name)

    def scenario(mgr):
        vol = mgr.create()
        data = _pat(11, mgr.capacity)
        vol.write(0, data)
        first = vol.compute("checksum").result()
        res = vol.compute(name).result()
        assert res.value == sum(data) and res.ok
        return [_res(first), _res(res)]
    _both(scenario, backend, n_shards)


def test_compute_on_null_storage_raises():
    for mgr in _mgrs("fused", null_storage=True):
        with pytest.raises(ValueError, match="storage functions"):
            with mgr:
                vol = mgr.create()
                vol.compute("checksum").result()


def test_compute_on_chained_storage_raises():
    for mgr in _mgrs("slots", storage="chained"):
        vol = mgr.create()
        with pytest.raises(ValueError, match="storage functions"):
            vol.compute("checksum").result()


@pytest.mark.parametrize("backend", ["slots", "loop"])
def test_compute_on_host_dispatch_backends(backend):
    """``slots`` and ``loop`` run the per-call device executor too."""
    _both(_cas, backend, 1, "torch")
