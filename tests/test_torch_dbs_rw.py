"""Port parity: the ``dbs_rw`` kernels' wrappers and the kernel registry.

1. On the tests/test_dbs_rw.py geometries, held to batches that the real
   control plane (``write_pages``) emits, the port's registry entries —
   ``cuda`` (whose wrappers run the plain versions for CPU tensors),
   ``torch`` and ``ref`` — leave the pool bit-identical to JAX ``pallas``
   (interpret mode) and ``xla``; reads with holes agree too. Each on fp32,
   bf16 and uint8 pools (the Pallas kernels take any dtype, and so do the
   port's: they move bytes); the wrappers refuse a payload of another
   dtype than the pool's and elements of another size than 1, 2, 4 or 8
   bytes.
2. Multidimensional payloads, the registry API, the drop-``dst<0`` rule of
   the ``torch`` entry and the write-routing check.
3. The flattened-row form of the sharded pool (``write_stacked``/
   ``read_stacked``: one call over every shard) equals per-shard calls and
   the reference's ``jax.vmap`` of the kernels, dump rows included.
4. The CUDA kernels themselves are held against their plain versions on a
   card by tests/test_torch_kernels_gpu.py, which imports no JAX.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import Engine as JEngine  # noqa: E402
from repro.core import EngineConfig as JConfig  # noqa: E402
from repro.core import dbs as jdbs  # noqa: E402
from repro.kernels.dbs import dbs_rw_read_pool as j_read_pool  # noqa: E402
from repro.kernels.dbs import dbs_rw_write_pool as j_write_pool  # noqa: E402
from repro.kernels.dbs import make_kernel as j_make_kernel  # noqa: E402
from repro_torch.core import Engine, EngineConfig  # noqa: E402
from repro_torch.core import dbs as tdbs  # noqa: E402
from repro_torch.kernels.dbs import (LAUNCHES, PLAIN_CALLS,  # noqa: E402
                                     available_kernels, dbs_rw_read,
                                     dbs_rw_read_pool, dbs_rw_write,
                                     dbs_rw_write_pool, make_kernel,
                                     register_kernel, resolve_kernel_name)
from repro_torch.kernels.dbs.registry import _REGISTRY  # noqa: E402

PORT_KERNELS = ["cuda", "torch", "ref"]
DTYPES = ["float32", "bfloat16", "uint8"]      # pool dtypes of the twins


def _values(rng, shape, dtype="float32"):
    """Seeded pool or payload values in ``dtype``: normal draws (rounded to
    bf16 for ``bfloat16``), or random bytes for ``uint8``."""
    if dtype == "uint8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    x = rng.standard_normal(shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _tt(a):
    """A numpy array (bf16 through ml_dtypes) as a torch tensor."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bits(x):
    """The bytes of a torch tensor or a numpy/JAX array, for bit-for-bit
    comparison in any dtype."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _legal_batch(e, page, d, b, seed, dtype="float32"):
    """A write batch from the JAX control plane (so it is write_pages-legal):
    CoW after a snapshot and a clone (two lanes may share one CoW source),
    in-place pages, holes, duplicate-page groups with duplicate blocks,
    masked lanes and, on small pools, starvation. Returns numpy (pool,
    dst, cow_src, ok, payload, blocks)."""
    rng = np.random.default_rng(seed)
    n_p = 6
    bits = lambda blk: jnp.asarray(np.uint32(1) << blk.astype(np.uint32))
    st = jdbs.make_state(e - 1, 3, n_p)
    st, v0 = jdbs.create_volume(st)
    pre = rng.integers(0, n_p, 4).astype(np.int32)
    st, _ = jdbs.write_pages(st, v0, jnp.asarray(pre),
                             bits(np.zeros(4, np.int32)))
    st, _ = jdbs.snapshot(st, v0)
    st, v1 = jdbs.clone(st, v0)
    st, _ = jdbs.write_pages(st, v0, jnp.asarray(pre[:1]),
                             bits(np.zeros(1, np.int32)))   # in place next
    vol = rng.choice([int(v0), int(v1)], b).astype(np.int32)
    pages = rng.integers(0, n_p, b).astype(np.int32)
    blocks = rng.integers(0, page, b).astype(np.int32)
    mask = rng.random(b) < 0.8
    st, ops = jdbs.write_pages(st, jnp.asarray(vol), jnp.asarray(pages),
                               bits(blocks), jnp.asarray(mask))
    pool = _values(rng, (e, page, d), dtype)
    payload = _values(rng, (b, d), dtype)
    return (pool, np.array(ops.dst), np.array(ops.cow_src),
            np.array(ops.ok), payload, blocks)


def _jax_write(name, pool, dst, cow, ok, payload, blocks):
    ops = jdbs.WriteOps(dst=jnp.asarray(dst), cow_src=jnp.asarray(cow),
                        ok=jnp.asarray(ok))
    return np.asarray(j_make_kernel(name).write(
        jnp.asarray(pool), ops, jnp.asarray(payload), jnp.asarray(blocks)))


def _port_write(name, pool, dst, cow, ok, payload, blocks):
    ops = tdbs.WriteOps(dst=torch.from_numpy(dst), cow_src=torch.from_numpy(cow),
                        ok=torch.from_numpy(ok))
    p = _tt(pool.copy())
    out = make_kernel(name).write(p, ops, _tt(payload),
                                  torch.from_numpy(blocks))
    assert out.data_ptr() == p.data_ptr(), "write must update the pool in place"
    assert out.dtype == p.dtype
    return out.view(torch.uint8).numpy() if out.dtype == torch.bfloat16 \
        else out.numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("e,page,d,b", [(16, 4, 8, 8), (33, 8, 16, 12),
                                         (9, 2, 4, 16)])
@pytest.mark.parametrize("kernel", PORT_KERNELS)
def test_write_matches_jax_on_write_pages_batches(kernel, e, page, d, b,
                                                  seed, dtype):
    """Bit for bit in every pool dtype (the pool's bytes compared)."""
    args = _legal_batch(e, page, d, b, seed, dtype)
    got = _port_write(kernel, *args)
    for ref in ("pallas", "xla"):
        want = _jax_write(ref, *args)
        assert want.dtype == args[0].dtype, ref
        assert np.array_equal(_bits(got), _bits(want)), ref


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e,page,d,b", [(16, 4, 8, 8), (33, 8, 16, 20)])
@pytest.mark.parametrize("kernel", PORT_KERNELS)
def test_read_matches_jax_with_holes(kernel, e, page, d, b, dtype):
    """Hole lanes (ext < 0) read as zeros, not as clamped extent 0, in the
    pool's dtype."""
    rng = np.random.default_rng(e)
    pool = _values(rng, (e, page, d), dtype)
    lane = np.arange(b, dtype=np.int32)
    ext = np.where(lane % 3 == 0, -1, (lane * 7) % e).astype(np.int32)
    blocks = ((lane * 3) % page).astype(np.int32)
    got = make_kernel(kernel).read(_tt(pool), torch.from_numpy(ext),
                                   torch.from_numpy(blocks))
    assert got.dtype == _tt(pool).dtype
    for ref in ("pallas", "xla"):
        want = np.asarray(j_make_kernel(ref).read(
            jnp.asarray(pool), jnp.asarray(ext), jnp.asarray(blocks)))
        assert want.dtype == pool.dtype, ref
        assert np.array_equal(_bits(got), _bits(want)), ref
    assert not _bits(got[0]).any()


def test_wrappers_refuse_mixed_and_odd_dtypes():
    """``dbs_rw_write`` takes its payload in the pool's dtype (the pool
    wrapper casts, the kernel does not) and neither entry takes elements
    of 16 bytes; the refusals come before any dispatch."""
    i = torch.tensor([0, 3], dtype=torch.int32)
    none = torch.full((2, 2), -1, dtype=torch.int32)
    for dt, pay in ((torch.bfloat16, torch.float32),
                    (torch.uint8, torch.bfloat16),
                    (torch.float32, torch.float64)):
        pool = torch.zeros((4, 2, 4), dtype=dt)
        with pytest.raises(TypeError, match="payload"):
            dbs_rw_write(pool, i, i, none, torch.zeros((2, 4), dtype=pay))
    wide = torch.zeros((4, 2, 4), dtype=torch.complex128)
    with pytest.raises(TypeError, match="1, 2, 4 or 8"):
        dbs_rw_read(wide, i, i)
    with pytest.raises(TypeError, match="1, 2, 4 or 8"):
        dbs_rw_write(wide, i, i, none, torch.zeros((2, 4), dtype=wide.dtype))
    # the pool wrapper casts the payload to the pool's dtype
    pool = torch.zeros((4, 2, 4), dtype=torch.bfloat16)
    ops = tdbs.WriteOps(dst=torch.tensor([1], dtype=torch.int32),
                        cow_src=torch.tensor([-1], dtype=torch.int32),
                        ok=torch.tensor([True]))
    dbs_rw_write_pool(pool, ops, torch.full((1, 4), 1.5),
                      torch.tensor([1], dtype=torch.int32))
    assert pool[1, 1].tolist() == [1.5] * 4 and pool.dtype == torch.bfloat16


@pytest.mark.parametrize("kernel", PORT_KERNELS)
def test_write_and_read_vmap_safe(kernel):
    """tests/test_dbs_rw.py's vmap case in the port's flattened-row form:
    three shards, each with its own ``write_pages`` batch over its own pool,
    written by ONE ``write_stacked`` call (3*B lanes over the (3*E, page,
    d) view) and read by ONE ``read_stacked`` call with holes. Every row
    (each shard's dump row too) equals per-shard calls of the same entry
    and the reference's ``jax.vmap`` of its ``pallas`` kernels."""
    e, page, d, b, s = 16, 4, 8, 8, 3
    batches = [_legal_batch(e, page, d, b, seed) for seed in range(s)]
    pools, dst, cow, ok, pay, blk = (np.stack(x) for x in zip(*batches))
    kern = make_kernel(kernel)
    ops = tdbs.WriteOps(dst=torch.from_numpy(dst),
                        cow_src=torch.from_numpy(cow), ok=torch.from_numpy(ok))
    stacked = torch.from_numpy(pools.copy())
    out = kern.write_stacked(stacked, ops, torch.from_numpy(pay),
                             torch.from_numpy(blk))
    assert out.data_ptr() == stacked.data_ptr()
    per_shard = np.stack([_port_write(kernel, *bt) for bt in batches])
    jk = j_make_kernel("pallas")
    vw = jax.vmap(lambda p, dd, cc, oo, pp, bb: jk.write(
        p, jdbs.WriteOps(dst=dd, cow_src=cc, ok=oo), pp, bb))
    want = np.asarray(vw(*(jnp.asarray(x) for x in (pools, dst, cow, ok, pay,
                                                     blk))))
    assert np.array_equal(per_shard, want)
    assert np.array_equal(out.numpy(), want)
    lane = np.arange(b, dtype=np.int32)
    ext = np.stack([np.where((lane + i) % 3 == 0, -1, (lane * 5 + i) % e)
                    for i in range(s)]).astype(np.int32)
    got = kern.read_stacked(out, torch.from_numpy(ext),
                            torch.from_numpy(blk)).numpy()
    assert got.shape == (s, b, d)
    for i in range(s):
        assert np.array_equal(got[i], kern.read(
            out[i], torch.from_numpy(ext[i]),
            torch.from_numpy(blk[i])).numpy()), i
    vr = jax.vmap(lambda p, x, bb: jk.read(p, x, bb))
    assert np.array_equal(got, np.asarray(vr(jnp.asarray(want),
                                             jnp.asarray(ext),
                                             jnp.asarray(blk))))
    assert not got[ext < 0].any()


def test_rw_pool_wrappers_multidim_payload():
    """The pool wrappers flatten/restore trailing payload dims."""
    e, page, shape, b = 10, 4, (2, 3), 6
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((e, page) + shape).astype(np.float32)
    payload = rng.standard_normal((b,) + shape).astype(np.float32)
    lane = np.arange(b, dtype=np.int32)
    blocks = (lane % page).astype(np.int32)
    jops = jdbs.WriteOps(dst=jnp.asarray(lane),
                         cow_src=jnp.full((b,), -1, jnp.int32),
                         ok=jnp.ones((b,), bool))
    want = np.asarray(j_write_pool(jnp.asarray(pool), jops,
                                   jnp.asarray(payload), jnp.asarray(blocks)))
    tops = tdbs.WriteOps(dst=torch.from_numpy(lane),
                         cow_src=torch.full((b,), -1, dtype=torch.int32),
                         ok=torch.ones((b,), dtype=torch.bool))
    got = dbs_rw_write_pool(torch.from_numpy(pool.copy()), tops,
                            torch.from_numpy(payload),
                            torch.from_numpy(blocks))
    assert np.array_equal(got.numpy(), want)
    ext = np.asarray([0, -1, 2, 5, -1, 3], np.int32)
    rd = dbs_rw_read_pool(torch.from_numpy(pool), torch.from_numpy(ext),
                          torch.from_numpy(blocks))
    assert tuple(rd.shape) == (b,) + shape
    assert np.array_equal(rd.numpy(), np.asarray(j_read_pool(
        jnp.asarray(pool), jnp.asarray(ext), jnp.asarray(blocks))))


def test_torch_entry_drops_ok_lanes_without_dst():
    """A lane with ``ok=True, dst=-1`` writes nothing in every port entry,
    as in JAX ``pallas`` and ``ref``. JAX ``xla`` (``apply_write_ops``,
    which tests only ``ok``) writes it into extent 0: that divergence is
    why tests/test_dbs_rw.py::test_write_read_property fails on the
    reference. ``write_pages`` never emits such a lane."""
    e, page, d, b = 12, 4, 8, 6
    rng = np.random.default_rng(7)
    pool = rng.standard_normal((e, page, d)).astype(np.float32)
    payload = rng.standard_normal((b, d)).astype(np.float32)
    dst = np.asarray([3, -1, 5, -1, 3, 7], np.int32)
    cow = np.asarray([-1, -1, 9, -1, -1, -1], np.int32)
    ok = np.ones(b, bool)
    blocks = np.asarray([0, 1, 2, 3, 1, 0], np.int32)
    args = (pool, dst, cow, ok, payload, blocks)
    want = _jax_write("pallas", *args)
    assert np.array_equal(want, _jax_write("ref", *args))
    assert np.array_equal(want[0], pool[0])          # row 0 untouched
    for name in PORT_KERNELS:
        assert np.array_equal(_port_write(name, *args), want), name


def test_registry_lists_resolves_and_rejects():
    assert set(PORT_KERNELS) <= set(available_kernels())
    assert resolve_kernel_name(EngineConfig()) == "cuda"
    assert resolve_kernel_name(EngineConfig(kernel="torch")) == "torch"
    with pytest.raises(ValueError, match="unknown kernel"):
        make_kernel("nope")
    with pytest.raises(ValueError, match="unknown kernel"):
        Engine(EngineConfig(kernel="nope", device="cpu"))
    with pytest.raises(ValueError):
        register_kernel("broken", lambda *a: None)      # read= missing
    with pytest.raises(ValueError, match="duplicate"):
        register_kernel("torch", make_kernel("torch"))


def test_resolve_kernel_name_legacy_cow():
    """kernel= wins; kernel="auto" follows the legacy cow axis as the
    reference's does (pallas -> cuda, ref -> torch: the reference's
    pallas and xla), and an unknown cow raises in both packages."""
    assert resolve_kernel_name(EngineConfig(kernel="ref")) == "ref"
    assert resolve_kernel_name(EngineConfig(cow="pallas")) == "cuda"
    assert resolve_kernel_name(EngineConfig(cow="ref")) == "torch"
    assert resolve_kernel_name(EngineConfig(cow="ref",
                                            kernel="copy")) == "copy"
    assert resolve_kernel_name(EngineConfig()) == "cuda"
    assert make_kernel("torch").write is not make_kernel("cuda").write
    for cow in ("pallas", "ref"):
        eng = Engine(EngineConfig(cow=cow, device="cpu", n_extents=16,
                                  max_pages=8, payload_shape=(4,), batch=4))
        assert eng.impl._kernel == resolve_kernel_name(eng.cfg)
    with pytest.raises(ValueError, match="unknown cow impl"):
        Engine(EngineConfig(cow="bogus", device="cpu"))
    with pytest.raises(ValueError, match="unknown cow impl"):
        JEngine(JConfig(cow="bogus"))


def test_register_custom_kernel_roundtrip():
    base = make_kernel("torch")
    calls = []

    def write(pool, ops, payload, blocks):
        calls.append("w")
        return base.write(pool, ops, payload, blocks)

    try:
        register_kernel("traced", write, read=base.read)
        eng = Engine(EngineConfig(comm="fused", kernel="traced",
                                  payload_shape=(8,), n_extents=64,
                                  max_pages=32, batch=8, device="cpu"))
        vol = eng.create_volume()
        from repro_torch.core import Request
        eng.submit(Request(req_id=0, kind="write", volume=vol, page=0,
                           block=0, payload=np.ones(8, np.float32)))
        assert eng.drain() == 1
        assert calls, "custom kernel was not dispatched"
    finally:
        _REGISTRY.pop("traced", None)


def test_cpu_tensors_take_the_plain_version():
    """The wrappers choose by the tensors' device: on the CPU they call the
    plain version and count it, and launch nothing."""
    LAUNCHES.update(dbs_rw_write=0, dbs_rw_read=0)
    PLAIN_CALLS.update(dbs_rw_write=0, dbs_rw_read=0)
    pool = torch.zeros((4, 2, 4))
    i = torch.tensor([0, 3], dtype=torch.int32)
    dbs_rw_write(pool, i, i, torch.full((2, 2), -1, dtype=torch.int32),
                 torch.zeros((2, 4)))
    dbs_rw_read(pool, i, torch.zeros(2, dtype=torch.int32))
    assert PLAIN_CALLS == {"dbs_rw_write": 1, "dbs_rw_read": 1}
    assert LAUNCHES == {"dbs_rw_write": 0, "dbs_rw_read": 0}
    with pytest.raises(TypeError):
        dbs_rw_read(pool.to(torch.complex128), i, i)
    with pytest.raises(ValueError, match="contiguous"):
        dbs_rw_read(pool.transpose(0, 1).contiguous().transpose(0, 1), i, i)


def test_routing_check_rejects_racy_batches():
    """``check_routing`` accepts routed write_pages batches and rejects the
    two races the GPU would run: one row written by two lanes, and a lane
    reading a row that another lane writes."""
    e, page, d, b = 16, 4, 8, 8
    pool, dst, cow, ok, payload, blocks = _legal_batch(e, page, d, b, 0)
    ops = tdbs.WriteOps(dst=torch.from_numpy(dst), cow_src=torch.from_numpy(cow),
                        ok=torch.from_numpy(ok))
    dbs_rw_write_pool(torch.from_numpy(pool), ops, torch.from_numpy(payload),
                      torch.from_numpy(blocks), check_routing=True)
    dump = e - 1
    t = torch.from_numpy(pool.copy())
    pay = torch.from_numpy(payload)
    none = torch.full((b, page), -1, dtype=torch.int32)
    park = torch.full((b,), dump, dtype=torch.int32)
    two_writers = park.clone()
    two_writers[:2] = 3
    with pytest.raises(ValueError, match="two lanes"):
        dbs_rw_write(t, two_writers, two_writers, none, pay,
                     check_routing=True)
    src, dst_ = park.clone(), park.clone()
    src[0], dst_[0] = 5, 2              # lane 0 reads row 5 ...
    src[1], dst_[1] = 5, 5              # ... which lane 1 writes
    with pytest.raises(ValueError, match="another lane writes"):
        dbs_rw_write(t, src, dst_, none, pay, check_routing=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bytes_formulas_count_the_pool_dtype(dtype):
    """The dry run's bytes formulas of the three DBS entries (counted under
    ``utils/op_stats.py``'s mode, through the custom ops) take the pool's
    element size: a block is D * itemsize bytes, an id 4."""
    from repro_torch.kernels.dbs import dbs_copy
    from repro_torch.utils.op_stats import OpCounter
    e, page, d, b = 9, 4, 8, 3
    size = np.dtype(dtype).itemsize
    pool = _tt(_values(np.random.default_rng(0), (e, page, d), dtype))
    i = torch.tensor([1, 2, 8], dtype=torch.int32)
    blk = i % page
    lane_of = torch.full((b, page), -1, dtype=torch.int32)
    pay = pool[:b, 0].clone()
    nxt, mask = i + 1, torch.tensor([True, False, False])
    calls = {
        "read": (lambda: dbs_rw_read(pool, i, blk),
                 2 * b * d * size + 4 * 2 * b),
        "write": (lambda: dbs_rw_write(pool, i, i, lane_of, pay),
                  2 * b * page * d * size + b * d * size
                  + 4 * (2 * b + b * page)),
        "copy": (lambda: dbs_copy(pool, i, nxt, mask),
                 2 * b * page * d * size + 4 * 2 * b + b),
    }
    for name, (call, want) in calls.items():
        with OpCounter() as c:
            call()
        assert c.bytes == want, (name, c.bytes, want)
