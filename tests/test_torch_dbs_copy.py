"""Port parity: the ``dbs_copy`` CoW extent copy and the ``copy`` entry.

1. ``dbs_copy_ref``, ``dbs_copy`` and ``dbs_copy_pool`` against the JAX
   ``dbs_copy`` on the tests/test_kernels.py sweep geometries, on fp32,
   bf16 and uint8 pools (the Pallas kernel takes any dtype; the port's
   kernel moves bytes), and against the JAX ``dbs_copy_pool`` with its
   ``scratch`` option both ways, bit for bit (a copy moves values
   unchanged).
2. The crafted and ``write_pages`` CoW batches of tests/test_fused.py
   through the port's ``copy`` registry entry against the JAX ``copy``
   entry, and a seeded byte trace through ``VolumeManager(backend="fused",
   kernel="copy")`` in both packages: identical bytes and replica state.
3. A live lane copying into extent 0 beside masked lanes whose ``dst`` is
   -1: the port's copy lands; the JAX ``dbs_copy`` and ``dbs_copy_ref``
   clamp the masked lanes onto extent 0 and write its old contents back
   over the copy (ROADMAP queue 3).
4. ``check_routing`` rejects batches that would race on the GPU, and CPU
   tensors take the plain version.

On the CPU the wrapper runs its plain version; tests/test_torch_kernels_gpu.py
holds the CUDA kernel against it on the card.
"""
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import dbs as JD  # noqa: E402
from repro.core.blockdev import VolumeManager as JManager  # noqa: E402
from repro.kernels.dbs import dbs_copy as j_copy  # noqa: E402
from repro.kernels.dbs import dbs_copy_pool as j_copy_pool  # noqa: E402
from repro.kernels.dbs import make_kernel as j_make_kernel  # noqa: E402
from repro.kernels.dbs.ref import dbs_copy_ref as j_copy_ref  # noqa: E402
from repro_torch.core import dbs as TD  # noqa: E402
from repro_torch.core.blockdev import VolumeManager  # noqa: E402
from repro_torch.kernels.dbs import (dbs_copy, dbs_copy_pool,  # noqa: E402
                                     dbs_copy_ref, make_kernel)
from repro_torch.kernels.dbs import copy_kernel  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_blockdev import (GEOM, _assert_same_replicas,  # noqa: E402
                                 _replay, _trace)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pool_values(rng, shape, dtype):
    """Seeded pool values: normal draws (rounded to bf16 for ``bfloat16``),
    or random bytes for ``uint8``."""
    if dtype == "uint8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    x = rng.standard_normal(shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _tp(a):
    """A numpy pool (bf16 through ml_dtypes) as a torch tensor."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _sweep_case(e, page, d, n, seed, dtype="float32"):
    """The tests/test_kernels.py sweep inputs, drawn with numpy: sources in
    the lower half, distinct destinations in the upper half, ~70% live."""
    rng = np.random.default_rng(seed)
    pool = _pool_values(rng, (e, page, d), dtype)
    src = rng.integers(0, e // 2, n).astype(np.int32)
    dst = (np.arange(n) + e // 2).astype(np.int32)
    mask = rng.random(n) < 0.7
    return pool, src, dst, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("e,page,d,n", [(16, 8, 32, 4), (8, 4, 16, 4)])
def test_copy_matches_jax_on_sweep(e, page, d, n, seed, dtype):
    """Bit for bit in every pool dtype (the pools' bytes compared); the
    wrapper counts its plain calls, not launches by dtype, on the CPU."""
    pool, src, dst, mask = _sweep_case(e, page, d, n, seed, dtype)
    want = np.asarray(j_copy(jnp.asarray(pool), jnp.asarray(src),
                             jnp.asarray(dst), jnp.asarray(mask)))
    assert want.dtype == pool.dtype
    bits = want.view(np.uint8)

    def got_bits(t):
        assert t.dtype == _tp(pool).dtype
        return t.view(torch.uint8).numpy()
    assert np.array_equal(
        np.asarray(j_copy_ref(jnp.asarray(pool), jnp.asarray(src),
                              jnp.asarray(dst), jnp.asarray(mask))
                   ).view(np.uint8), bits)
    copy_kernel.reset_counts()
    for fn in (dbs_copy_ref, dbs_copy):
        got = fn(_tp(pool.copy()), _t(src), _t(dst), _t(mask))
        assert np.array_equal(got_bits(got), bits), fn.__name__
    # int32 masks are taken as they are
    got = dbs_copy(_tp(pool.copy()), _t(src), _t(dst),
                   _t(mask.astype(np.int32)), check_routing=True)
    assert np.array_equal(got_bits(got), bits)
    assert copy_kernel.PLAIN_CALLS["dbs_copy"] == 2
    assert not any(copy_kernel.LAUNCHES_BY_DTYPE.values())


@pytest.mark.parametrize("scratch", [False, True])
def test_copy_pool_matches_jax(scratch):
    """(E, page, *payload) pools: trailing dims flattened; masked lanes
    carry -1 ids (the WriteOps NULL convention). The port's kernel skips
    masked lanes, so it has no ``scratch`` option: it must equal the JAX
    wrapper both with masked lanes routed to the dump row (the last row,
    which no live lane names) and with the appended zero row."""
    rng = np.random.default_rng(7)
    e, page = 17, 4
    pool = rng.standard_normal((e, page, 3, 5)).astype(np.float32)
    src = np.array([1, -1, 2, 3, -1, 0], np.int32)
    dst = np.array([9, -1, 10, 11, 12, 13], np.int32)
    mask = src >= 0
    want = np.asarray(j_copy_pool(jnp.asarray(pool), jnp.asarray(src),
                                  jnp.asarray(dst), jnp.asarray(mask),
                                  scratch=scratch))
    tp = _t(pool)
    out = dbs_copy_pool(tp, _t(src), _t(dst), _t(mask), check_routing=True)
    assert out is tp                                   # in place
    assert np.array_equal(out.numpy(), want)


def _crafted():
    """tests/test_fused.py's hand-built WriteOps: CoW, in place, hole fill,
    failed lanes (dst=-1) and a CoW landing on extent 0."""
    rng = np.random.default_rng(0)
    e, page, d = 16, 4, 8
    pool = rng.standard_normal((e, page, d)).astype(np.float32)
    dst = np.array([10, 2, -1, 0, 5, -1], np.int32)
    cow = np.array([1, -1, -1, 3, -1, 4], np.int32)
    ok = np.array([True, True, False, True, True, False])
    payload = rng.standard_normal((6, d)).astype(np.float32)
    blocks = np.array([0, 3, 1, 2, 1, 0], np.int32)
    return pool, dst, cow, ok, payload, blocks


def _write_pages_ops():
    """tests/test_fused.py's control-plane batches: fill pages, snapshot,
    then a masked overwrite in which every live lane CoWs; the pool after
    the fill and the second batch's ops."""
    rng = np.random.default_rng(1)
    st = JD.make_state(64, 2, 16)
    st, vol = JD.create_volume(st)
    pool = jnp.asarray(rng.standard_normal((65, 8, 4)).astype(np.float32))
    pages = jnp.arange(8)
    bits = jnp.full((8,), 1, jnp.uint32)
    st, ops = JD.write_pages(st, vol, pages, bits)
    blocks = np.arange(8, dtype=np.int32) % 8
    pay = rng.standard_normal((8, 4)).astype(np.float32)
    pool = JD.apply_write_ops(pool, ops, jnp.asarray(pay), jnp.asarray(blocks))
    st, _ = JD.snapshot(st, vol)
    st, ops = JD.write_pages(st, vol, pages, bits, jnp.arange(8) % 2 == 0)
    assert bool(jnp.any(ops.cow_src >= 0)), "expected CoW lanes"
    pay2 = rng.standard_normal((8, 4)).astype(np.float32)
    return (np.asarray(pool), np.asarray(ops.dst), np.asarray(ops.cow_src),
            np.asarray(ops.ok), pay2, blocks)


@pytest.mark.parametrize("case", [_crafted, _write_pages_ops])
def test_copy_entry_matches_jax_copy_entry(case):
    pool, dst, cow, ok, payload, blocks = case()
    jops = JD.WriteOps(dst=jnp.asarray(dst), cow_src=jnp.asarray(cow),
                       ok=jnp.asarray(ok))
    want = np.asarray(j_make_kernel("copy").write(
        jnp.asarray(pool), jops, jnp.asarray(payload), jnp.asarray(blocks)))
    tops = TD.WriteOps(dst=_t(dst), cow_src=_t(cow), ok=_t(ok))
    for name in ("copy", "torch"):
        got = make_kernel(name).write(_t(pool), tops, _t(payload), _t(blocks))
        assert np.array_equal(got.numpy(), want), name


@pytest.mark.parametrize("seed", [0, 1])
def test_copy_entry_trace_matches_jax(seed):
    """The block device on the ``copy`` entry: a seeded byte trace (CoW
    after snapshots and clones) through both packages."""
    jm = JManager(backend="fused", kernel="copy", **GEOM)
    tm = VolumeManager(backend="fused", kernel="copy", device="cpu", **GEOM)
    ops = _trace(seed, 70, jm.capacity)
    outs = ([], [])
    for m, out in zip((jm, tm), outs):
        vols = [m.create(), m.create()]
        _replay(m, ops, vols, out)
    assert outs[0] == outs[1]
    assert len(outs[1]) > 10
    _assert_same_replicas(jm, tm)


def test_masked_lanes_leave_a_copy_into_extent_0():
    """A live CoW into extent 0 followed by masked lanes with dst = -1.
    The port skips masked lanes, so the copy lands. The reference clamps
    their dst onto extent 0 and writes its old contents back after the
    copy, in its kernel (interpret mode) and in its plain version alike."""
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((8, 4, 16)).astype(np.float32)
    src = np.array([3, 5, 6], np.int32)
    dst = np.array([0, -1, -1], np.int32)
    mask = np.array([True, False, False])
    want = pool.copy()
    want[0] = pool[3]
    for fn in (dbs_copy_ref, dbs_copy):
        got = fn(_t(pool), _t(src), _t(dst), _t(mask)).numpy()
        assert np.array_equal(got, want), fn.__name__
    got = dbs_copy_pool(_t(pool), _t(src), _t(dst), _t(mask)).numpy()
    assert np.array_equal(got, want)
    for jfn in (j_copy, j_copy_ref):            # the reference's fault
        ref = np.asarray(jfn(jnp.asarray(pool), jnp.asarray(src),
                             jnp.asarray(dst), jnp.asarray(mask)))
        assert np.array_equal(ref[0], pool[0]), jfn.__name__
        assert np.array_equal(ref[1:], want[1:]), jfn.__name__


@pytest.mark.parametrize("src,dst,mask,msg", [
    ([1, 2], [5, 5], [True, True], "two live lanes write one row"),
    ([1, 5], [5, 6], [True, True], "reads a row"),
    ([1, -1], [8, 3], [True, True], "out of range"),
    ([1, 2], [5, 9], [True, True], "out of range"),
])
def test_check_routing_rejects_racy_batches(src, dst, mask, msg):
    pool = torch.zeros((9, 2, 4))
    with pytest.raises(ValueError, match=msg):
        dbs_copy(pool, _t(np.int32(src)), _t(np.int32(dst)), _t(mask),
                 check_routing=True)
    # the same lanes pass when the offending ones are masked
    ok = dbs_copy(pool, _t(np.int32(src)), _t(np.int32(dst)),
                  _t([True, False]), check_routing=True)
    assert ok is pool


def test_cpu_tensors_take_the_plain_version_and_inputs_are_checked():
    copy_kernel.reset_counts()
    pool = torch.zeros((4, 2, 3))
    dbs_copy(pool, _t(np.int32([0])), _t(np.int32([1])), _t([True]))
    assert copy_kernel.PLAIN_CALLS["dbs_copy"] == 1
    assert copy_kernel.LAUNCHES["dbs_copy"] == 0
    with pytest.raises(TypeError, match="1, 2, 4 or 8"):
        dbs_copy(pool.to(torch.complex128), _t(np.int32([0])),
                 _t(np.int32([1])), _t([True]))
    with pytest.raises(TypeError, match="bool or int32"):
        dbs_copy(pool, _t(np.int32([0])), _t(np.int32([1])), _t([1.0]))
    with pytest.raises(ValueError, match="shape"):
        dbs_copy(pool, _t(np.int32([0, 1])), _t(np.int32([1])), _t([True]))
