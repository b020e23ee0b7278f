"""The port's hand-written CUDA kernels against their plain versions.

Needs a CUDA device and ``nvcc`` (the kernels have no CPU mode), so every
test here is marked ``gpu`` and skips without a card. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

``dbs_rw``: the write batches come from the port's own ``write_pages`` (so
they keep the routing contract the GPU relies on): CoW after a snapshot and
a clone, in-place pages, holes, duplicate-page groups with colliding
blocks, masked lanes. Results must equal the plain versions bit for bit.

``dbs_copy``: the CPU parity geometries and the two full row widths (the
block device's 32 x 4096 floats, the serving baseline's 32 x 4 x 256), with
live CoW lanes, masked lanes with dst -1 and a live copy into extent 0, no
live lane, one, every lane live, and 1500 lanes (several compaction
windows); bit for bit against ``dbs_copy_ref``.

``dbs_rw_read`` on crafted batches: the zero-copy serving width, clamped
extent ids and block offsets, all holes, one lane, the scalar path, a
ragged chunk grid and more lanes than a grid's y dimension holds.

``dbs_rw_write`` also on crafted batches of only in-place writes and of
only CoW lanes, with D % 4 != 0, and at the zero-copy serving width.

``paged_attention`` and ``flash_attention``: fp32 kernels against their
plain versions on the card within atol 1e-4 and rtol 1e-4 (the sums run in
another order; flash's products are 3xTF32 on the tensor cores), on the
parity geometries of the CPU tests and at the serving path's full width
(gemma2-2b: 8 heads, 4 KV heads, hd 256, page 32); flash also on its
edges: head dims padded to 8, one query row, Sk >> Sq, rows that are not
16-byte aligned, windows narrower than a key tile. Paged also at the
serving width with p_max 64 and lengths up to 2048 (lengths on each side
of a share's boundary, a share of holes, length 0, windows that start
inside a share), under every split count the wrapper picks (one page a
share up to no split), GQA groups of 3 and 12, and where 16-byte copies
must not be used (hd not a multiple of 4, q one float off alignment).

On a machine with two cards, every kernel with a per-device setting
(flash and paged attention's shared-memory limit, the DBS kernels' SM
count) also runs on the second card after the first.

``rwkv6_scan``: the fp32 kernel against both plain versions (the chunked
schedule and the step-by-step oracle) within atol 1e-4 and rtol 1e-4, at
hd 16, 32 and 64, with ragged and prime lengths, a carried state ``s0``,
inputs read through the model layout's strides, and the serving path's
shapes (rwkv6-3b: 40 heads of 64; prefill B=1, decode B=8 and S=1); on
both sides of the decode schedule's threshold (S 1, 2, 8 and 9, hd 64,
40, 16 and 6); under strong decay (a chunk's log decay below -88, where
only the step oracle holds); and at hd 16, 32, 40 and 64 under every
column split the wrapper's rule picks on the card.

The controller slice on the card: a fused trace with a failed replica and
its streamed delta rebuild, bit for bit against the same run on the CPU,
and the upstream baseline's bytes against the CPU's.

The shards slice on the card: the flattened-row form (``write_stacked``/
``read_stacked``: one launch over S shards' lanes at offset rows) against
the plain versions over the same stacked pool, at S 1, 4 and 8, up to the
block device's width; and a sharded pool's trace with a per-shard failure
and rebuild, bit for bit against the same run on the CPU.

The ring slice on the card: a ring trace (``backend="ring"`` at 1 and 4
shards) whose pumps carry data, in-band control (snapshots, clones,
discards' unmaps, a delete, a shard's replica failed and rebuilt by
FAIL/REBUILD requests) and compute lanes (all five storage functions, a
compare-and-write that commits), bit for bit against the same run on the
CPU (the plain path: the kernel wrappers' plain versions); and one ring
pump with control lanes and one with compute lanes under
``torch.cuda.set_sync_debug_mode("error")``.

The durability slice on the card: a fused trace under the spill tier
(spills and fills both happen) gives the same reads, tier counters,
stamps and replica leaves as the same run on the CPU.

The chaos harness on the card: every catalog scenario at the catalog
geometry gives the same digest, completion ticks, events and counters as
the same run on the CPU. Imports no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dbs  # noqa: E402
from repro_torch.kernels.dbs import (dbs_copy, dbs_copy_pool,  # noqa: E402
                                     dbs_copy_ref, dbs_rw_read,
                                     dbs_rw_read_ref, dbs_rw_write,
                                     dbs_rw_write_ref)
from repro_torch.kernels.dbs import copy_kernel  # noqa: E402
from repro_torch.kernels.dbs.ops import _route_writes  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention, flash_attention_fwd,
    flash_attention_reference)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention_fwd, paged_attention_pool_fwd, paged_attention_pool_ref,
    paged_attention_ref)
from repro_torch.kernels.paged_attention.kernel import (  # noqa: E402
    paged_row_groups, paged_split_range, paged_splits)
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    rwkv6_chunked_ref, rwkv6_scan, rwkv6_scan_fwd, rwkv6_scan_ref)
from repro_torch.kernels.rwkv6_scan.kernel import (  # noqa: E402
    DECODE_MAX, padded_dim, rwkv6_info, rwkv6_n_col)

TOL = dict(atol=1e-4, rtol=1e-4)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _legal_batches(n_e, page, b, n_batches, seed):
    """Routed write batches from a seeded write_pages trace (CPU)."""
    rng = np.random.default_rng(seed)
    n_p = 4 * b
    st = dbs.make_state(n_e, 2, n_p, device=torch.device("cpu"))
    st, _ = dbs.create_volume(st)
    out = []

    def write(vols, pages, blocks, mask):
        nonlocal st
        st, ops = dbs.write_pages(
            st, torch.from_numpy(vols), torch.from_numpy(pages),
            torch.ones((), dtype=torch.int64) << torch.from_numpy(blocks),
            torch.from_numpy(mask))
        out.append(_route_writes(ops, page, torch.from_numpy(blocks), n_e))

    for i in range(n_batches):
        if i == 1:
            st, _ = dbs.snapshot(st, 0)
            st, _ = dbs.clone(st, 0)
        vols = rng.integers(0, 2 if i else 1, b).astype(np.int32)
        pages = rng.integers(0, n_p // 2, b).astype(np.int32)
        pages[b // 2:] = pages[:b - b // 2]          # duplicate-page groups
        blocks = rng.integers(0, page, b).astype(np.int64)
        write(vols, pages, blocks, rng.random(b) < 0.9)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("n_e,page,d,b", [(16, 4, 6, 8), (33, 8, 16, 12),
                                          (2048, 32, 4096, 64),
                                          (16, 32, 26624, 8)])
def test_cuda_kernels_match_plain_versions(n_e, page, d, b):
    """D=6 takes the scalar loop, D%4==0 the float4 one; the last two
    geometries are the main path's width and the zero-copy serving width
    (page 32, a 104 KiB block, 16 extents)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    pool = torch.rand((n_e + 1, page, d), generator=gen, device=dev)
    ref = pool.clone()
    for src, dst, lane_of in _legal_batches(n_e, page, b, 4, n_e):
        src, dst, lane_of = src.to(dev), dst.to(dev), lane_of.to(dev)
        pay = torch.rand((b, d), generator=gen, device=dev)
        dbs_rw_write(pool, src, dst, lane_of, pay, check_routing=True)
        dbs_rw_write_ref(ref, src, dst, lane_of, pay)
    torch.cuda.synchronize()
    assert torch.equal(pool, ref)
    lane = torch.arange(b, device=dev, dtype=torch.int32)
    ext = torch.where(lane % 3 == 0, -1, lane * 7 % (n_e + 1)).to(torch.int32)
    blk = (lane * 5 % page).to(torch.int32)
    got = dbs_rw_read(pool, ext, blk)
    assert torch.equal(got, dbs_rw_read_ref(pool, ext, blk))
    assert not got[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case,n_e,page,d,b", [
    ("serving", 1032, 32, 26624, 16), ("clamped_ext", 40, 32, 4096, 64),
    ("clamped_block", 40, 32, 4096, 64), ("all_holes", 40, 32, 26624, 16),
    ("one_lane", 40, 32, 26624, 1), ("one_lane", 40, 32, 4096, 1),
    ("scalar", 40, 32, 1027, 16), ("ragged", 40, 32, 4100, 7),
    ("many_lanes", 16, 4, 8, 70000)])
def test_dbs_rw_read_kernel_matches_plain(case, n_e, page, d, b):
    """The read kernel on its (lane, chunk) grid, bit for bit against the
    plain version: the zero-copy serving width (16 lanes of 104 KiB, a
    third of them holes); extent ids past the pool (clamped to its last
    row) and block offsets outside the page (clamped into it); every lane
    a hole (zeros); one lane; D 1027 (the scalar path); 7 lanes of D 4100
    (a lane count that is no multiple of the chunks a lane takes, and a
    ragged last chunk); more lanes than a grid's y dimension could hold."""
    dev = _cuda()
    rng = np.random.default_rng(d + b)
    gen = torch.Generator(device=dev).manual_seed(d)
    pool = torch.rand((n_e + 1, page, d), generator=gen, device=dev)
    ext = rng.integers(0, n_e + 1, b)
    blk = rng.integers(0, page, b)
    if case in ("serving", "scalar", "ragged", "many_lanes"):
        ext[rng.random(b) < 1 / 3] = -1
    elif case == "clamped_ext":
        ext[::3] = n_e + 1 + rng.integers(0, 1000, ext[::3].shape)
    elif case == "clamped_block":
        blk[::2] = rng.choice([-5, -1, page, page + 7], blk[::2].shape)
    elif case == "all_holes":
        ext[:] = -1
    ext, blk = (torch.from_numpy(x.astype(np.int32)).to(dev)
                for x in (ext, blk))
    got = dbs_rw_read(pool, ext, blk)
    want = dbs_rw_read_ref(pool, ext, blk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not got[ext < 0].any()
    if case == "all_holes":
        assert not got.any()


def _crafted_write_batch(kind, n_e, page, b, rng):
    """A routed batch of one kind: ``in_place`` (every lane writes its own
    row, src == dst) or ``all_cow`` (every lane copies a distinct source row
    into a distinct fresh row; the sources are no lane's destination). One
    lane is parked on the dump row. About a third of the blocks take a
    payload lane, any lane of the batch."""
    rows = rng.permutation(n_e)
    if kind == "in_place":
        src = dst = rows[:b]
    else:
        src, dst = rows[:b], rows[b:2 * b]
    src, dst = src.copy(), dst.copy()
    lane_of = np.where(rng.random((b, page)) < 0.35,
                       rng.integers(0, b, (b, page)), -1)
    src[-1] = dst[-1] = n_e                          # the dump row
    lane_of[-1] = -1
    return [torch.from_numpy(x.astype(np.int32)) for x in (src, dst, lane_of)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n_e,page,d,b", [
    ("in_place", 64, 32, 4096, 64), ("all_cow", 160, 32, 4096, 64),
    ("in_place", 40, 32, 1027, 16), ("all_cow", 40, 32, 1027, 16),
    ("all_cow", 17, 32, 26624, 8)])
def test_dbs_rw_write_crafted_batches(kind, n_e, page, d, b):
    """Batches of only in-place writes and of only CoW lanes, at the block
    device's width, with D % 4 != 0 (the scalar path) and at the zero-copy
    serving width: bit for bit against the plain version."""
    dev = _cuda()
    rng = np.random.default_rng(n_e * 7 + d)
    gen = torch.Generator(device=dev).manual_seed(d)
    pool = torch.rand((n_e + 1, page, d), generator=gen, device=dev)
    ref = pool.clone()
    for _ in range(2):
        src, dst, lane_of = (x.to(dev) for x in _crafted_write_batch(
            kind, n_e, page, b, rng))
        pay = torch.rand((b, d), generator=gen, device=dev)
        dbs_rw_write(pool, src, dst, lane_of, pay, check_routing=True)
        dbs_rw_write_ref(ref, src, dst, lane_of, pay)
    torch.cuda.synchronize()
    assert torch.equal(pool, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("e,page,d,n", [
    (16, 8, 32, 4), (8, 4, 16, 4), (16, 4, 6, 5), (256, 32, 4096, 64),
    (1032, 32, 1024, 26), (3010, 2, 8, 1500)])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32])
@pytest.mark.parametrize("live", ["mixed", "none", "one", "all"])
def test_dbs_copy_kernel_matches_plain(e, page, d, n, mask_dtype, live):
    """Sources in the lower half, distinct destinations in the upper half.
    ``mixed``: ~70% live, lane 0 copies live into extent 0 and the masked
    lanes carry dst -1; ``none``: every lane masked (the pool unchanged);
    ``one``: one live lane in the middle; ``all``: every lane live. d=6
    takes the scalar loop. The full widths: 512 KiB rows (the block device)
    and 128 KiB rows (the serving baseline at gemma2-2b); 1500 lanes span
    twelve of the kernel's 128-lane compaction windows."""
    dev = _cuda()
    rng = np.random.default_rng(e + d)
    gen = torch.Generator(device=dev).manual_seed(e)
    pool = torch.rand((e, page, d), generator=gen, device=dev)
    src = rng.integers(1, e // 2, n).astype(np.int32)
    dst = (np.arange(n) + e // 2).astype(np.int32)
    mask = {"mixed": rng.random(n) < 0.7, "none": np.zeros(n, bool),
            "one": np.arange(n) == n // 2, "all": np.ones(n, bool)}[live]
    if live == "mixed":
        mask[0], dst[0] = True, 0
    dst[~mask] = -1
    args = [torch.from_numpy(x).to(dev) for x in (src, dst, mask)]
    args[2] = args[2].to(mask_dtype)
    untouched = pool.clone()
    ref = dbs_copy_ref(pool.clone(), *args)
    before = copy_kernel.LAUNCHES["dbs_copy"]
    got = dbs_copy(pool, *args, check_routing=True)
    torch.cuda.synchronize()
    assert copy_kernel.LAUNCHES["dbs_copy"] == before + 1
    assert got is pool and torch.equal(pool, ref)
    if live == "none":
        assert torch.equal(pool, untouched)
    else:
        i = 0 if live == "mixed" else n // 2
        assert torch.equal(pool[int(dst[i])], untouched[int(src[i])])
    # the pool wrapper over (E, page, KV, hd)
    pool4 = torch.rand((e, page, 2, d), generator=gen, device=dev)
    ref4 = dbs_copy_ref(pool4.clone().view(e, page, -1), *args)
    dbs_copy_pool(pool4, *args)
    torch.cuda.synchronize()
    assert torch.equal(pool4.view(e, page, -1), ref4)


def _paged_case(dev, b, h, kv, d, page, p_max, e, seed, n_planes=0):
    """Pools, a block table with holes past each length and one hole BELOW
    a length, ragged lengths (one lane of length 0: all pages masked)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    q = torch.randn((b, h, d), generator=gen, device=dev)
    shape = (e, page, n_planes, kv, d) if n_planes else (e, page, kv, d)
    pool = torch.randn(shape, generator=gen, device=dev)
    table = rng.permutation(e - 1)[:b * p_max].reshape(b, p_max) + 1
    lengths = rng.integers(1, p_max * page + 1, b)
    lengths[0] = 0
    lengths[-1] = p_max * page
    for i in range(b):
        table[i, -(-lengths[i] // page):] = -1
    if p_max > 2:
        table[-1, 1] = -1
    return (q, pool, torch.from_numpy(table.astype(np.int32)).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv,d,page,p_max", [
    (4, 4, 2, 8, 4, 5), (2, 4, 2, 64, 8, 6), (3, 8, 4, 128, 16, 4),
    (2, 4, 1, 64, 8, 5), (1, 16, 16, 64, 32, 3), (8, 8, 4, 256, 32, 64)])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 50.0), (4096, 50.0)])
def test_paged_attention_kernel_matches_plain(b, h, kv, d, page, p_max,
                                              window, cap):
    """Split pools and the plane view of one engine pool; the last geometry
    is the serving path's full width (26 planes)."""
    dev = _cuda()
    e = b * p_max + 3
    q, pk, table, lengths = _paged_case(dev, b, h, kv, d, page, p_max, e, 1)
    _, pv, _, _ = _paged_case(dev, b, h, kv, d, page, p_max, e, 2)
    scale = 1.0 / np.sqrt(d)
    got = paged_attention_fwd(q, pk, pv, table, lengths, window=window,
                              logit_cap=cap, scale=scale)
    want = paged_attention_ref(q, pk, pv, table, lengths, window=window,
                               logit_cap=cap, scale=scale)
    torch.testing.assert_close(got, want, **TOL)
    if b > 1:
        assert not got[0].any()             # length 0: zeros, not NaN
    n_planes = 26 if d == 256 else 4
    _, pool, _, _ = _paged_case(dev, b, h, kv, d, page, p_max, e, 3,
                                n_planes=n_planes)
    for kp, vp in ((0, 1), (n_planes - 2, n_planes - 1)):
        got = paged_attention_pool_fwd(q, pool, table, lengths, k_plane=kp,
                                       v_plane=vp, window=window,
                                       logit_cap=cap)
        want = paged_attention_pool_ref(q, pool, table, lengths, k_plane=kp,
                                        v_plane=vp, window=window,
                                        logit_cap=cap)
        torch.testing.assert_close(got, want, **TOL)
    torch.cuda.synchronize()


def _paged_split_case(dev, lengths, *, b=8, h=8, kv=4, d=256, page=32,
                      p_max=64, n_planes=26, holes=(), seed=5):
    """The plane view of an engine pool at gemma2-2b's width (26 planes of
    (4, 256), page 32, 64 pages a row) with the given lengths; ``holes``
    are (lane, first page, last page) runs set to -1 below the length."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    e = b * p_max + 9
    q = torch.randn((b, h, d), generator=gen, device=dev)
    pool = torch.randn((e, page, n_planes, kv, d), generator=gen, device=dev)
    table = rng.permutation(e - 1)[:b * p_max].reshape(b, p_max) + 1
    lengths = np.asarray(lengths, np.int64)
    for i in range(b):
        table[i, -(-lengths[i] // page):] = -1
    for lane, p0, p1 in holes:
        table[lane, p0:p1] = -1
    return (q, pool, torch.from_numpy(table.astype(np.int32)).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev))


def _check_paged_pool(q, pool, table, lengths, **kw):
    got = paged_attention_pool_fwd(q, pool, table, lengths, k_plane=0,
                                   v_plane=1, **kw)
    want = paged_attention_pool_ref(q, pool, table, lengths, k_plane=0,
                                    v_plane=1, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("window,cap", [(0, 50.0), (4096, 50.0), (100, 0.0),
                                        (700, 30.0)])
def test_paged_attention_serving_width_splits(window, cap):
    """The serving width (8 sequences, 4 KV heads, hd 256, p_max 64, so
    ``paged_splits`` gives each (sequence, KV head) several pages a share)
    with lengths from 1 to 2048: lengths on each side of share boundaries
    (a share's last position, the next share's first), a share that is all
    holes below the length, a lane of length 0 (zeros, not NaN), and
    windows that start inside a share."""
    dev = _cuda()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = paged_splits(64, 8 * 4 * paged_row_groups(8, 4), sms, 2)
    assert 1 < n_split < 64
    # a last page that is full or holds one position: 13 live pages cut
    # into n_split shares put the last two pages in one share, 417
    # positions add a 14th page; 767 ends one position before a page
    lengths = [0, 2048, 416, 417, 767, 1, 1000, 33]
    # lane 1 (all 64 pages live): one whole share and more made of holes
    lo, hi = paged_split_range(2, n_split, 0, 64)
    q, pool, table, ln = _paged_split_case(
        dev, lengths, holes=[(1, lo - 1, hi + 1)])
    got = _check_paged_pool(q, pool, table, ln, window=window,
                            logit_cap=cap)
    assert not got[0].any()                 # length 0: zeros


@pytest.mark.gpu
@pytest.mark.parametrize("b,kv,g", [(1, 1, 2), (2, 2, 2), (8, 4, 2),
                                    (64, 8, 2), (2, 2, 3), (3, 1, 12)])
def test_paged_attention_split_counts(b, kv, g):
    """Every share size the wrapper picks, from one page a share (few
    sequences: n_split = p_max) to a single share (no merge), each
    length's last page on either side of a boundary; GQA groups of 3 (a
    block's fourth row is padding) and 12 (three row groups)."""
    dev = _cuda()
    rng = np.random.default_rng(b * 10 + kv + g)
    lengths = rng.integers(0, 16 * 8 + 1, b)
    lengths[0] = 16 * 8
    if b > 1:
        lengths[1] = 0
    q, pool, table, ln = _paged_split_case(
        dev, lengths, b=b, h=g * kv, kv=kv, d=64, page=8, p_max=16,
        n_planes=4, seed=b + kv + g)
    for window, cap in ((0, 0.0), (20, 50.0)):
        _check_paged_pool(q, pool, table, ln, window=window, logit_cap=cap)


@pytest.mark.gpu
@pytest.mark.parametrize("d,dv,misalign_q", [(6, 6, False), (8, 8, True),
                                             (8, 6, False), (13, 16, False)])
def test_paged_attention_four_byte_paths(d, dv, misalign_q):
    """Geometries where 16-byte loads must not be used: a head dim that is
    not a multiple of 4 (K, V or both), and q one float past an aligned
    base (K then goes through 4-byte copies, V through 16-byte ones)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(d * 31 + dv)
    rng = np.random.default_rng(d + dv)
    b, h, kv, page, p_max = 3, 4, 2, 4, 9
    e = b * p_max + 3
    q = torch.randn((b, h, d), generator=gen, device=dev)
    if misalign_q:
        buf = torch.randn(q.numel() + 1, generator=gen, device=dev)
        q = buf[1:].view(b, h, d)
        assert q.data_ptr() % 16
    pk = torch.randn((e, page, kv, d), generator=gen, device=dev)
    pv = torch.randn((e, page, kv, dv), generator=gen, device=dev)
    table = rng.permutation(e - 1)[:b * p_max].reshape(b, p_max) + 1
    lengths = np.array([p_max * page, 0, 17])
    for i in range(b):
        table[i, -(-lengths[i] // page):] = -1
    table[0, 3] = -1
    table = torch.from_numpy(table.astype(np.int32)).to(dev)
    lengths = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    for window, cap in ((0, 0.0), (10, 50.0)):
        got = paged_attention_fwd(q, pk, pv, table, lengths, window=window,
                                  logit_cap=cap)
        want = paged_attention_ref(q, pk, pv, table, lengths, window=window,
                                   logit_cap=cap)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        assert not got[1].any()


@pytest.mark.gpu
def test_paged_attention_rejects_wide_heads():
    """Head dims above the kernel's 256 raise, naming the limit."""
    dev = _cuda()
    q = torch.zeros((1, 2, 320), device=dev)
    pk = torch.zeros((3, 4, 1, 320), device=dev)
    table = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="256"):
        paged_attention_fwd(q, pk, pk, table, torch.ones(1, dtype=torch.int32,
                                                          device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d", [
    (2, 256, 256, 4, 2, 64), (1, 512, 512, 8, 2, 128),
    (2, 128, 128, 4, 4, 64), (1, 384, 384, 6, 1, 64), (1, 97, 97, 4, 2, 16),
    (1, 33, 70, 4, 2, 32), (1, 550, 550, 8, 4, 256), (1, 999, 999, 8, 4, 256)])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (96, 50.0), (4096, 30.0)])
def test_flash_attention_kernel_matches_plain(b, sq, sk, h, kv, d, window,
                                              cap):
    """Ragged and odd lengths (the last tiles are masked), Sq < Sk
    (suffix alignment), MQA, and the serving prefill's full width."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(sq * 7 + d)
    q = torch.randn((b, h, sq, d), generator=gen, device=dev)
    k = torch.randn((b, kv, sk, d), generator=gen, device=dev)
    v = torch.randn((b, kv, sk, d), generator=gen, device=dev)
    got = flash_attention_fwd(q, k, v, window=window, logit_cap=cap)
    want = attention_ref(q, k, v, window=window, logit_cap=cap)
    torch.testing.assert_close(got, want, **TOL)
    # the model layout (B,S,H,hd), read and written through strides
    qm, km, vm = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if sq == sk:
        got = flash_attention(qm, km, vm, window=window, logit_cap=cap)
        want = flash_attention_reference(qm, km, vm, window=window,
                                         logit_cap=cap)
        assert got.is_contiguous()
        torch.testing.assert_close(got, want, **TOL)
    torch.cuda.synchronize()


def _strided(t, layout, gen):
    """``t`` (B, N, S, hd) as a view whose rows are not 16-byte aligned:
    ``pad`` puts each row in a buffer row of hd + 1 floats (odd stride),
    ``offset`` starts the contiguous data one float past an aligned base."""
    b, n, s, d = t.shape
    if layout == "pad":
        buf = torch.randn((b, n, s, d + 1), generator=gen, device=t.device)
        view = buf[..., :d]
    else:
        buf = torch.randn(t.numel() + 1, generator=gen, device=t.device)
        view = buf[1:].view(b, n, s, d)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,window,cap,layout", [
    (1, 64, 64, 4, 2, 20, 0, 0.0, "contiguous"),      # d % 8 != 0
    (2, 100, 100, 4, 2, 72, 40, 50.0, "contiguous"),
    (1, 37, 37, 2, 1, 13, 0, 30.0, "contiguous"),     # d % 4 != 0
    (1, 1, 1, 4, 2, 64, 0, 0.0, "contiguous"),        # Sq 1
    (2, 1, 300, 8, 4, 256, 0, 50.0, "contiguous"),    # one query, many keys
    (1, 5, 5, 4, 4, 128, 0, 0.0, "contiguous"),       # < one query tile
    (1, 40, 1500, 8, 4, 256, 0, 50.0, "contiguous"),  # Sk >> Sq
    (1, 29, 2000, 4, 2, 64, 700, 0.0, "contiguous"),
    (1, 130, 130, 4, 2, 64, 0, 0.0, "pad"),           # 4-byte staging
    (2, 77, 90, 4, 2, 256, 64, 50.0, "offset"),
    (1, 200, 200, 4, 2, 64, 5, 0.0, "contiguous"),    # window < one key tile
    (1, 200, 200, 4, 2, 64, 1, 50.0, "contiguous"),
    (1, 550, 550, 8, 4, 256, 4096, 50.0, "contiguous"),   # serving, local
    (1, 550, 550, 8, 4, 256, 0, 50.0, "contiguous")])     # serving, global
def test_flash_attention_kernel_edge_cases(b, sq, sk, h, kv, d, window, cap,
                                           layout):
    """The tensor-core kernel's edges: head dims that need k-padding to 8,
    a single query and fewer rows than one 32-row query tile, many key
    tiles per query tile (suffix alignment), rows not 16-byte aligned (the
    4-byte cp.async path), windows narrower than one 32-key tile, and the
    serving prefill's shapes with cap 50; within TOL of attention_ref."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(sq * 13 + sk + d)
    q = torch.randn((b, h, sq, d), generator=gen, device=dev)
    k = torch.randn((b, kv, sk, d), generator=gen, device=dev)
    v = torch.randn((b, kv, sk, d), generator=gen, device=dev)
    if layout != "contiguous":
        q, k, v = (_strided(x, layout, gen) for x in (q, k, v))
        assert all(x.data_ptr() % 16 or x.stride(2) % 4 for x in (q, k, v))
    got = flash_attention_fwd(q, k, v, window=window, logit_cap=cap)
    want = attention_ref(q, k, v, window=window, logit_cap=cap)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
def test_kernels_on_a_second_device():
    """The raised dynamic shared-memory limit and the SM count are kept per
    device: flash (192000 bytes at hd 256) and paged attention (64 KiB of
    K/V pages at gemma2-2b's width) launch on card 0 and then on card 1,
    each against its plain version, and so do the read and copy kernels."""
    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for i in (0, 1):
        dev = torch.device("cuda", i)
        gen = torch.Generator(device=dev).manual_seed(i)
        q = torch.randn((1, 8, 100, 256), generator=gen, device=dev)
        k = torch.randn((1, 4, 100, 256), generator=gen, device=dev)
        v = torch.randn((1, 4, 100, 256), generator=gen, device=dev)
        torch.testing.assert_close(
            flash_attention_fwd(q, k, v, window=0, logit_cap=50.0),
            attention_ref(q, k, v, window=0, logit_cap=50.0), **TOL)
        q, pk, table, lengths = _paged_case(dev, 2, 8, 4, 256, 32, 4, 12, 1)
        _, pv, _, _ = _paged_case(dev, 2, 8, 4, 256, 32, 4, 12, 2)
        torch.testing.assert_close(
            paged_attention_fwd(q, pk, pv, table, lengths, logit_cap=50.0),
            paged_attention_ref(q, pk, pv, table, lengths, logit_cap=50.0),
            **TOL)
        pool = torch.rand((9, 32, 4096), generator=gen, device=dev)
        ext = torch.tensor([3, -1, 8, 0], dtype=torch.int32, device=dev)
        blk = torch.tensor([0, 5, 31, 7], dtype=torch.int32, device=dev)
        assert torch.equal(dbs_rw_read(pool, ext, blk),
                           dbs_rw_read_ref(pool, ext, blk))
        src, dst = (torch.tensor(x, dtype=torch.int32, device=dev)
                    for x in ([1, 2], [5, 6]))
        mask = torch.tensor([True, False], device=dev)
        want = dbs_copy_ref(pool.clone(), src, dst, mask)
        assert torch.equal(dbs_copy(pool, src, dst, mask), want)
        torch.cuda.synchronize(dev)


def _rwkv_case(dev, b, s, h, d, seed, with_state):
    """r, k, v and logw as views of one (B, S, 4, H, hd) buffer (the
    model layout's strides), u, and s0 (zeros unless ``with_state``)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randn((b, s, 4, h, d), generator=gen, device=dev)
    buf[:, :, 3] = -torch.exp(buf[:, :, 3] * 0.5 - 1.0)
    r, k, v, logw = buf.unbind(2)
    u = torch.randn((h, d), generator=gen, device=dev) * 0.1
    s0 = (torch.randn((b, h, d, d), generator=gen, device=dev)
          if with_state else torch.zeros((b, h, d, d), device=dev))
    return r, k, v, logw, u, s0


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,d,chunk", [
    (2, 128, 3, 64, 32), (1, 64, 2, 32, 64), (2, 96, 4, 16, 16),
    (1, 100, 2, 64, 64), (2, 97, 3, 32, 64), (3, 61, 2, 16, 16),
    (1, 513, 40, 64, 64), (8, 1, 40, 64, 64), (2, 1, 3, 16, 8)])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_scan_kernel_matches_plain(b, s, h, d, chunk, with_state):
    """The reference sweep's geometries, ragged (100 = 64 + 36) and prime
    lengths, the serving prefill (513 tokens: 8 full chunks and 1) and
    decode (B=8, S=1) at rwkv6-3b's width."""
    dev = _cuda()
    r, k, v, logw, u, s0 = _rwkv_case(dev, b, s, h, d, s * 31 + d,
                                      with_state)
    y, st = rwkv6_scan_fwd(r, k, v, logw, u, chunk=chunk,
                           s0=s0 if with_state else None)
    for want_y, want_s in (rwkv6_chunked_ref(r, k, v, logw, u, s0,
                                             chunk=chunk),
                           rwkv6_scan_ref(r, k, v, logw, u, s0)):
        torch.testing.assert_close(y, want_y, **TOL)
        torch.testing.assert_close(st, want_s, **TOL)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_rwkv6_scan_kernel_limits():
    """Beyond its shared-memory tiles the wrapper raises, naming the limit;
    ``rwkv6_scan`` is the same kernel; s0 may alias nothing it writes."""
    dev = _cuda()
    r, k, v, logw, u, s0 = _rwkv_case(dev, 1, 8, 2, 80, 0, True)
    with pytest.raises(ValueError, match="64"):
        rwkv6_scan_fwd(r, k, v, logw, u)
    r, k, v, logw, u, s0 = _rwkv_case(dev, 1, 8, 2, 32, 0, True)
    with pytest.raises(ValueError, match="64"):
        rwkv6_scan_fwd(r, k, v, logw, u, chunk=128)
    keep = s0.clone()
    y, st = rwkv6_scan(r, k, v, logw, u, s0=s0)
    assert torch.equal(s0, keep)
    want_y, want_s = rwkv6_scan_ref(r, k, v, logw, u, s0)
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(st, want_s, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 40, 16, 6])
@pytest.mark.parametrize("s", [1, 2, DECODE_MAX, DECODE_MAX + 1])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_scan_decode_threshold(d, s, with_state):
    """Both sides of the switch between the decode schedule (a warp per
    column slice, the state in registers) and the prefill one: S 1, 2, the
    threshold and one past it, at the serving decode's batch (8 x 40
    heads of 64), a head padded from 40 to 64, a narrow head and one that
    takes the 4-byte paths."""
    dev = _cuda()
    b, h = (8, 40) if d == 64 else (3, 5)
    r, k, v, logw, u, s0 = _rwkv_case(dev, b, s, h, d, s * 7 + d,
                                      with_state)
    info = rwkv6_info(b, s, h, d)
    assert info["schedule"] == (0 if s <= DECODE_MAX else 1)
    y, st = rwkv6_scan_fwd(r, k, v, logw, u, s0=s0 if with_state else None)
    want_y, want_s = rwkv6_scan_ref(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(st, want_s, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("s,chunk", [(200, 64), (130, 64), (97, 32)])
def test_rwkv6_scan_strong_decay(s, chunk):
    """logw about -3 a token: a 64-token chunk's decay sums to about -190,
    below fp32's exp range, where the reference's split form
    exp(cum_excl) * exp(-cum) overflows. The sub-chunk factors have no
    positive exponent, so the kernel stays finite and holds against the
    step oracle."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(s + chunk)
    b, h, d = 2, 3, 64
    r, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev)
               for _ in range(3))
    logw = -3.0 - 0.2 * torch.rand((b, s, h, d), generator=gen, device=dev)
    logw[:, :, :, :8] = -0.01            # some columns barely decay
    u = torch.randn((h, d), generator=gen, device=dev) * 0.1
    s0 = torch.randn((b, h, d, d), generator=gen, device=dev)
    assert float(logw[:, :chunk].sum(1).min()) < -88
    y, st = rwkv6_scan_fwd(r, k, v, logw, u, chunk=chunk, s0=s0)
    want_y, want_s = rwkv6_scan_ref(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(st, want_s, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 40])
def test_rwkv6_scan_every_column_split(d):
    """hd 16, 32 and 64 under every n_col the wrapper's rule can pick on
    this card (1 up to hd/8, from the batch x heads): the kernel reports
    the rule's choice, and each grid holds against the step oracle."""
    dev = _cuda()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    seen = set()
    for bh in (1, 2, sms // 4, sms // 2, sms, sms + 1, 2 * sms):
        b, h = (bh, 1) if bh <= 65535 else (1, bh)
        n_col = rwkv6_n_col(b, h, d, sms)
        if n_col in seen:
            continue
        seen.add(n_col)
        info = rwkv6_info(b, 70, h, d)
        assert info["schedule"] == 1 and info["n_col"] == n_col
        r, k, v, logw, u, s0 = _rwkv_case(dev, b, 70, h, d, bh + d, True)
        y, st = rwkv6_scan_fwd(r, k, v, logw, u, s0=s0)
        want_y, want_s = rwkv6_scan_ref(r, k, v, logw, u, s0)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, want_y, **TOL)
        torch.testing.assert_close(st, want_s, **TOL)
    dp = padded_dim(d)
    assert seen == {n for n in (1, 2, 4, 8) if (dp // n) % 8 == 0}


def _rebuild_run(device, backend):
    """A seeded byte trace on a 3-replica manager; on ``fused`` replica 1
    fails halfway and is delta-rebuilt at the end. Returns every read's
    bytes and, on ``fused``, each replica's state, pool and watermarks as
    numpy."""
    from repro_torch.core import convert
    from repro_torch.core.blockdev import VolumeManager
    rng = np.random.default_rng(7)
    mgr = VolumeManager(backend=backend, device=device, payload_elems=64,
                        page_blocks=8, max_pages=32, n_extents=256,
                        max_volumes=8, batch=16, n_replicas=3,
                        kernel="cuda")
    vols = [mgr.create(), mgr.create()]
    reads = []
    for i in range(240):
        if i == 120:
            vols[0].snapshot()
            vols.append(vols[0].clone())
            if backend == "fused":
                mgr.engine.control("fail", replica=1)
        v = vols[i % len(vols)]
        off = int(rng.integers(0, mgr.capacity - 256))
        if rng.random() < 0.6:
            v.pwrite(off, rng.integers(0, 256, int(rng.integers(1, 256)),
                                       dtype=np.uint8).tobytes())
        else:
            reads.append(v.pread(off, 200))
    mgr.flush()
    out = [f.result() for f in reads]
    if backend != "fused":
        return out, None
    g = mgr.engine.backend
    mgr.engine.control("rebuild", replica=1)
    assert g.transports[1].pages_moved > 0 and g.consistent()
    mgr.engine.control("fail", replica=0)
    mgr.engine.control("fail", replica=2)
    out += [v.read(0, mgr.capacity) for v in vols]   # replica 1 alone
    return out, [(convert.to_numpy(r.state), convert.to_numpy(r.pool),
                  convert.to_numpy(r.page_rev)) for r in g.replicas]


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["fused", "upstream"])
def test_rebuild_and_upstream_on_the_card_match_the_cpu(backend):
    """The controller slice on the card: after a seeded fused trace with a
    failure, the streamed delta rebuild leaves every replica's state, pool
    and watermarks bit-equal to the same run on the CPU, and the rebuilt
    replica alone reads back the same bytes; the upstream baseline returns
    the same bytes on the card as on the CPU."""
    dev = _cuda()
    (gpu_out, gpu_reps), (cpu_out, cpu_reps) = (
        _rebuild_run(dev, backend), _rebuild_run(torch.device("cpu"),
                                                 backend))
    assert gpu_out == cpu_out and len(gpu_out) > 50
    if backend != "fused":
        return

    def same(a, b, path):
        if isinstance(a, dict):
            for k in a:
                same(a[k], b[k], f"{path}.{k}")
            return
        assert np.array_equal(a, b), path
    for i, (a, b) in enumerate(zip(gpu_reps, cpu_reps)):
        for part, x, y in zip(("state", "pool", "page_rev"), a, b):
            same(x, y, f"replica {i} {part}")


@pytest.mark.gpu
@pytest.mark.parametrize("s,n_e,page,d,b", [(1, 33, 8, 16, 12),
                                            (4, 33, 8, 16, 12),
                                            (8, 16, 4, 6, 8),
                                            (4, 64, 32, 4096, 64)])
def test_flattened_rows_match_plain_versions(s, n_e, page, d, b):
    """One ``dbs_rw_write`` launch and one ``dbs_rw_read`` launch over S
    shards' write_pages batches (S*B lanes at rows offset by s*(E+1))
    leave the stacked pool and return the blocks bit for bit as the plain
    versions do over the same stacked pool."""
    from repro_torch.kernels.dbs import make_kernel
    from repro_torch.kernels.dbs import rw_kernel
    dev = _cuda()
    rng = np.random.default_rng(s * 100 + n_e)
    n_p = 4 * b
    ops, blocks = [], []
    for i in range(s):          # each shard's own write_pages batch
        st = dbs.make_state(n_e, 2, n_p, device=torch.device("cpu"))
        st, _ = dbs.create_volume(st)
        pages = rng.integers(0, n_p // 2, b).astype(np.int32)
        st, _ = dbs.write_pages(st, 0, torch.from_numpy(pages[:b // 2]),
                                torch.ones(b // 2, dtype=torch.int64))
        st, _ = dbs.snapshot(st, 0)
        blk = rng.integers(0, page, b).astype(np.int64)
        st, op = dbs.write_pages(
            st, 0, torch.from_numpy(pages),
            torch.ones((), dtype=torch.int64) << torch.from_numpy(blk),
            torch.from_numpy(rng.random(b) < 0.9))
        ops.append(op)
        blocks.append(blk.astype(np.int32))
    stacked = dbs.WriteOps(*(torch.stack([getattr(o, f) for o in ops]).to(dev)
                             for f in ("dst", "cow_src", "ok")))
    blk = torch.from_numpy(np.stack(blocks)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(s)
    pool = torch.rand((s, n_e + 1, page, d), generator=gen, device=dev)
    plain = pool.clone()
    pay = torch.rand((s, b, d), generator=gen, device=dev)
    before = dict(rw_kernel.LAUNCHES)
    make_kernel("cuda").write_stacked(pool, stacked, pay, blk)
    make_kernel("ref").write_stacked(plain, stacked, pay, blk)
    torch.cuda.synchronize()
    assert torch.equal(pool, plain)
    lane = torch.arange(b, device=dev, dtype=torch.int32)
    ext = torch.stack([torch.where((lane + i) % 3 == 0, -1,
                                   (lane * 7 + i) % n_e)
                       for i in range(s)]).to(torch.int32)
    got = make_kernel("cuda").read_stacked(pool, ext, blk)
    want = make_kernel("ref").read_stacked(plain, ext, blk)
    assert torch.equal(got, want) and not got[ext < 0].any()
    assert {k: rw_kernel.LAUNCHES[k] - before[k] for k in before} == {
        "dbs_rw_write": 1, "dbs_rw_read": 1}


def _sharded_run(device):
    """A seeded byte trace on a 3-replica, 4-shard pool with shard 1's
    replica 1 failed halfway and rebuilt at the end, then read from it
    alone. Returns every read's bytes and each replica's stacked state,
    pool and watermarks as numpy."""
    from repro_torch.core import convert
    from repro_torch.core.blockdev import VolumeManager
    rng = np.random.default_rng(9)
    mgr = VolumeManager(backend="sharded", n_shards=4, device=device,
                        payload_elems=64, page_blocks=8, max_pages=32,
                        n_extents=64, max_volumes=4, batch=16, n_replicas=3,
                        kernel="cuda")
    vols = [mgr.create() for _ in range(4)]
    reads = []
    for i in range(240):
        if i == 120:
            vols[1].snapshot()
            vols.append(vols[1].clone())
            mgr.engine.control("fail", shard=1, replica=1)
        v = vols[i % len(vols)]
        off = int(rng.integers(0, mgr.capacity - 256))
        if rng.random() < 0.6:
            v.pwrite(off, rng.integers(0, 256, int(rng.integers(1, 256)),
                                       dtype=np.uint8).tobytes())
        else:
            reads.append(v.pread(off, 200))
    mgr.flush()
    out = [f.result() for f in reads]
    g = mgr.engine.backend
    mgr.engine.control("rebuild", shard=1, replica=1)
    assert g.transports[1].pages_moved_by_shard[1] > 0 and g.consistent()
    mgr.engine.control("fail", shard=1, replica=0)
    mgr.engine.control("fail", shard=1, replica=2)
    out += [v.read(0, mgr.capacity) for v in vols]
    return out, [(convert.to_numpy(st), convert.to_numpy(p),
                  convert.to_numpy(r)) for st, p, r in zip(
                      g.states, g.pools, g.device_page_revs())]


@pytest.mark.gpu
def test_sharded_pool_on_the_card_matches_the_cpu():
    """The sharded pool on the card (the DBS kernels over flattened rows)
    leaves every stacked leaf bit-equal to the same run on the CPU, and the
    rebuilt slice alone reads back the same bytes."""
    dev = _cuda()
    (gpu_out, gpu_reps), (cpu_out, cpu_reps) = (
        _sharded_run(dev), _sharded_run(torch.device("cpu")))
    assert gpu_out == cpu_out and len(gpu_out) > 50

    def same(a, b, path):
        if isinstance(a, dict):
            for k in a:
                same(a[k], b[k], f"{path}.{k}")
            return
        assert np.array_equal(a, b), path
    for i, (a, b) in enumerate(zip(gpu_reps, cpu_reps)):
        for part, x, y in zip(("state", "pool", "page_rev"), a, b):
            same(x, y, f"replica {i} {part}")


def _ring_run(device, n_shards):
    """A seeded byte trace on a 3-replica ring with in-band control and
    storage functions aboard; shard 0's replica 1 failed and rebuilt by
    requests mid-trace. Returns every read's bytes, every compute result
    and each replica's stacked state, pool and watermarks as numpy."""
    from repro_torch.compute.functions import py_blocksum
    from repro_torch.core import convert
    from repro_torch.core.blockdev import VolumeManager
    rng = np.random.default_rng(11)
    mgr = VolumeManager(backend="ring", n_shards=n_shards, device=device,
                        payload_elems=64, page_blocks=8, max_pages=32,
                        n_extents=96, max_volumes=8, batch=16, n_replicas=3,
                        kernel="cuda")
    vols = [mgr.create() for _ in range(4)]
    reads, computes = [], []
    for i in range(240):
        v = vols[i % len(vols)]
        if i == 80:
            vols[1].snapshot()
            vols.append(vols[1].clone())
        if i == 100:
            mgr.engine.control("fail", shard=0, replica=1)
        if i == 150:
            mgr.engine.control("rebuild", shard=0, replica=1)
        if i == 200:
            vols.pop(2).delete()
        off = int(rng.integers(0, mgr.capacity - 256))
        r = rng.random()
        if r < 0.5:
            v.pwrite(off, rng.integers(0, 256, int(rng.integers(1, 256)),
                                       dtype=np.uint8).tobytes())
        elif r < 0.75:
            reads.append(v.pread(off, 200))
        elif r < 0.8:
            v.discard(off // 2, 2 * mgr.page_bytes)
        else:
            fn = ("checksum", "scan_count", "filter_pages",
                  "verify_on_read", "compare_and_write")[i % 5]
            blk = off // mgr.block_bytes * mgr.block_bytes
            if fn == "compare_and_write":
                cur = v.read(blk, mgr.block_bytes)
                computes.append(v.compute(fn, blk, arg=py_blocksum(cur),
                                          data=bytes([i % 256]) * 64))
            elif fn == "verify_on_read":
                computes.append(v.compute(fn, blk))
            else:
                computes.append(v.compute(fn, arg=i % 7 if i % 2 else -1))
    mgr.flush()
    out = [f.result() for f in reads]
    out += [(c.result().value, c.result().status,
             c.result().payload.tolist()) for c in computes]
    out += [v.read(0, mgr.capacity) for v in vols]
    g = mgr.engine.backend
    assert g.consistent() and g.healthy.all()
    return out, [(convert.to_numpy(st), convert.to_numpy(p),
                  convert.to_numpy(r)) for st, p, r in zip(
                      g.states, g.pools, g.device_page_revs())]


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", [1, 4])
def test_ring_on_the_card_matches_the_cpu(n_shards):
    """The ring on the card (the DBS kernels over flattened rows, the
    compute gathers through the read kernel, the in-band rebuild's in-place
    pool copy) leaves every stacked leaf bit-equal to the same run on the
    CPU, and every read and storage-function result equal."""
    dev = _cuda()
    (gpu_out, gpu_reps), (cpu_out, cpu_reps) = (
        _ring_run(dev, n_shards), _ring_run(torch.device("cpu"), n_shards))
    assert gpu_out == cpu_out and len(gpu_out) > 50

    def same(a, b, path):
        if isinstance(a, dict):
            for k in a:
                same(a[k], b[k], f"{path}.{k}")
            return
        assert np.array_equal(a, b), path
    for i, (a, b) in enumerate(zip(gpu_reps, cpu_reps)):
        for part, x, y in zip(("state", "pool", "page_rev"), a, b):
            same(x, y, f"replica {i} {part}")


@pytest.mark.gpu
def test_ring_pumps_do_not_sync():
    """One ring pump with control lanes (a snapshot, an unmap, a clone)
    and one with compute lanes (a whole-volume checksum and a committing
    compare-and-write) launch under sync-debug "error": the pump reads
    nothing back; its one host wait is the completion's event."""
    from repro_torch.compute.functions import py_blocksum
    from repro_torch.core.blockdev import VolumeManager
    from repro_torch.core.frontend import Request
    dev = _cuda()
    mgr = VolumeManager(backend="ring", n_shards=2, device=dev,
                        payload_elems=64, page_blocks=8, max_pages=32,
                        n_extents=96, max_volumes=8, batch=16, n_replicas=3)
    v = mgr.create()
    data = bytes(range(256)) * (mgr.capacity // 256)
    v.write(0, data)
    eng = mgr.engine.pool
    warm = [v.snapshot(), v.compute("checksum").result()]
    assert warm[0] >= 0 and warm[1].ok
    mgr.engine.backend.device_state()      # the health mask, cached
    rid = lambda: mgr._rid(v.vid)
    lanes = [[Request(req_id=rid(), kind="write", volume=v.vid, page=1,
                      block=2, payload=np.full(64, 5, np.float32)),
              Request(req_id=rid(), kind="snapshot", volume=v.vid),
              Request(req_id=rid(), kind="unmap", volume=v.vid, page=30),
              Request(req_id=rid(), kind="clone", volume=v.vid)],
             [Request(req_id=rid(), kind="compute", volume=v.vid,
                      fn="checksum", page=0, block=32),
              Request(req_id=rid(), kind="compute", volume=v.vid,
                      fn="compare_and_write", page=0, block=0,
                      arg=py_blocksum(data[:64]),
                      payload=np.zeros(64, np.float32))]]
    for batch in lanes:
        for r in batch:
            eng.submit(r)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            p = eng.pump_async()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert eng._complete(p) == len(batch)
        assert all(r.status == 0 for r in batch)
    assert v.read(0, 64) == bytes(64)          # the CAS committed


def _tier_run(device):
    """A seeded byte trace on a fused manager whose spill tier holds 6 of
    the ~16 mapped extents (writes, a snapshot and CoW overwrites, then
    every page read twice). Returns every read's bytes, the tier's
    counters and stamps, and each replica's state, pool and watermarks
    as numpy."""
    from repro_torch.core import convert
    from repro_torch.core.blockdev import VolumeManager
    rng = np.random.default_rng(21)
    mgr = VolumeManager(backend="fused", device=device, payload_elems=64,
                        page_blocks=8, max_pages=8, n_extents=64,
                        max_volumes=4, batch=16, n_replicas=3,
                        kernel="cuda", tier=6)
    vols = [mgr.create(), mgr.create()]
    pby = mgr.page_bytes
    for i in range(48):
        if i == 24:
            vols[0].snapshot()
        v = vols[i % 2]
        off = int(rng.integers(0, mgr.capacity - pby))
        v.pwrite(off, rng.integers(0, 256, int(rng.integers(1, pby)),
                                   dtype=np.uint8).tobytes())
    mgr.flush()
    out = [v.read(p * pby, pby) for _ in range(2) for v in vols
           for p in range(8)]
    tier = mgr.engine.impl.tier
    g = mgr.engine.backend
    return out, tier.to_dict(), tier.stamps.cpu().numpy(), [
        (convert.to_numpy(r.state), convert.to_numpy(r.pool),
         convert.to_numpy(r.page_rev)) for r in g.replicas]


@pytest.mark.gpu
def test_tiered_step_on_the_card_matches_the_cpu():
    """The durability slice on the card: the tiered fused step (the DBS
    kernels, the stamps' scatter-max, the pinned spill and fill copies)
    gives the same reads, tier counters, stamps, and every replica's
    state, pool (spilled rows zero) and watermarks as the same run on the
    CPU, where the kernel wrappers run their plain versions."""
    dev = _cuda()
    gpu, cpu = _tier_run(dev), _tier_run(torch.device("cpu"))
    assert gpu[0] == cpu[0] and len(gpu[0]) == 32
    assert gpu[1] == cpu[1]
    assert gpu[1]["spills"] > 0 and gpu[1]["fills"] > 0, gpu[1]
    np.testing.assert_array_equal(gpu[2], cpu[2])

    def same(a, b, path):
        if isinstance(a, dict):
            for k in a:
                same(a[k], b[k], f"{path}.{k}")
            return
        assert np.array_equal(a, b), path
    for i, (a, b) in enumerate(zip(gpu[3], cpu[3])):
        for part, x, y in zip(("state", "pool", "page_rev"), a, b):
            same(x, y, f"replica {i} {part}")


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "steady/local", "chaos/simnet", "chaos/async", "control/ring",
    "straggler/rr", "straggler/latency", "serve/steady", "compute/steady",
    "crash/journal"])
def test_harness_scenario_on_the_card_matches_the_cpu(name):
    """The chaos harness's scenario on the card (the DBS kernels) replays
    to the CPU run's digest: the same completion ticks, verification
    read-back bytes and retransmits, events and counters; both
    oracle-clean."""
    dev = _cuda()
    from repro_torch.harness import SCENARIOS, run_scenario
    assert name in SCENARIOS
    gpu = run_scenario(name, n_ops=60, device=dev)
    cpu = run_scenario(name, n_ops=60, device="cpu")
    assert gpu.ok, gpu.oracle_failures + gpu.harness_failures
    assert cpu.ok, cpu.oracle_failures + cpu.harness_failures
    for field in ("digest", "completion_ticks", "checked_reads",
                  "compute_checked", "crashes", "events_applied",
                  "events_skipped", "latency", "wait", "counters"):
        assert getattr(gpu, field) == getattr(cpu, field), field
