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
the same run on the CPU.

The hybrid and MoE families: paged and flash attention at hymba's and
granite-moe's GQA groups (25 query heads over 5 KV heads, G=5: one full
row group of 4 and a partial one; 24 over 8, G=3) at hd 64, flash also
with hymba's 1024-token window on prompts past it; the Mamba branch at
hymba's width (E 3200, N 16) on the card against the same function on the
CPU (atol 1e-4, rtol 1e-4: the products and the scan sum in other orders
on the card); and the MoE at granite-moe's width for a decode batch
under ``torch.cuda.set_sync_debug_mode("error")``, against the same on
the CPU.

Training and checkpoints: one train step at smoke width (gemma2-2b,
hymba-1.5b, granite-moe-3b-a800m, rwkv6-3b; remat on, the chunked
attention) on the card against the CPU from the same params and batch:
the loss within rtol 1e-5, every gradient within 1e-4 of its leaf's
largest magnitude, and the params after a step within 2 lr (AdamW's first
step is a sign function); and a checkpoint saved from tensors on the card (fp32, bf16, a 0-d
int32) restored onto the card and onto the CPU bit for bit.

The mesh on one card: a (1, 1) NCCL mesh (a 1-rank group); the striped
paged decode (``make_sharded_paged_decode``) against the paged kernel on
the same pools and block table (atol 1e-4, rtol 1e-4), and a checkpoint
restored as DTensors on the card with the planner's placements, bit for
bit.

The dry run's accounting on the card: each kernel entry called under the
counting mode (``utils/op_stats.py``) goes through its custom op, is
counted once as itself with the FLOPs of its formula, and its output (the
pool, for the in-place DBS entries) equals the undecorated launch's bit
for bit; the striped decode's kernel route (``make_sharded_paged_decode(
..., kernel=True)``) on the one-card mesh against its plain route; the
stripe entry ``paged_attention_lse_fwd`` against ``paged_attention_ref(
..., return_lse=True)`` (out within 1e-4, log-sum-exp within 1e-5) and
four stripes of ``_kernel_partial`` merged against the unstriped plain
read (1e-4); an fp32 prefill cell on the one-card mesh, run with no
dispatch mode, launching flash once a layer on its DTensors' local
shards, its logits against the plain chunked route's (1e-4).

The bf16 forms: flash and paged attention on bf16 inputs against their
plain versions in the working type (fp32 math rounded to bf16; within one
bf16 step, BF16_TOL), each call one launch of its form
(``LAUNCHES_BY_DTYPE``): flash at gemma2-2b's prefill widths in the model
layout with a window and the cap, G = 1 at hd 64, the wide 576/512 form,
head dims padded to 16, rows that take no 16-byte copy; paged's split
pools, pool form over an fp32 and a bf16 engine pool, one share and a
page a share, the wide form, 2- and 4-byte copies, with holes and a lane
of length 0; the stripe entry's fp32 log-sum-exp; and the refusal of
fp64 and mixed dtypes on the card (bf16 with fp16 among them).

The fp16 forms (the same templates over fp16): every bf16 flash, wgmma,
paged (split, pool over fp32 and fp16 pools, lse, packed) and scan case
again in fp16, within F16_TOL (rtol and atol 2e-3, the reference's own
tolerance for a dtype other than bf16) of the plain version in the working
type, each launch of the fp16 form; the DBS kernels on fp16 pools bit for
bit.

The DBS kernels' other dtypes: ``dbs_rw_write``, ``dbs_rw_read`` and
``dbs_copy`` on bf16, uint8 and int64 pools, bit for bit against their
plain versions, in every access width the wrappers pick (16 bytes at the
block device's width, 8, 4, 2 and 1 on odd rows or a pool offset by one
element), and ``LAUNCHES_BY_DTYPE``; a payload of another dtype than the
pool's refused. ``rwkv6_scan`` on bf16 inputs (u fp32 or bf16) in both
schedules, at the serving path's shapes, through the model layout's
strides and with a carried state: y bf16 within the fp32 tolerance plus
one bf16 step of |y| (rtol 2^-7 more) of the plain chunked version on the
same inputs, the state fp32 within the fp32 tolerance.
The fp32 wgmma form (``flash_attention_wgmma_f32.cu``, 3xTF32 on wgmma
fed by TMA): against the plain version within atol 1e-4 and rtol 1e-4 at
d 64, 128 and 256 (ragged last tiles, a window across key tiles, Sk > Sq,
the cap, a single query, batch 2, and the four fp32 serve paths' prefill
shapes: gemma2-2b, hymba-1.5b, granite-moe, musicgen-large), each call one
launch of ``f32_wgmma``; fp32 rows off 16 bytes, d 72 and the wide
576 / 512 form launch the mma.sync ``float32`` form instead.
Imports no JAX.
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
    (2, 4, 1, 64, 8, 5), (1, 16, 16, 64, 32, 3), (8, 8, 4, 256, 32, 64),
    (8, 25, 5, 64, 32, 64), (8, 24, 8, 64, 32, 64)])
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
    """Head dims above the wide instantiation's 576 raise, naming the
    limit; so do flash's above (576, 512)."""
    dev = _cuda()
    q = torch.zeros((1, 2, 640), device=dev)
    pk = torch.zeros((3, 4, 1, 640), device=dev)
    table = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="576"):
        paged_attention_fwd(q, pk, pk, table, torch.ones(1, dtype=torch.int32,
                                                          device=dev))
    qf = torch.zeros((1, 2, 8, 576), device=dev)
    with pytest.raises(ValueError, match="576, 512"):
        flash_attention_fwd(qf, qf[:, :1], torch.zeros((1, 1, 8, 576),
                                                        device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d", [
    (2, 256, 256, 4, 2, 64), (1, 512, 512, 8, 2, 128),
    (2, 128, 128, 4, 4, 64), (1, 384, 384, 6, 1, 64), (1, 97, 97, 4, 2, 16),
    (1, 33, 70, 4, 2, 32), (1, 550, 550, 8, 4, 256), (1, 999, 999, 8, 4, 256),
    (1, 700, 700, 25, 5, 64), (1, 600, 600, 24, 8, 64)])
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


@pytest.mark.gpu
@pytest.mark.parametrize("s,h,kv", [(1300, 25, 5), (1100, 25, 5),
                                    (1500, 24, 8)])
def test_flash_attention_kernel_window_1024(s, h, kv):
    """hymba's window layers: prompts past the 1024-token window (the band
    bites), at its G=5 and at granite-moe's G=3, hd 64."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(s + h)
    q = torch.randn((1, h, s, 64), generator=gen, device=dev)
    k = torch.randn((1, kv, s, 64), generator=gen, device=dev)
    v = torch.randn((1, kv, s, 64), generator=gen, device=dev)
    got = flash_attention_fwd(q, k, v, window=1024, logit_cap=0.0)
    want = attention_ref(q, k, v, window=1024, logit_cap=0.0)
    torch.testing.assert_close(got, want, **TOL)
    full = attention_ref(q, k, v, window=0, logit_cap=0.0)
    assert not torch.allclose(got[:, :, 1024:], full[:, :, 1024:], **TOL)
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


@pytest.mark.gpu
@pytest.mark.parametrize("s,chunk,b", [(300, 256, 1), (513, 256, 1),
                                       (1, 1, 8)])
def test_mamba_on_the_card_matches_the_cpu(s, chunk, b):
    """The Mamba branch at hymba's width (d 1600, E 3200, N 16): a prefill
    (300 tokens; 513, which takes a ragged last chunk) and a decode step of
    8 slots from a carried state, on the card against the CPU."""
    dev = _cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    cfg = get_config("hymba-1.5b")
    p = ssm.init_mamba(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(s)
    x = torch.randn((b, s, cfg.d_model), generator=gen)
    st = ssm.mamba_init_state(p, b, torch.float32, "cpu")
    st = {k: torch.randn(v.shape, generator=gen) * 0.1
          for k, v in st.items()}
    y_c, st_c = ssm.mamba_forward(p, x, st, chunk=chunk)
    to = (lambda t: t.to(dev))
    y_g, st_g = ssm.mamba_forward({k: to(v) for k, v in p.items()}, to(x),
                                  {k: to(v) for k, v in st.items()},
                                  chunk=chunk)
    torch.cuda.synchronize()
    assert torch.isfinite(y_g).all()
    torch.testing.assert_close(y_g.cpu(), y_c, **TOL)
    for k in st_c:
        torch.testing.assert_close(st_g[k].cpu(), st_c[k], **TOL)


@pytest.mark.gpu
def test_moe_does_not_sync():
    """granite-moe's MoE at full width (40 experts, top 8, d 1536, f 512)
    for 8 slots runs under sync-debug "error" and agrees with the same
    function on the CPU."""
    dev = _cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    cfg = get_config("granite-moe-3b-a800m")
    p = layers.init_moe(torch.Generator(device=dev).manual_seed(0), cfg)
    x = torch.randn((8, 1, cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out_g, aux_g = layers.apply_moe(p, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out_c, aux_c = layers.apply_moe({k: v.cpu() for k, v in p.items()},
                                    x.cpu(), cfg)
    torch.testing.assert_close(out_g.cpu(), out_c, **TOL)
    torch.testing.assert_close(aux_g.cpu(), aux_c, **TOL)


# ---------------------------------------------------------------------------
# MLA's latent widths (deepseek-v3) and musicgen's heads
# ---------------------------------------------------------------------------
def _mla_paged_case(dev, b, h, kv, dk, dv, page, p_max, seed, n_planes=0):
    """Split pools of widths dk and dv (or an engine pool of n_planes
    planes at dk), a block table with holes past each length and one
    below, ragged lengths with a lane of length 0 and a full one."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    e = b * p_max + 5
    q = torch.randn((b, h, dk), generator=gen, device=dev)
    if n_planes:
        pools = (torch.randn((e, page, n_planes, kv, dk), generator=gen,
                             device=dev),)
    else:
        pools = (torch.randn((e, page, kv, dk), generator=gen, device=dev),
                 torch.randn((e, page, kv, dv), generator=gen, device=dev))
    table = rng.permutation(e - 1)[:b * p_max].reshape(b, p_max) + 1
    lengths = rng.integers(1, p_max * page + 1, b)
    lengths[0] = 0
    lengths[-1] = p_max * page
    for i in range(b):
        table[i, -(-lengths[i] // page):] = -1
    table[-1, 1] = -1
    return (q, pools, torch.from_numpy(table.astype(np.int32)).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("entry,h,kv,dk,dv", [
    ("split", 128, 1, 576, 512), ("pool", 128, 1, 576, 576),
    ("pool", 32, 32, 64, 64), ("split", 8, 4, 256, 256),
    ("pool", 8, 4, 256, 256)])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (100, 50.0)])
def test_paged_attention_mla_and_audio_widths(entry, h, kv, dk, dv, window,
                                             cap):
    """deepseek-v3's decode (8 sequences, one latent KV head of 576, 128
    query heads, page 32 and 32 pages: lengths up to 1024; the copy-based
    baseline's split pools with V 512, the zero-copy engine pool's planes
    at 576) at MLA's scale 1/sqrt(192); musicgen's 32 heads of 64 (G = 1);
    and gemma2-2b's 256, the narrow instantiation, as a regression."""
    dev = _cuda()
    scale = 1.0 / np.sqrt(192.0) if dk == 576 else None
    q, pools, table, lengths = _mla_paged_case(
        dev, 8, h, kv, dk, dv, 32, 32, dk + h,
        n_planes=8 if entry == "pool" else 0)
    kw = dict(window=window, logit_cap=cap, scale=scale)
    if entry == "split":
        got = paged_attention_fwd(q, *pools, table, lengths, **kw)
        want = paged_attention_ref(q, *pools, table, lengths, **kw)
    else:
        got = paged_attention_pool_fwd(q, pools[0], table, lengths,
                                       k_plane=6, v_plane=7, **kw)
        want = paged_attention_pool_ref(q, pools[0], table, lengths,
                                        k_plane=6, v_plane=7, **kw)
    torch.cuda.synchronize()
    assert got.shape == (8, h, dv)
    assert torch.isfinite(got).all() and not got[0].any()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,h,kv,dk,dv,window,cap,v_of_k", [
    (300, 128, 1, 576, 512, 0, 0.0, False),
    (1000, 128, 1, 576, 512, 0, 0.0, False),
    (97, 128, 1, 576, 512, 0, 0.0, True),       # v = k[..., :512]
    (130, 16, 1, 576, 512, 40, 50.0, False),
    (70, 8, 1, 570, 500, 0, 0.0, False),        # 4-byte staging of q, k
    (300, 16, 2, 320, 64, 0, 0.0, False),
    (700, 32, 32, 64, 64, 0, 0.0, False),       # musicgen
    (550, 8, 4, 256, 256, 0, 50.0, False),      # the narrow kernel
    (130, 4, 2, 96, 64, 0, 0.0, False)])
def test_flash_attention_mla_and_audio_widths(sq, h, kv, dk, dv, window, cap,
                                             v_of_k):
    """deepseek-v3's prefill in the absorbed basis (128 query heads on one
    latent KV head, K 576, V 512, scale 1/sqrt(192)) on the wide
    instantiation: ragged lengths, up to 1000 tokens, V read through a
    view of K, a window with a cap, widths that are not multiples of 4,
    a wide K with a narrow V; musicgen's (32, 32, 64) and gemma2's 256
    on the narrow one; the model-layout entry on the MLA shapes."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(sq + dk)
    q = torch.randn((1, h, sq, dk), generator=gen, device=dev)
    k = torch.randn((1, kv, sq, dk), generator=gen, device=dev)
    v = (k[..., :dv] if v_of_k
         else torch.randn((1, kv, sq, dv), generator=gen, device=dev))
    scale = 1.0 / np.sqrt(192.0) if dk >= 512 else None
    kw = dict(window=window, logit_cap=cap, scale=scale)
    got = flash_attention_fwd(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == (1, h, sq, dv) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)
    if dk == 576 and not v_of_k:
        qm, km, vm = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        got = flash_attention(qm, km, vm, **kw)
        want = flash_attention_reference(qm, km, vm, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma2-2b", "hymba-1.5b",
                                  "granite-moe-3b-a800m", "rwkv6-3b"])
def test_train_step_on_the_card_matches_the_cpu(arch):
    dev = _cuda()
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ExecutionPlan
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_leaves, tree_map
    from repro_torch.training.train_step import grads_of, make_train_step
    cfg = smoke_config(arch)
    plan = ExecutionPlan(remat="block", attn_impl="chunked",
                         compute_dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    tok = torch.randint(0, cfg.vocab_size, (2, 32),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok, "labels": tok}
    on = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        p = tree_map(lambda t, d=d: t.to(d, copy=True), params)
        b = {k: v.to(d) for k, v in batch.items()}
        g, m = grads_of(p, b, cfg, plan)
        init, step = make_train_step(cfg, plan, total_steps=8, warmup=1)
        q, _, m2 = step(p, init(p), b)
        on[name] = (g, m, q, m2)
    (g_c, m_c, p_c, s_c), (g_g, m_g, p_g, s_g) = on["cpu"], on["card"]
    for k in m_c:
        torch.testing.assert_close(m_g[k].cpu(), m_c[k], atol=1e-6,
                                   rtol=1e-5)
    torch.testing.assert_close(s_g["grad_norm"].cpu(), s_c["grad_norm"],
                               atol=1e-6, rtol=1e-5)
    for a, b in zip(tree_leaves(g_g), tree_leaves(g_c)):
        scale = float(b.abs().max()) or 1.0
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale
    # AdamW's first step moves a parameter by about lr (3e-4 here) whatever
    # the size of its gradient, so where a gradient is ~0 and its sign
    # differs the params differ by up to 2 lr
    for a, b in zip(tree_leaves(p_g), tree_leaves(p_c)):
        assert torch.isfinite(a).all()
        assert float((a.cpu() - b).abs().max()) <= 2 * 3e-4 + 1e-6


@pytest.mark.gpu
def test_checkpoint_from_card_tensors(tmp_path):
    dev = _cuda()
    from repro_torch.checkpoint import CheckpointStore
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = {"w": torch.randn((300, 70), generator=gen, device=dev),
            "e": torch.randn((17, 9), generator=gen, device=dev)
            .to(torch.bfloat16),
            "opt": {"count": torch.tensor(5, dtype=torch.int32, device=dev),
                    "m": [torch.randn((4096,), generator=gen, device=dev)]}}
    st = CheckpointStore(str(tmp_path / "ck.dbs"), capacity_bytes=1 << 22)
    st.save("train", 3, tree)
    for where in (dev, torch.device("cpu")):
        step, back = st.restore("train", like=tree, device=where)
        assert step == 3
        for key in ("w", "e"):
            assert back[key].device.type == where.type
            assert back[key].dtype == tree[key].dtype
            assert torch.equal(back[key].cpu().view(torch.int16)
                               if key == "e" else back[key].cpu(),
                               tree[key].cpu().view(torch.int16)
                               if key == "e" else tree[key].cpu())
        assert int(back["opt"]["count"]) == 5
        assert torch.equal(back["opt"]["m"][0].cpu(),
                           tree["opt"]["m"][0].cpu())
    st.close()


class _OneCardMesh:
    """A 1-rank NCCL group and its (1, 1) ("data", "model") mesh."""

    def __init__(self, tmp_path):
        from repro_torch.launch.mesh import local_init_method
        self.init = local_init_method()

    def __enter__(self):
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_mesh
        dist.init_process_group("nccl", init_method=self.init, world_size=1,
                                rank=0)
        return make_mesh((1, 1), ("data", "model"), "cuda")

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("window,cap,stripe_slice", [(0, 0.0, True),
                                                     (40, 50.0, False)])
def test_striped_decode_on_a_one_card_mesh(tmp_path, window, cap,
                                           stripe_slice):
    dev = _cuda()
    from repro_torch.distributed.collectives import make_sharded_paged_decode
    b, h, kv, d, page, p_max = 4, 8, 4, 256, 32, 8
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b, 1, h, d), generator=gen, device=dev)
    k_new = torch.randn((b, 1, kv, d), generator=gen, device=dev)
    v_new = torch.randn((b, 1, kv, d), generator=gen, device=dev)
    e = b * p_max + 1
    pool_k = torch.randn((e, page, kv, d), generator=gen, device=dev)
    pool_v = torch.randn((e, page, kv, d), generator=gen, device=dev)
    table = torch.randperm(e - 1, generator=torch.Generator().manual_seed(1)
                           )[:b * p_max].reshape(b, p_max).int().to(dev)
    pos = torch.tensor([[5], [100], [200], [255]], dtype=torch.int32,
                       device=dev)
    for i in range(b):                 # holes past each sequence's length
        table[i, int(pos[i]) // page + 1:] = -1
    with _OneCardMesh(tmp_path) as mesh:
        fn = make_sharded_paged_decode(mesh, True, stripe_slice=stripe_slice)
        out, pk, pv = fn(q, k_new, v_new, pool_k.clone(), pool_v.clone(),
                         table, pos, window=window, logit_cap=cap)
    assert out.shape == (b, 1, h, d) and out.device == q.device
    want = paged_attention_fwd(q[:, 0].contiguous(), pk, pv, table,
                               pos[:, 0] + 1, window=window, logit_cap=cap,
                               scale=1.0 / np.sqrt(d))
    torch.testing.assert_close(out[:, 0], want, **TOL)
    rows = table[torch.arange(b, device=dev), (pos[:, 0] // page).long()]
    off = (pos[:, 0] % page).long()
    assert torch.equal(pk[rows.long(), off], k_new[:, 0])
    assert torch.equal(pv[rows.long(), off], v_new[:, 0])


@pytest.mark.gpu
def test_dtensor_restore_on_the_card(tmp_path):
    dev = _cuda()
    from repro_torch.checkpoint import ReplicatedCheckpoint
    from repro_torch.checkpoint.store import _flatten
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ExecutionPlan
    from repro_torch.distributed.planner import Planner
    from repro_torch.models import init_params
    cfg = smoke_config("gemma2-2b")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    dirs = [str(tmp_path / d) for d in "ab"]
    with _OneCardMesh(tmp_path) as mesh:
        rc = ReplicatedCheckpoint(dirs, capacity_bytes=1 << 26, mesh=mesh)
        rc.save("params", 2, params)
        pl = Planner(mesh, cfg, ExecutionPlan()).shardings(params)
        step, back = rc.restore("params", like=params, mesh=mesh,
                                placements=pl)
        rc.close()
        assert step == 2
        for got, want in zip(_flatten(back)[0], _flatten(params)[0]):
            assert type(got).__name__ == "DTensor"
            assert got.to_local().device.type == dev.type
            assert torch.equal(got.full_tensor(), want)


def _entry_case(name, dev):
    """(public call, undecorated launch, counted FLOPs it must give)."""
    from repro_torch.kernels.dbs import copy_kernel as ck
    from repro_torch.kernels.dbs import rw_kernel as rk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.rwkv6_scan import kernel as sk
    gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    b, h, kv, d, page, p_max = 4, 8, 4, 256, 32, 8
    table = torch.arange(b * p_max, dtype=torch.int32,
                         device=dev).reshape(b, p_max)
    lengths = torch.tensor([5, 100, 200, 256], dtype=torch.int32, device=dev)
    q = rnd(b, h, d)
    scale = 1.0 / np.sqrt(d)
    if name in ("paged_attention", "paged_attention_lse"):
        pools = (rnd(b * p_max, page, kv, d), rnd(b * p_max, page, kv, d))
        fwd = (pk.paged_attention_fwd if name == "paged_attention"
               else pk.paged_attention_lse_fwd)
        raw = pk._split if name == "paged_attention" else pk._split_lse
        args = (q, *pools, table, lengths)
        return (lambda: fwd(*args, scale=scale),
                lambda: raw(*args, 0, 0.0, scale),
                pk.paged_work(q, table, lengths, page, kv, d, d, 0)[0])
    if name == "paged_attention_pool":
        pool = rnd(b * p_max, page, 4, kv, d)
        args = (q, pool, table, lengths)
        return (lambda: pk.paged_attention_pool_fwd(*args, k_plane=2,
                                                    v_plane=3, scale=scale),
                lambda: pk._pool(*args, 2, 3, 0, 0.0, scale),
                pk.paged_work(q, table, lengths, page, kv, d, d, 0)[0])
    if name == "flash_attention":
        fq, fk_, fv = rnd(2, 8, 300, 64), rnd(2, 4, 300, 64), rnd(2, 4, 300, 64)
        return (lambda: fk.flash_attention_fwd(fq, fk_, fv, window=100),
                lambda: fk._flash(fq, fk_, fv, True, 100, 0.0, 1 / 8.0),
                fk.flash_work(fq, fk_, fv, True, 100)[0])
    if name == "rwkv6_scan":
        r, k, v = rnd(2, 70, 40, 64), rnd(2, 70, 40, 64), rnd(2, 70, 40, 64)
        logw = -0.5 * torch.rand((2, 70, 40, 64), generator=gen, device=dev)
        u, s0 = rnd(40, 64), rnd(2, 40, 64, 64)
        return (lambda: sk.rwkv6_scan_fwd(r, k, v, logw, u, s0=s0),
                lambda: sk._scan(r, k, v, logw, u, s0, 64),
                sk.rwkv6_work(2, 70, 40, 64, 64, True)[0])
    pool = rnd(9, 32, 1024)
    ids = torch.arange(4, dtype=torch.int32, device=dev)
    if name == "dbs_rw_read":
        blk = torch.tensor([0, 5, 31, 7], dtype=torch.int32, device=dev)
        return (lambda: rk.dbs_rw_read(pool, ids, blk),
                lambda: rk._read(pool, ids, blk), 0)
    if name == "dbs_rw_write":
        lane_of = torch.full((4, 32), -1, dtype=torch.int32, device=dev)
        lane_of[:, 3] = ids
        pay, dst = rnd(4, 1024), ids + 4
        return (lambda: rk.dbs_rw_write(pool.clone(), ids, dst, lane_of, pay),
                lambda: _mutated(rk._write, pool, ids, dst, lane_of, pay), 0)
    mask = torch.tensor([1, 0, 1, 1], dtype=torch.bool, device=dev)
    return (lambda: ck.dbs_copy(pool.clone(), ids, ids + 4, mask),
            lambda: _mutated(ck._copy, pool, ids, ids + 4, mask), 0)


def _mutated(launch, pool, *args):
    out = pool.clone()
    launch(out, *args)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "paged_attention", "paged_attention_lse", "paged_attention_pool",
    "flash_attention", "rwkv6_scan", "dbs_rw_read", "dbs_rw_write",
    "dbs_copy"])
def test_custom_op_entries_count_their_formula(name):
    dev = _cuda()
    from repro_torch.utils.op_stats import OpCounter
    call, raw, flops = _entry_case(name, dev)
    with OpCounter() as c:
        got = call()
    want = raw()
    torch.cuda.synchronize()
    assert c.count_ops() == {name: 1}
    assert c.module_costs()["flops"] == flops
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("stripe_slice", [True, False])
def test_striped_decode_kernel_route_on_a_one_card_mesh(tmp_path,
                                                        stripe_slice):
    dev = _cuda()
    from repro_torch.distributed.collectives import make_sharded_paged_decode
    from repro_torch.kernels.paged_attention import kernel as pk
    b, h, kv, d, page, p_max = 4, 8, 4, 256, 32, 8
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b, 1, h, d), generator=gen, device=dev)
    k_new = torch.randn((b, 1, kv, d), generator=gen, device=dev)
    v_new = torch.randn((b, 1, kv, d), generator=gen, device=dev)
    pool_k = torch.randn((b * p_max, page, kv, d), generator=gen, device=dev)
    pool_v = torch.randn((b * p_max, page, kv, d), generator=gen, device=dev)
    table = torch.arange(b * p_max, dtype=torch.int32,
                         device=dev).reshape(b, p_max)
    pos = torch.tensor([[5], [100], [200], [255]], dtype=torch.int32,
                       device=dev)
    outs = {}
    with _OneCardMesh(tmp_path) as mesh:
        for kernel in (False, True):
            fn = make_sharded_paged_decode(mesh, True,
                                           stripe_slice=stripe_slice,
                                           kernel=kernel)
            pk.reset_counts()
            outs[kernel], _, _ = fn(q, k_new, v_new, pool_k.clone(),
                                    pool_v.clone(), table, pos)
            assert pk.LAUNCHES["paged_attention"] == int(kernel)
    torch.testing.assert_close(outs[True], outs[False], **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("p_max,window,cap,holes", [
    (8, 0, 0.0, False), (8, 0, 50.0, True), (8, 70, 0.0, False),
    (1, 0, 50.0, False), (64, 0, 50.0, True)])
def test_paged_lse_entry_against_its_plain_version(p_max, window, cap,
                                                   holes):
    """``paged_attention_lse_fwd`` (at least two shares, the log-sum-exp
    read from the partials scratch) against ``paged_attention_ref(...,
    return_lse=True)``: out within TOL, the log-sum-exp within 1e-5; a
    row with no live position has zeros and NEG_INF. p_max 1 takes the
    padded hole page."""
    dev = _cuda()
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    b, h, kv, d, page = 5, 8, 4, 256, 32
    gen = torch.Generator(device=dev).manual_seed(p_max + window)
    pools = [torch.randn((b * p_max + 1, page, kv, d), generator=gen,
                         device=dev) for _ in range(2)]
    q = torch.randn((b, h, d), generator=gen, device=dev)
    table = torch.arange(b * p_max, dtype=torch.int32,
                         device=dev).reshape(b, p_max)
    if holes:
        table[:, 1::3] = -1
    full = p_max * page
    lengths = torch.tensor([full, full // 2 + 3, 7, 1, 0], dtype=torch.int32,
                           device=dev).clamp(max=full)
    kw = dict(window=window, logit_cap=cap, scale=1.0 / 16)
    pk.reset_counts()
    out, lse = pk.paged_attention_lse_fwd(q, *pools, table, lengths, **kw)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["paged_attention"] == 1
    want_out, want_lse = paged_attention_ref(q, *pools, table, lengths,
                                             return_lse=True, **kw)
    torch.testing.assert_close(out, want_out, **TOL)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    assert bool((lse[4] == pk.NEG_INF).all()) and not bool(out[4].any())


@pytest.mark.gpu
@pytest.mark.parametrize("stripe_slice,window", [(True, 0), (False, 0),
                                                 (True, 40)])
def test_kernel_stripes_merge_on_the_card(stripe_slice, window):
    """Four stripes' partials through the paged kernel (``_kernel_partial``
    at stride 4, rank by rank; rows whose context ends before a stripe's
    first page leave it empty) merged as the striped decode merges them,
    against the plain unstriped read (TOL)."""
    dev = _cuda()
    from repro_torch.distributed.collectives import _kernel_partial
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.models import attention as attn
    b, h, kv, d, page, p_max, stride = 4, 8, 4, 256, 32, 8, 4
    gen = torch.Generator(device=dev).manual_seed(11)
    pools = [torch.randn((b * p_max, page, kv, d), generator=gen,
                         device=dev) for _ in range(2)]
    table = torch.arange(b * p_max, dtype=torch.int32,
                         device=dev).reshape(b, p_max)
    q = torch.randn((b, 1, h, d), generator=gen, device=dev)
    q_pos = torch.tensor([[5], [40], [131], [255]], dtype=torch.int32,
                         device=dev)
    pk.reset_counts()
    parts = [_kernel_partial(q, *pools, table, q_pos, stride, rank,
                             stripe_slice, window=window, logit_cap=50.0,
                             scale=None) for rank in range(stride)]
    torch.cuda.synchronize()
    assert pk.LAUNCHES["paged_attention"] == stride
    got = attn.merge_partials(*(torch.stack([p[i] for p in parts])
                                for i in range(3)))
    want = attn.merge_partials(*(t[None] for t in attn.paged_decode_attention(
        q, *pools, table, q_pos, window=window, logit_cap=50.0)))
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
def test_prefill_cell_runs_the_flash_kernel_on_a_one_card_mesh(tmp_path):
    """An fp32 prefill cell (``launch/specs.py``) on the one-card mesh, its
    step run outside any dispatch mode: the flash entry takes the cell's
    DTensors through its op, launches the kernel once a layer on the local
    shards, and the logits equal the plain chunked route's (TOL)."""
    dev = _cuda()
    import dataclasses
    from repro_torch.configs import SHAPES, smoke_config
    from repro_torch.configs.base import default_plan
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.model import prefill, tree_map
    cfg = smoke_config("gemma2-2b")
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=64,
                                global_batch=8)
    plan = dataclasses.replace(default_plan(cfg, shape, 1, data_shards=1),
                               compute_dtype="float32",
                               param_dtype="float32")
    with _OneCardMesh(tmp_path) as mesh:
        cell = build_cell(cfg, shape, mesh, plan)
        params, tokens, caches = tree_map(
            lambda t: t.to_local().clone(), list(cell.args))
        want, _ = prefill(params, tokens, cfg, dataclasses.replace(
            cell.plan, attn_impl="chunked"), caches)
        fk.reset_counts()
        got, _ = cell.step(*cell.args)
        torch.cuda.synchronize()
        assert fk.LAUNCHES["flash_attention"] == cfg.n_layers
        assert type(got).__name__ == "DTensor"
        torch.testing.assert_close(got.to_local(), want, **TOL)


# ---------------------------------------------------------------------------
# the bf16 forms
# ---------------------------------------------------------------------------
BF16 = torch.bfloat16
# the kernel and the plain version compute in fp32 from the same bf16
# inputs and round once to bf16: where the two fp32 results straddle a
# rounding boundary they differ by one bf16 step, at most 2^-7 of the
# value; the atol is the fp32 tolerance, for values near zero
BF16_TOL = dict(atol=1e-4, rtol=2 ** -7)


F16 = torch.float16
# an fp16 form against its plain version: the reference's own tolerance for
# a dtype other than bf16 (tests/test_kernels.py _tol), which one fp16 step
# (2^-10 of the value) fits
F16_TOL = dict(atol=2e-3, rtol=2e-3)
TAG16 = {BF16: "bf16", F16: "f16"}


def _close_bf16(got, want, dtype=BF16):
    """``got`` (a kernel's 16-bit output) against the plain version's fp32
    output rounded to ``dtype``, in the working type (BF16_TOL, F16_TOL)."""
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.to(dtype).float(),
                               **(BF16_TOL if dtype == BF16 else F16_TOL))


FLASH_16_FORMS = [
    (1, 550, 550, 8, 4, 256, 256, 0, 50.0, "model"),      # gemma2, global
    (1, 855, 855, 8, 4, 256, 256, 4096, 50.0, "model"),   # gemma2, local
    (1, 700, 700, 32, 32, 64, 64, 0, 0.0, "model"),       # G = 1, hd 64
    (1, 479, 479, 128, 1, 576, 512, 0, 0.0, "contiguous"),   # MLA, wide
    (1, 130, 130, 16, 1, 576, 512, 40, 50.0, "contiguous"),
    (1, 70, 70, 8, 1, 570, 500, 0, 0.0, "contiguous"),   # wide, 2-byte
    (2, 100, 100, 4, 2, 72, 72, 40, 50.0, "contiguous"),  # d % 16 != 0
    (1, 37, 37, 2, 1, 13, 13, 0, 30.0, "contiguous"),    # d odd
    (1, 1, 1, 4, 2, 64, 64, 0, 0.0, "contiguous"),       # Sq 1
    (1, 40, 1500, 8, 4, 256, 256, 0, 50.0, "contiguous"),    # Sk >> Sq
    (1, 200, 200, 4, 2, 64, 64, 5, 0.0, "contiguous"),   # window < a tile
    (1, 130, 130, 4, 2, 64, 64, 0, 0.0, "pad")]          # 2-byte staging


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,dk,dv,window,cap,layout",
                         FLASH_16_FORMS)
def test_flash_attention_bf16_form(b, sq, sk, h, kv, dk, dv, window, cap,
                                   layout, dtype=BF16):
    """The bf16 form against its plain version in the working type: the
    serving prefill's shapes (gemma2-2b global and local in the model
    layout, read through strides; G = 1 at hd 64), the wide instantiation
    at MLA's widths (K 576, V 512, scale 1/sqrt(192)), head dims padded to
    16, a single query, many key tiles, a window inside one key tile, and
    rows that take no 16-byte copy; one launch of the bf16 form a call,
    the output bf16 (of ``dtype``'s form and dtype: the fp16 test below)."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(sq * 7 + dk + h)
    scale = 1.0 / np.sqrt(192.0) if dk >= 512 else None
    q = torch.randn((b, h, sq, dk), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, kv, sk, dk), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, kv, sk, dv), generator=gen, device=dev).to(dtype)
    if layout == "model":      # (B, S, N, hd) tensors, read as views
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    elif layout == "pad":      # rows of hd + 1 values: no 16-byte copy
        q, k, v = (torch.cat([t, t[..., :1]], -1)[..., :t.shape[-1]]
                   for t in (q, k, v))
        assert all(t.stride(2) % 8 for t in (q, k, v))
    kw = dict(window=window, logit_cap=cap, scale=scale)
    fk.reset_counts()
    got = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    key = str(dtype).split(".")[1]
    assert fk.LAUNCHES_BY_DTYPE == {"float32": 0, "bfloat16": 0,
                                    "float16": 0, key: 1}
    assert got.shape == (b, h, sq, dv) and torch.isfinite(got.float()).all()
    _close_bf16(got, attention_ref(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,dk,dv,window,cap,layout",
                         FLASH_16_FORMS)
def test_flash_attention_f16_form(b, sq, sk, h, kv, dk, dv, window, cap,
                                  layout):
    """The fp16 forms (the same templates over fp16: the wgmma and the
    mma.sync kernels, narrow and wide) at the bf16 form's shapes, within
    F16_TOL of the plain version; one launch of an fp16 form a call."""
    test_flash_attention_bf16_form(b, sq, sk, h, kv, dk, dv, window, cap,
                                   layout, dtype=F16)


def _bf16_paged_case(dev, b, h, kv, dk, dv, page, p_max, seed, n_planes=0,
                     pool_dtype=BF16, dtype=BF16):
    """``_mla_paged_case``'s pools and table with q in ``dtype`` (bf16 or
    fp16) and the pools in ``pool_dtype`` (``dtype`` or fp32; values
    representable in ``dtype`` either way)."""
    q, pools, table, lengths = _mla_paged_case(dev, b, h, kv, dk, dv, page,
                                               p_max, seed, n_planes)
    pool_dtype = dtype if pool_dtype == BF16 else pool_dtype
    return (q.to(dtype), tuple(p.to(dtype).to(pool_dtype) for p in pools),
            table, lengths)


PAGED_16_FORMS = [
    ("split", 8, 8, 4, 256, 256, 32, 64, BF16),      # gemma2's width
    ("pool", 8, 8, 4, 256, 256, 32, 64, torch.float32),   # serving's mix
    ("pool", 8, 8, 4, 256, 256, 32, 64, BF16),
    ("split", 64, 16, 8, 256, 256, 32, 16, BF16),    # one share, no merge
    ("pool", 64, 16, 8, 256, 256, 32, 16, torch.float32),
    ("split", 2, 2, 2, 64, 64, 8, 16, BF16),         # a page a share
    ("pool", 8, 32, 32, 64, 64, 32, 32, torch.float32),   # G = 1, hd 64
    ("split", 8, 128, 1, 576, 512, 32, 32, BF16),    # MLA, wide
    ("pool", 8, 128, 1, 576, 576, 32, 32, torch.float32),
    ("pool", 8, 128, 1, 576, 576, 32, 32, BF16),
    ("split", 3, 12, 1, 6, 6, 4, 9, BF16),           # 2-byte copies
    ("split", 3, 4, 2, 8, 12, 4, 9, BF16),
    ("pool", 3, 12, 4, 6, 6, 4, 9, torch.float32)]   # 4-byte copies


@pytest.mark.gpu
@pytest.mark.parametrize("entry,b,h,kv,dk,dv,page,p_max,pool_dtype",
                         PAGED_16_FORMS)
@pytest.mark.parametrize("window,cap", [(0, 50.0), (100, 0.0)])
def test_paged_attention_bf16_forms(entry, b, h, kv, dk, dv, page, p_max,
                                    pool_dtype, window, cap, dtype=BF16):
    """The bf16 forms against their plain version in the working type: q
    bf16 over bf16 split pools, over the fp32 engine pool (zero-copy
    serving's mix) and over a bf16 engine pool; at gemma2-2b's serving
    width, with one share (no merge) and with a page a share, G = 1 at hd
    64, the wide instantiation at MLA's widths (scale 1/sqrt(192)), and
    head dims that take no 16-byte copy; holes past each length and one
    below, a lane of length 0 (zeros). One launch of the form a call (of
    ``dtype``'s forms: the fp16 test below, where BF16 in the list stands
    for q's dtype)."""
    dev = _cuda()
    from repro_torch.kernels.paged_attention import kernel as pk
    q, pools, table, lengths = _bf16_paged_case(
        dev, b, h, kv, dk, dv, page, p_max, dk + h + p_max,
        n_planes=8 if entry == "pool" else 0, pool_dtype=pool_dtype,
        dtype=dtype)
    kw = dict(window=window, logit_cap=cap,
              scale=1.0 / np.sqrt(192.0) if dk == 576 else None)
    pk.reset_counts()
    if entry == "split":
        got = paged_attention_fwd(q, *pools, table, lengths, **kw)
        want = paged_attention_ref(q, *pools, table, lengths, **kw)
    else:
        got = paged_attention_pool_fwd(q, pools[0], table, lengths,
                                       k_plane=6, v_plane=7, **kw)
        want = paged_attention_pool_ref(q, pools[0], table, lengths,
                                        k_plane=6, v_plane=7, **kw)
    torch.cuda.synchronize()
    form = str(dtype).split(".")[1] + ("" if pool_dtype == BF16 else "_q")
    assert pk.LAUNCHES_BY_DTYPE[form] == 1 == pk.LAUNCHES["paged_attention"]
    assert got.shape == (b, h, dv) and not got[0].any()
    _close_bf16(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("entry,b,h,kv,dk,dv,page,p_max,pool_dtype",
                         PAGED_16_FORMS)
@pytest.mark.parametrize("window,cap", [(0, 50.0), (100, 0.0)])
def test_paged_attention_f16_forms(entry, b, h, kv, dk, dv, page, p_max,
                                   pool_dtype, window, cap):
    """The fp16 forms at the bf16 forms' shapes: fp16 q over fp16 split
    pools (``float16``), over the fp32 engine pool (``float16_q``) and
    over an fp16 engine pool, within F16_TOL; one launch a call."""
    test_paged_attention_bf16_forms(entry, b, h, kv, dk, dv, page, p_max,
                                    pool_dtype, window, cap, dtype=F16)


@pytest.mark.gpu
@pytest.mark.parametrize("p_max,window,cap", [(8, 0, 50.0), (64, 70, 0.0),
                                              (1, 0, 50.0)])
def test_paged_lse_entry_bf16(p_max, window, cap, dtype=BF16):
    """The stripe entry on bf16 q and pools: the output bf16 against the
    plain version in the working type, the log-sum-exp fp32 within 1e-5
    (both from the same bf16 values in fp32); a row with no live position
    has zeros and NEG_INF."""
    dev = _cuda()
    from repro_torch.kernels.paged_attention import kernel as pk
    b, h, kv, d, page = 5, 8, 4, 256, 32
    gen = torch.Generator(device=dev).manual_seed(p_max + window + 1)
    pools = [torch.randn((b * p_max + 1, page, kv, d), generator=gen,
                         device=dev).to(dtype) for _ in range(2)]
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    table = torch.arange(b * p_max, dtype=torch.int32,
                         device=dev).reshape(b, p_max)
    table[:, 1::3] = -1
    full = p_max * page
    lengths = torch.tensor([full, full // 2 + 3, 7, 1, 0], dtype=torch.int32,
                           device=dev).clamp(max=full)
    kw = dict(window=window, logit_cap=cap, scale=1.0 / 16)
    out, lse = pk.paged_attention_lse_fwd(q, *pools, table, lengths, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = paged_attention_ref(q, *pools, table, lengths,
                                             return_lse=True, **kw)
    assert lse.dtype == torch.float32
    _close_bf16(out, want_out, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    assert bool((lse[4] == pk.NEG_INF).all()) and not bool(out[4].any())


@pytest.mark.gpu
@pytest.mark.parametrize("p_max,window,cap", [(8, 0, 50.0), (64, 70, 0.0),
                                              (1, 0, 50.0)])
def test_paged_lse_entry_f16(p_max, window, cap):
    """The stripe entry on fp16 q and pools: the output fp16 within
    F16_TOL, the log-sum-exp fp32 within 1e-5."""
    test_paged_lse_entry_bf16(p_max, window, cap, dtype=F16)


@pytest.mark.gpu
def test_bf16_forms_refuse_other_dtypes():
    """On the card as on the CPU: fp64 inputs, and q and pools (or k, v)
    of mixed dtypes other than the pool forms' 16-bit q over an fp32 pool
    (bf16 with fp16 among them), raise before any launch; nothing is cast
    to reach a form."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    fk.reset_counts()
    pk.reset_counts()
    q = torch.zeros((1, 2, 8, 64), device=dev, dtype=BF16)
    for bad in ((q.double(),) * 3, (q, q.float(), q),
                (q.float(), q, q.float()), (q.half(), q, q),
                (q.half(), q.half(), q.half().float())):
        with pytest.raises(TypeError):
            flash_attention_fwd(*bad)
    qd = torch.zeros((1, 2, 64), device=dev, dtype=BF16)
    pool = torch.zeros((3, 4, 2, 64), device=dev, dtype=BF16)
    table = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    ln = torch.ones(1, dtype=torch.int32, device=dev)
    for bad in ((qd.double(), pool.double()), (qd, pool.float()),
                (qd.float(), pool), (qd.half(), pool), (qd, pool.half())):
        with pytest.raises(TypeError):
            paged_attention_fwd(bad[0], bad[1], bad[1], table, ln)
    for bad in ((qd.float(), pool), (qd.half(), pool), (qd, pool.half())):
        with pytest.raises(TypeError):
            paged_attention_pool_fwd(bad[0], bad[1][:, :, None], table, ln,
                                     k_plane=0, v_plane=0)
    assert fk.LAUNCHES["flash_attention"] == 0
    assert pk.LAUNCHES["paged_attention"] == 0


# ---------------------------------------------------------------------------
# flash's wgmma form and paged attention's packed form
# ---------------------------------------------------------------------------
WGMMA_FORMS = [
    (1, 854, 854, 8, 4, 256, 4096, 50.0, "model"),   # gemma2, local
    (1, 550, 550, 8, 4, 256, 0, 50.0, "model"),      # gemma2, global
    (1, 300, 300, 4, 2, 128, 100, 0.0, "model"),     # window > a tile
    (1, 333, 333, 8, 2, 64, 0, 30.0, "contiguous"),  # ragged, cap
    (1, 40, 1500, 8, 4, 256, 0, 50.0, "contiguous"),  # Sk >> Sq
    (2, 70, 90, 4, 2, 64, 50, 0.0, "contiguous"),    # Sk > Sq, ragged
    (1, 60, 60, 8, 4, 128, 0, 0.0, "model"),         # one key tile
    (1, 1, 1, 4, 2, 64, 0, 0.0, "contiguous"),       # Sq 1
    (4, 854, 854, 8, 4, 256, 0, 50.0, "model"),      # past the card's SMs
    (3, 400, 400, 25, 5, 64, 1024, 0.0, "model"),    # odd groups
    (2, 500, 500, 16, 16, 128, 0, 0.0, "contiguous")]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,window,cap,layout", WGMMA_FORMS)
def test_flash_attention_wgmma_form(b, sq, sk, h, kv, d, window, cap,
                                    layout, dtype=BF16):
    """The wgmma form (TMA loads, warp-specialised, P.V on wgmma with V
    transposed) against its plain version in the working type at d 64, 128
    and 256: gemma2-2b's prefill in the model layout, a window crossing
    key tiles, ragged Sq and Sk, Sk >> Sq, one key tile and one query, and
    more blocks than the card's SMs; each call one launch of the wgmma
    form."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(sq + sk + d + h)
    q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
    if layout == "model":
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    kw = dict(window=window, logit_cap=cap)
    fk.reset_counts()
    got = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fk.LAUNCHES_BY_FORM == {"float32": 0, "f32_wgmma": 0,
                                   "bf16_mma": 0, "bf16_wgmma": 0,
                                   "f16_mma": 0, "f16_wgmma": 0,
                                   f"{TAG16[dtype]}_wgmma": 1}
    assert got.shape == (b, h, sq, d) and torch.isfinite(got.float()).all()
    _close_bf16(got, attention_ref(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,window,cap,layout", WGMMA_FORMS)
def test_flash_attention_wgmma_f16_form(b, sq, sk, h, kv, d, window, cap,
                                        layout):
    """The wgmma form's fp16 library (wgmma .f16, TMA FLOAT16 maps) at the
    bf16 form's shapes, within F16_TOL; one launch of ``f16_wgmma``."""
    test_flash_attention_wgmma_form(b, sq, sk, h, kv, d, window, cap,
                                    layout, dtype=F16)


F32_WGMMA_FORMS = WGMMA_FORMS + [
    (1, 1369, 1369, 25, 5, 64, 1024, 0.0, "model"),  # hymba, windowed
    (1, 951, 951, 24, 8, 64, 0, 0.0, "model"),       # granite-moe
    (1, 923, 923, 32, 32, 64, 0, 0.0, "model"),      # musicgen-large
    (1, 200, 200, 2, 1, 128, 70, 30.0, "contiguous")]  # window and cap


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,window,cap,layout", F32_WGMMA_FORMS)
def test_flash_attention_f32_wgmma_form(b, sq, sk, h, kv, d, window, cap,
                                        layout):
    """The fp32 wgmma form (3xTF32 on wgmma, TMA; d 64 dealt, d 128 and 256
    split between the consumers) against its plain version within atol =
    rtol = 1e-4 at the bf16 form's shapes and the fp32 serve paths' prefill
    shapes; each call one launch of ``f32_wgmma``."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(sq + sk + d + h)
    q = torch.randn((b, h, sq, d), generator=gen, device=dev)
    k = torch.randn((b, kv, sk, d), generator=gen, device=dev)
    v = torch.randn((b, kv, sk, d), generator=gen, device=dev)
    if layout == "model":
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    kw = dict(window=window, logit_cap=cap)
    fk.reset_counts()
    got = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fk.LAUNCHES_BY_FORM == {"float32": 0, "f32_wgmma": 1,
                                   "bf16_mma": 0, "bf16_wgmma": 0,
                                   "f16_mma": 0, "f16_wgmma": 0}
    assert got.shape == (b, h, sq, d) and torch.isfinite(got).all()
    torch.testing.assert_close(got, attention_ref(q, k, v, **kw), **TOL)


@pytest.mark.gpu
def test_flash_attention_f32_wgmma_form_takes_only_its_shapes():
    """fp32 shapes outside the wgmma form launch the mma.sync ``float32``
    form (rows one value off 16 bytes, a base one value off, d 72, d != dv,
    the wide 576 / 512); an aligned call launches ``f32_wgmma``."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(4)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    q, k, v = rand(1, 4, 130, 64), rand(1, 2, 130, 64), rand(1, 2, 130, 64)
    pad = [torch.cat([t, t[..., :1]], -1)[..., :64] for t in (q, k, v)]
    off = [rand(1, 4, 130, 65)[..., 1:], k, v]
    cases = [(pad, "float32"), (off, "float32"),
             ([rand(1, 4, 90, 72), rand(1, 2, 90, 72), rand(1, 2, 90, 72)],
              "float32"),
             ([rand(1, 4, 90, 256), rand(1, 2, 90, 256),
               rand(1, 2, 90, 128)], "float32"),
             ([rand(1, 16, 70, 576), rand(1, 1, 70, 576),
               rand(1, 1, 70, 512)], "float32"),
             ([q, k, v], "f32_wgmma")]
    for (q, k, v), form in cases:
        fk.reset_counts()
        got = flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        assert fk.LAUNCHES_BY_FORM[form] == 1, fk.LAUNCHES_BY_FORM
        assert fk.LAUNCHES["flash_attention"] == 1
        torch.testing.assert_close(got, attention_ref(q, k, v), **TOL)


@pytest.mark.gpu
def test_flash_attention_wgmma_form_takes_only_its_shapes():
    """Shapes outside the wgmma form launch the mma.sync bf16 form: rows
    one value off 16 bytes ("pad"), d 72, d != dv, the wide 576 / 512."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(3)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(BF16)
    q, k, v = rand(1, 4, 130, 64), rand(1, 2, 130, 64), rand(1, 2, 130, 64)
    pad = [torch.cat([t, t[..., :1]], -1)[..., :64] for t in (q, k, v)]
    cases = [pad, [rand(1, 4, 90, 72), rand(1, 2, 90, 72),
                   rand(1, 2, 90, 72)],
             [rand(1, 4, 90, 256), rand(1, 2, 90, 256), rand(1, 2, 90, 128)],
             [rand(1, 16, 70, 576), rand(1, 1, 70, 576), rand(1, 1, 70, 512)]]
    for q, k, v in cases:
        fk.reset_counts()
        got = flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        assert fk.LAUNCHES_BY_FORM["bf16_mma"] == 1, fk.LAUNCHES_BY_FORM
        _close_bf16(got, attention_ref(q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("g", [16, 64, 128])
@pytest.mark.parametrize("entry,dk,dv,q_dtype,pool_dtype", [
    ("pool", 576, 576, torch.float32, torch.float32),   # zero-copy, fp32
    ("split", 576, 512, torch.float32, torch.float32),  # the baseline's
    ("split", 576, 512, BF16, BF16),                    # bf16 split pools
    ("pool", 576, 576, BF16, torch.float32),            # bf16 q, fp32 pool
    ("pool", 576, 576, BF16, BF16),
    ("split", 576, 512, F16, F16),                      # the fp16 forms
    ("pool", 576, 576, F16, torch.float32),
    ("pool", 576, 576, F16, F16)])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (100, 50.0)])
def test_paged_attention_packed_form(g, entry, dk, dv, q_dtype, pool_dtype,
                                     window, cap):
    """The packed instantiation (a KV head's query rows on the tensor
    cores, the cut's balanced segments merged) against its plain version:
    deepseek-v3's widths (scale 1/sqrt(192)) at groups of 16, 64 and 128
    rows on one or two KV heads, every dtype form, holes past each length
    and one below, a lane of length 0 (zeros) and a full one; fp32 within
    ATTN's fp32 tolerance, bf16 output within one bf16 step. One launch of
    the packed instantiation a call; the stripe entry's log-sum-exp, from
    the merge, on the split pools."""
    dev = _cuda()
    from repro_torch.kernels.paged_attention import kernel as pk
    kv = 2 if g == 16 else 1
    q, pools, table, lengths = _mla_paged_case(
        dev, 6, g * kv, kv, dk, dv, 32, 24, g + dk + window,
        n_planes=8 if entry == "pool" else 0)
    q = q.to(F16 if q_dtype == F16 else BF16).to(q_dtype)
    pools = tuple(p.to(q_dtype).to(pool_dtype) if q_dtype != torch.float32
                  else p for p in pools)
    kw = dict(window=window, logit_cap=cap, scale=1.0 / np.sqrt(192.0))
    pk.reset_counts()
    if entry == "split":
        got = paged_attention_fwd(q, *pools, table, lengths, **kw)
        want = paged_attention_ref(q, *pools, table, lengths, **kw)
    else:
        got = paged_attention_pool_fwd(q, pools[0], table, lengths,
                                       k_plane=6, v_plane=7, **kw)
        want = paged_attention_pool_ref(q, pools[0], table, lengths,
                                        k_plane=6, v_plane=7, **kw)
    torch.cuda.synchronize()
    assert pk.LAUNCHES_BY_INSTANCE == {"lanes": 0, "packed": 1}
    assert got.shape == (6, g * kv, dv) and not got[0].any()
    if q_dtype != torch.float32:
        _close_bf16(got, want, q_dtype)
    else:
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, **TOL)
    if entry == "split":
        out, lse = pk.paged_attention_lse_fwd(q, *pools, table, lengths,
                                              **kw)
        want_out, want_lse = paged_attention_ref(q, *pools, table, lengths,
                                                 return_lse=True, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
        assert bool((lse[0] == pk.NEG_INF).all())


@pytest.mark.gpu
@pytest.mark.parametrize("entry,dv,page,p_max", [
    ("pool", 576, 4, 16384),      # 64k positions, 512 pages a segment
    ("split", 512, 32, 4096)])    # 128k positions at deepseek-v3's page
def test_paged_attention_packed_form_long_table(entry, dv, page, p_max):
    """The packed instantiation over block tables of thousands of pages in
    fp32: its shared memory does not grow with the table (a segment's
    pages are compacted a fixed number at a time, so segments longer than
    that carry the rows' softmax across chunks), against the plain
    version within the fp32 tolerance."""
    dev = _cuda()
    from repro_torch.kernels.paged_attention import kernel as pk
    q, pools, table, lengths = _mla_paged_case(
        dev, 2, 128, 1, 576, dv, page, p_max, p_max + page,
        n_planes=2 if entry == "pool" else 0)
    kw = dict(scale=1.0 / np.sqrt(192.0))
    pk.reset_counts()
    if entry == "split":
        got = paged_attention_fwd(q, *pools, table, lengths, **kw)
        want = paged_attention_ref(q, *pools, table, lengths, **kw)
    else:
        got = paged_attention_pool_fwd(q, pools[0], table, lengths,
                                       k_plane=0, v_plane=1, **kw)
        want = paged_attention_pool_ref(q, pools[0], table, lengths,
                                        k_plane=0, v_plane=1, **kw)
    torch.cuda.synchronize()
    assert pk.LAUNCHES_BY_INSTANCE == {"lanes": 0, "packed": 1}
    assert got.shape == (2, 128, dv) and not got[0].any()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


def _example_weights(cfg):
    """A seeded draw of the port's params on the CPU, as numpy (the form
    the examples' ``params=`` takes), so the card and the CPU run one
    model."""
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_map
    return tree_map(lambda t: t.numpy(),
                    init_params(torch.Generator().manual_seed(0), cfg))


@pytest.mark.gpu
@pytest.mark.parametrize("name,arch", [("serve_paged", "gemma2-2b"),
                                       ("fork_sessions", "granite-3-8b")])
def test_serving_examples_on_the_card(name, arch):
    """A serving example through its ``main`` on the card: the DBS write
    and read, paged and flash kernels all launch and no plain version
    runs; its tokens equal the same example's on the CPU from the same
    weights, each request up to its first step whose top-2 logit margin
    is under 1e-3 (a near tie may break either way)."""
    _cuda()
    import importlib

    from repro_torch.configs import smoke_config
    from repro_torch.kernels.dbs import rw_kernel
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    params = _example_weights(smoke_config(arch))
    for m in (rw_kernel, pk, fk):
        m.reset_counts()
    card = mod.main(["--device", "cuda"], params=params, record_logits=True)
    torch.cuda.synchronize()
    launches = {**rw_kernel.LAUNCHES, **pk.LAUNCHES, **fk.LAUNCHES}
    plain = {**rw_kernel.PLAIN_CALLS, **pk.PLAIN_CALLS, **fk.PLAIN_CALLS}
    assert min(launches.values()) > 0 and not any(plain.values()), \
        (launches, plain)
    cpu = mod.main(["--device", "cpu"], params=params)
    assert set(card["outs"]) == set(cpu["outs"])
    for rid, want in cpu["outs"].items():
        got, trace = card["outs"][rid], card["logits"][rid]
        offset = len(got) - len(trace)          # a fork's copied tokens
        for t, (a, b) in enumerate(zip(got, want)):
            if t >= offset:
                top = np.sort(trace[t - offset])[-2:]
                if top[1] - top[0] < 1e-3:
                    break
            assert a == b, (rid, t, got, want)
    assert card["dbs"] == cpu["dbs"]


@pytest.mark.gpu
def test_train_lm_example_on_the_card_saves_and_resumes(tmp_path):
    """``examples.train_lm`` on the card, its bf16 plan at 2 steps of 2 x
    32 tokens: finite losses, no kernel launched (the kernels refuse
    grad), a store sized to its 812 MB state, and a restart that resumes
    at step 2 with the params and AdamW state bit for bit."""
    dev = _cuda()
    from repro_torch.examples import train_lm
    from repro_torch.models.model import tree_leaves
    from repro_torch.training.trainer import Trainer, ckpt_capacity
    out = train_lm.main(["--steps", "2", "--batch", "2", "--seq", "32",
                         "--ckpt-dir", str(tmp_path), "--device", "cuda"])
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    state = {"params": out["params"], "opt": out["opt_state"]}
    assert out["ckpt_capacity"] == ckpt_capacity(state) > 3 * 800e6
    tr = Trainer(train_lm.CFG_100M, train_lm.PLAN, None,
                 ckpt_dirs=out["ckpt_dirs"], device=dev)
    assert tr.step == 2
    for a, b in zip(tree_leaves({"params": tr.params, "opt": tr.opt_state}),
                    tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tr.ckpt.close()


# ---------------------------------------------------------------------------
# the DBS kernels' other dtypes and the scan's bf16 form
# ---------------------------------------------------------------------------
def _pool_of(dev, gen, shape, dtype, offset=False):
    """Seeded values in ``dtype`` (random bytes for the integer dtypes);
    with ``offset``, a view one element into a larger buffer, so the base
    is aligned to the element alone."""
    n = int(np.prod(shape)) + int(offset)
    if dtype.is_floating_point:
        flat = torch.randn(n, generator=gen, device=dev).to(dtype)
    else:
        flat = torch.randint(0, 256, (n * dtype.itemsize,), generator=gen,
                             device=dev, dtype=torch.uint8).view(dtype)
    return flat[int(offset):].view(shape)


# dtype, extents, page, D, lanes, offset base, the write/read word (bytes)
DBS_FORMS = [(torch.float16, 33, 8, 16, 12, False, 16),     # fp16 pools
             (torch.float16, 16, 32, 26624, 8, True, 2),
             (torch.bfloat16, 33, 8, 16, 12, False, 16),
             (torch.bfloat16, 16, 4, 6, 8, False, 4),     # 12-byte blocks
             (torch.bfloat16, 16, 4, 7, 8, False, 2),
             (torch.bfloat16, 2048, 32, 4096, 64, False, 16),
             (torch.bfloat16, 16, 32, 26624, 8, True, 2),
             (torch.uint8, 33, 8, 16, 12, False, 16),
             (torch.uint8, 16, 4, 7, 8, False, 1),
             (torch.uint8, 40, 32, 4096, 64, True, 1),
             (torch.int64, 16, 4, 3, 8, False, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n_e,page,d,b,offset,word", DBS_FORMS)
def test_dbs_rw_kernels_other_dtypes(dtype, n_e, page, d, b, offset, word):
    """The write and read kernels on pools of other dtypes (the access
    word from the block's bytes and the pool's alignment), bit for bit;
    a payload of another dtype is refused."""
    from repro_torch.kernels._build import word_bytes
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(d + b)
    pool = _pool_of(dev, gen, (n_e + 1, page, d), dtype, offset)
    ref = pool.clone()
    assert word_bytes(d * pool.element_size(), pool) == word
    for src, dst, lane_of in _legal_batches(n_e, page, b, 4, n_e):
        src, dst, lane_of = src.to(dev), dst.to(dev), lane_of.to(dev)
        pay = _pool_of(dev, gen, (b, d), dtype)
        dbs_rw_write(pool, src, dst, lane_of, pay, check_routing=True)
        dbs_rw_write_ref(ref, src, dst, lane_of, pay)
    torch.cuda.synchronize()
    assert torch.equal(pool.view(torch.uint8), ref.view(torch.uint8))
    lane = torch.arange(b, device=dev, dtype=torch.int32)
    ext = torch.where(lane % 3 == 0, -1, lane * 7 % (n_e + 1)).to(torch.int32)
    blk = (lane * 5 % page).to(torch.int32)
    got = dbs_rw_read(pool, ext, blk)
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.uint8),
                       dbs_rw_read_ref(pool, ext, blk).view(torch.uint8))
    assert not got[0].view(torch.uint8).any()
    with pytest.raises(TypeError, match="payload"):
        dbs_rw_write(pool, src, dst, lane_of, pay.float() if dtype !=
                     torch.float32 else pay.double())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n_e,page,d,b,offset,_word", DBS_FORMS)
def test_dbs_copy_kernel_other_dtypes(dtype, n_e, page, d, b, offset, _word):
    """The copy kernel on pools of other dtypes: live copies, masked lanes
    with dst -1, a live copy into extent 0, bit for bit; one launch of the
    pool's dtype (``LAUNCHES_BY_DTYPE``)."""
    dev = _cuda()
    e = max(n_e, 2 * b + 2)
    rng = np.random.default_rng(e + d)
    gen = torch.Generator(device=dev).manual_seed(e)
    pool = _pool_of(dev, gen, (e, page, d), dtype, offset)
    src = rng.integers(1, e // 2, b).astype(np.int32)
    dst = (np.arange(b) + e // 2).astype(np.int32)
    mask = rng.random(b) < 0.7
    mask[0], dst[0] = True, 0
    dst[~mask] = -1
    args = [torch.from_numpy(x).to(dev) for x in (src, dst, mask)]
    untouched = pool.clone()
    ref = dbs_copy_ref(pool.clone(), *args)
    copy_kernel.reset_counts()
    got = dbs_copy(pool, *args, check_routing=True)
    torch.cuda.synchronize()
    key = str(dtype).split(".")[1]
    assert copy_kernel.LAUNCHES_BY_DTYPE[key] == 1 == \
        copy_kernel.LAUNCHES["dbs_copy"]
    assert got is pool
    assert torch.equal(pool.view(torch.uint8), ref.view(torch.uint8))
    assert torch.equal(pool[0].view(torch.uint8),
                       untouched[int(src[0])].view(torch.uint8))


Y_BF16_TOL = dict(atol=1e-4, rtol=1e-4 + 2 ** -7)     # TOL + one bf16 step
# fp16's y: F16_TOL (the reference's tolerance for a non-bf16 dtype)
RWKV_16_SHAPES = [
    (2, 128, 3, 64, 32), (2, 97, 3, 32, 64), (3, 61, 2, 16, 16),
    (1, 513, 40, 64, 64), (8, 1, 40, 64, 64), (3, 5, 5, 40, 64),
    (2, 9, 3, 6, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,d,chunk", RWKV_16_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_bf16_form(b, s, h, d, chunk, with_state, u_dtype,
                              dtype=BF16):
    """bf16 r, k, v and logw (views of one buffer: the model layout) in
    both schedules, rwkv6-3b's prefill and decode among them, hd 40 and 6
    (the 2-byte loads): y bf16 within Y_BF16_TOL of the plain chunked
    version on the same bf16 inputs, the state fp32 within TOL; one launch
    of the bf16 form."""
    from repro_torch.kernels.rwkv6_scan import kernel as sk
    dev = _cuda()
    r, k, v, logw, u, s0 = _rwkv_case(dev, b, s, h, d, s * 13 + d,
                                      with_state)
    buf = torch.stack((r, k, v, logw), 2).to(dtype)
    r, k, v, logw = buf.unbind(2)
    u = u.to(u_dtype)
    sk.reset_counts()
    y, st = rwkv6_scan_fwd(r, k, v, logw, u, chunk=chunk,
                           s0=s0 if with_state else None)
    torch.cuda.synchronize()
    key = str(dtype).split(".")[1]
    assert sk.LAUNCHES_BY_DTYPE == {"float32": 0, "bfloat16": 0,
                                    "float16": 0, key: 1}
    assert y.dtype == dtype and st.dtype == torch.float32
    want_y, want_s = rwkv6_chunked_ref(r, k, v, logw, u, s0, chunk=chunk)
    assert want_y.dtype == dtype
    torch.testing.assert_close(y.float(), want_y.float(),
                               **(Y_BF16_TOL if dtype == BF16 else F16_TOL))
    torch.testing.assert_close(st, want_s, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,d,chunk", RWKV_16_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.float16])
def test_rwkv6_scan_f16_form(b, s, h, d, chunk, with_state, u_dtype):
    """The scan's fp16 form (the same template over fp16) at the bf16
    form's shapes, u fp32 or fp16: y fp16 within F16_TOL, the state fp32
    within TOL; one launch of the fp16 form."""
    test_rwkv6_scan_bf16_form(b, s, h, d, chunk, with_state, u_dtype,
                              dtype=F16)


@pytest.mark.gpu
def test_rwkv6_scan_refuses_mixed_dtypes_on_the_card():
    """A mix of fp32, bf16 and fp16 among r, k, v and logw, fp64, and a u
    of the other 16-bit dtype raise on the card as on the CPU."""
    dev = _cuda()
    r, k, v, logw, u, _ = _rwkv_case(dev, 1, 8, 2, 16, 0, False)
    bf = [t.to(torch.bfloat16) for t in (r, k, v, logw)]
    for i in range(4):
        mixed = list(bf)
        mixed[i] = mixed[i].float()
        with pytest.raises(TypeError, match="one dtype"):
            rwkv6_scan_fwd(*mixed, u)
        mixed[i] = mixed[i].half()
        with pytest.raises(TypeError, match="one dtype"):
            rwkv6_scan_fwd(*mixed, u)
    with pytest.raises(TypeError):
        rwkv6_scan_fwd(*(t.double() for t in (r, k, v, logw)), u)
    with pytest.raises(TypeError, match="u"):
        rwkv6_scan_fwd(*bf, u.half())
    with pytest.raises(TypeError, match="u"):
        rwkv6_scan_fwd(*(t.half() for t in bf), u.bfloat16())
