"""The schedules of flash attention's wgmma form and paged attention's
packed form, and the shape rules that pick them, on the CPU (no card).

- ``flash_form``: which instantiation a call of flash attention launches
  (fp32 and bf16 on wgmma where d = dv is 64, 128 or 256 with 16-byte
  aligned bases and strides, in bytes; on mma.sync otherwise), from
  shapes alone.
- ``paged_form`` / ``PACKED_ROWS`` / ``paged_block_rows`` /
  ``paged_splits``: when a KV head's group goes to the packed
  instantiation (a wide head dim, at least ``PACKED_MIN_G`` rows), its
  rows a block (32), and the split count at deepseek-v3's g = 128
  against the merge's cap.
- The wgmma kernel's arithmetic, emulated in torch: 64-row query tiles,
  64-key tiles dealt alternately to two warpgroups and their states
  merged, the online softmax in log2 units, P split into bf16 hi and lo
  parts (two products), held against the plain version in the working
  type (BF16_TOL: atol 1e-4, rtol 2^-7, one bf16 step).
- ``paged_packed_cut``: the packed form's cut of every sequence's live
  pages, laid end to end, into equal blocks: the segments tile each
  sequence's pages once, every block's share within one page of the
  others, the slots s + i distinct.
- The packed kernel's arithmetic, emulated: rows of a KV head's group in
  tiles of 32, the cut's segments in 16-position tiles of their live
  pages, S over d in eight parts, 3xTF32 products over fp32 pools
  (emulated as ``tests/test_torch_flash_tf32x3.py`` does) or the K-only
  split (two products) for bf16 q, whose values are exact in TF32; each
  sequence's segments merged as the merge kernel does. Held against the
  plain version in fp32 within the fp32 tolerance (atol = rtol = 1e-4);
  one TF32 product of K misses it.
Inputs come from seeded numpy generators.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_form)
from repro_torch.kernels.paged_attention.kernel import (  # noqa: E402
    MERGE_FLOATS, PACKED_MIN_G, paged_block_rows, paged_form,
    PACKED_ROWS, paged_live_range, paged_partial_floats, paged_splits)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref)

BF16, F32 = torch.bfloat16, torch.float32
BF16_TOL = dict(atol=1e-4, rtol=2 ** -7)
TOL = dict(atol=1e-4, rtol=1e-4)
LOG2E = 1.4426950408889634
NEG_INF = -1e30
WGMMA_ROWS = 64          # the wgmma kernel's query rows a block (kBM)
WGMMA_KEYS = 64          # and keys a K/V tile (kBN)


def paged_packed_cut(n_pages, n_blocks: int):
    """The packed instantiation's cut, as ``paged_packed_kernel`` makes it
    on the card from lengths: the sequences' live page counts ``n_pages``
    laid end to end, W pages, and block s of ``n_blocks`` takes pages
    [s W / n_blocks, (s + 1) W / n_blocks). Returns its segments (s,
    sequence, lo, hi), lo and hi counted from the sequence's first live
    page; segment (s, i) writes partial slot s + i."""
    total = sum(n_pages)
    out = []
    starts = [0]
    for n in n_pages:
        starts.append(starts[-1] + n)
    for s in range(n_blocks):
        g0, g1 = s * total // n_blocks, (s + 1) * total // n_blocks
        for i, n in enumerate(n_pages):
            a, e = max(g0, starts[i]), min(g1, starts[i] + n)
            if a < e:
                out.append((s, i, a - starts[i], e - starts[i]))
    return out


# ---------------------------------------------------------------------------
# the shape rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d,dv,dtype,strides,ptrs,want", [
    (256, 256, F32, (2048, 256), (0,), "f32_wgmma"),
    (256, 256, F32, (4096, 256, 1024), (0, 16, 4096), "f32_wgmma"),  # gemma2
    (64, 64, F32, (2240, 64), (32,), "f32_wgmma"),
    (128, 128, F32, (4096, 128), (0, 64), "f32_wgmma"),
    (576, 512, F32, (576,), (0,), "float32"),        # the wide form
    (72, 72, F32, (72,), (0,), "float32"),           # d not 64/128/256
    (64, 64, F32, (65, 64), (0,), "float32"),        # a row off 16 bytes
    (64, 64, F32, (64,), (0, 8), "float32"),         # a base off 16 bytes
    (64, 64, F32, (66,), (0,), "float32"),           # 16 bytes in bf16 only
    (256, 256, BF16, (4096, 256, 1024), (0, 16, 4096), "bf16_wgmma"),
    (64, 64, BF16, (2240, 64), (32,), "bf16_wgmma"),
    (128, 128, BF16, (), (), "bf16_wgmma"),
    (256, 128, BF16, (4096,), (0,), "bf16_mma"),       # d != dv
    (576, 512, BF16, (576,), (0,), "bf16_mma"),        # the wide form
    (72, 72, BF16, (72,), (0,), "bf16_mma"),           # d not 64/128/256
    (64, 64, BF16, (65, 64), (0,), "bf16_mma"),        # a row off 16 bytes
    (64, 64, BF16, (64,), (0, 8), "bf16_mma")])        # a base off 16 bytes
def test_flash_form(d, dv, dtype, strides, ptrs, want):
    assert flash_form(d, dv, dtype, strides, ptrs) == want


def test_paged_form_and_rows():
    assert paged_form(128, 576, 576) == "packed"
    assert paged_form(128, 576, 512) == "packed"
    assert paged_form(PACKED_MIN_G, 300, 300) == "packed"
    assert paged_form(PACKED_MIN_G - 1, 576, 512) == "lanes"   # small group
    assert paged_form(128, 256, 256) == "lanes"                 # narrow
    assert paged_form(2, 256, 256) == "lanes"
    assert PACKED_ROWS == 32
    assert paged_block_rows(128, 1, 576, 576) == 4
    assert paged_block_rows(256, 2, 576, 512) == 8   # 2 KV heads of 128
    assert paged_block_rows(8, 4, 256, 256) == 4    # lanes: 1 a KV head
    assert paged_block_rows(48, 1, 576, 512) == 2   # 48 rows: 2 tiles


def test_paged_packed_cut_tiles_every_sequence():
    rng = np.random.default_rng(5)
    for trial in range(40):
        n_pages = list(rng.integers(0, 40, rng.integers(1, 12)))
        if trial % 5 == 0:
            n_pages[0] = 0
        nb = int(rng.integers(1, 70))
        segs = paged_packed_cut(n_pages, nb)
        for i, n in enumerate(n_pages):
            mine = sorted((lo, hi) for _s, j, lo, hi in segs if j == i)
            assert sum(hi - lo for lo, hi in mine) == n
            assert all(a[1] == b[0] for a, b in zip(mine, mine[1:]))
        share = {}
        for s, _i, lo, hi in segs:
            share[s] = share.get(s, 0) + hi - lo
        total = sum(n_pages)
        assert all(total // nb <= share.get(s, 0) <= -(-total // nb)
                   for s in range(nb))
        slots = [s + i for s, i, _lo, _hi in segs]
        assert len(set(slots)) == len(slots) and max(slots, default=0) < (
            nb + len(n_pages))
    # the scratch: the slots of every KV head, then (b, h) log-sum-exps
    assert paged_partial_floats(8, 128, 1, 576, 4, "packed") == (
        (32 + 8) * 128 * 578 + 8 * 128)
    assert paged_partial_floats(8, 8, 4, 256, 1, "lanes") == 0


@pytest.mark.parametrize("sms", (78, 114, 132))
def test_paged_splits_of_the_packed_form_at_g_128(sms):
    """The packed form's rows (b x row tiles) in ``paged_splits``: one
    block an SM, at most one share a page, and the merge's cap at g = 128
    (MERGE_FLOATS // 128 - 1 = 95 shares)."""
    for b in (1, 2, 8, 64):
        rows = b * paged_block_rows(128, 1, 576, 576)
        for p_max in (1, 32, 64, 200, 4096):
            n = paged_splits(p_max, rows, sms, 128, 576)
            assert 1 <= n <= min(p_max, 95)
            assert 128 * (n + 1) <= MERGE_FLOATS
            assert rows * n <= max(sms, rows)
    # deepseek-v3's serving decode: 8 slots, 64-page tables, 132 SMs
    assert paged_splits(64, 8 * 4, 132, 128, 576) == 4


# ---------------------------------------------------------------------------
# flash: the wgmma form's schedule
# ---------------------------------------------------------------------------
def _bf16_split(p):
    hi = p.to(BF16).float()
    return hi, (p - hi).to(BF16).float()


def _wg_tiles(q, k, v, q0, tiles, t_first, off, causal, window, cap, scale):
    """One consumer warpgroup: 64 rows from q0 over its key tiles, the
    online softmax in log2 units; returns (o, m, l) unnormalised."""
    sq, sk = q.shape[0], k.shape[0]
    rows = torch.arange(q0, q0 + WGMMA_ROWS)
    qt = torch.zeros((WGMMA_ROWS, q.shape[1]))
    n = max(0, min(sq, q0 + WGMMA_ROWS) - q0)
    qt[:n] = q[q0:q0 + n]
    pos = rows + off
    o = torch.zeros((WGMMA_ROWS, v.shape[1]))
    m = torch.full((WGMMA_ROWS,), NEG_INF)
    l = torch.zeros(WGMMA_ROWS)
    for it in tiles:
        k0 = (t_first + it) * WGMMA_KEYS
        kpos = torch.arange(k0, k0 + WGMMA_KEYS)
        kt = torch.zeros((WGMMA_KEYS, k.shape[1]))
        vt = torch.zeros((WGMMA_KEYS, v.shape[1]))
        nk = max(0, min(sk, k0 + WGMMA_KEYS) - k0)
        kt[:nk], vt[:nk] = k[k0:k0 + nk], v[k0:k0 + nk]
        s = qt @ kt.T                      # bf16 x bf16 products, exact
        x = (cap * LOG2E * torch.tanh(s * scale / cap) if cap
             else s * scale * LOG2E)
        ok = kpos[None, :] < sk
        if causal:
            ok = ok & (kpos[None, :] <= pos[:, None])
        if window:
            ok = ok & (kpos[None, :] > pos[:, None] - window)
        x = torch.where(ok, x, -math.inf)
        m_new = torch.maximum(m, x.amax(1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[:, None])
        l = l * corr + p.sum(1)
        hi, lo = _bf16_split(p)
        o = o * corr[:, None] + lo @ vt + hi @ vt
        m = m_new
    return o, m, l


def flash_wgmma_emulated(q, k, v, *, window=0, logit_cap=0.0, scale=None,
                         causal=True):
    """The wgmma kernel's function: (B, H, Sq, d) bf16 q, (B, KV, Sk, d) k
    and v -> (B, H, Sq, d) fp32 before the output's rounding; a block's
    key tiles dealt alternately to two warpgroups, merged at the end."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros((b, h, sq, v.shape[-1]))
    off = sk - sq
    for bi in range(b):
        for hh in range(h):
            kh = hh // (h // kv)
            for q0_blk in range(0, sq, WGMMA_ROWS):
                q_last = min(q0_blk + WGMMA_ROWS, sq) - 1
                k_end = min(sk, q_last + off + 1) if causal else sk
                t_first = (max(0, q0_blk + off - window + 1)
                           if window else 0) // WGMMA_KEYS
                n_tiles = max(0, -(-(k_end - t_first * WGMMA_KEYS)
                                   // WGMMA_KEYS))
                (o0, m0, l0), (o1, m1, l1) = (
                    _wg_tiles(qf[bi, hh], kf[bi, kh], vf[bi, kh], q0_blk,
                              range(first, n_tiles, 2), t_first, off, causal,
                              window, logit_cap, scale) for first in (0, 1))
                mm = torch.maximum(m0, m1)      # merged through shared memory
                ca, cb = torch.exp2(m0 - mm), torch.exp2(m1 - mm)
                o = o0 * ca[:, None] + o1 * cb[:, None]
                l = l0 * ca + l1 * cb
                n = max(0, min(sq, q0_blk + WGMMA_ROWS) - q0_blk)
                res = o / torch.clamp(l, min=1e-30)[:, None]
                out[bi, hh, q0_blk:q0_blk + n] = res[:n]
    return out


def _flash_inputs(seed, b, h, kv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        BF16) for s in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d))]


@pytest.mark.parametrize("b,h,kv,sq,sk,d,window,cap", [
    (1, 4, 2, 150, 150, 64, 0, 50.0),      # ragged last tiles, the cap
    (1, 2, 1, 200, 200, 128, 70, 0.0),     # a window crossing key tiles
    (1, 2, 1, 40, 300, 64, 0, 30.0),       # Sk >> Sq
    (1, 2, 1, 130, 130, 256, 0, 50.0),     # gemma2's head dim and cap
    (2, 2, 2, 60, 60, 64, 0, 0.0),         # one key tile: one warpgroup
    (1, 2, 1, 1, 1, 64, 0, 0.0)])          # a single query
def test_flash_wgmma_schedule_matches_plain(b, h, kv, sq, sk, d, window,
                                            cap):
    q, k, v = _flash_inputs(sq + d + window, b, h, kv, sq, sk, d)
    got = flash_wgmma_emulated(q, k, v, window=window, logit_cap=cap)
    want = attention_ref(q, k, v, window=window, logit_cap=cap)
    torch.testing.assert_close(got.to(BF16).float(), want.to(BF16).float(),
                               **BF16_TOL)


# ---------------------------------------------------------------------------
# paged: the packed form's schedule
# ---------------------------------------------------------------------------
def tf32(x):
    """fp32 rounded to TF32 (10 mantissa bits), to nearest, ties away."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(F32)


def tf32_truncated(x):
    """The TF32 bits the tensor core reads of an fp32 register."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(F32)


def _product(a, b, mode):
    """a @ b as the packed kernel takes it: ``x3`` (3xTF32: a_lo.b_hi +
    a_hi.b_lo + a_hi.b_hi), ``k_split`` (a exact in TF32: a.b_hi + a.b_lo),
    ``one`` (a.tf32(b)) or ``exact`` (bf16 values: fp32 products)."""
    if mode == "exact":
        return a @ b
    bh = tf32(b)
    bl = tf32_truncated(b - bh)
    if mode == "one":
        return a @ bh
    if mode == "k_split":
        assert torch.equal(tf32(a), a)
        return a @ bl + a @ bh
    ah = tf32(a)
    al = tf32_truncated(a - ah)
    return al @ bh + ah @ bl + ah @ bh


def paged_packed_emulated(q, pool_k, pool_v, table, lengths, *, window=0,
                          logit_cap=0.0, scale=None, n_split=3, rows=32,
                          qk="x3", pv="x3"):
    """The packed kernel's function in fp32: for each KV head and tile of
    ``rows`` query rows, the cut's segments (``paged_packed_cut`` of the
    sequences' live pages into b * n_split blocks), each in 16-position
    tiles of its live pages, S summed over eight parts of d, the online
    softmax, P.V; each sequence's segments merged as the merge kernel
    does."""
    b, h, d = q.shape
    _e, page, kv, _ = pool_k.shape
    dv = pool_v.shape[-1]
    p_max = table.shape[1]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), pool_k.float(), pool_v.float()
    ranges = [paged_live_range(int(n), p_max, page, window) for n in lengths]
    segs = paged_packed_cut([last - first for first, last in ranges],
                            b * n_split)
    parts_d = [(i * -(-d // 8), min(d, (i + 1) * -(-d // 8)))
               for i in range(8)]
    out = torch.zeros((b, h, dv))
    for kh in range(kv):
        for r0 in range(0, g, rows):
            partials = {i: [] for i in range(b)}
            for _s, bi, lo, hi in segs:
                length = int(lengths[bi])
                first = ranges[bi][0]
                lim = length - 1 - window
                qt = qf[bi, kh * g + r0:kh * g + min(g, r0 + rows)]
                o = torch.zeros((qt.shape[0], dv))
                m = torch.full((qt.shape[0],), NEG_INF)
                l = torch.zeros(qt.shape[0])
                for ip in range(first + lo, first + hi):
                    ext = int(table[bi, ip])
                    if ext < 0:
                        continue
                    for t0 in range(0, page, 16):
                        t = torch.arange(t0, min(page, t0 + 16))
                        pos = ip * page + t
                        ok = pos < length
                        if window:
                            ok &= pos > lim
                        kt = torch.where(ok[:, None], kf[ext, t, kh], 0.0)
                        vt = torch.where(ok[:, None], vf[ext, t, kh], 0.0)
                        s = sum(_product(qt[:, a:z], kt[:, a:z].T, qk)
                                for a, z in parts_d if z > a)
                        s = s * scale
                        if logit_cap:
                            s = torch.tanh(s / logit_cap) * logit_cap
                        mt = torch.where(ok, s, NEG_INF).amax(1)
                        m_new = torch.maximum(m, mt)
                        corr = torch.exp(m - m_new)
                        p = torch.where(ok, torch.exp(s - m_new[:, None]),
                                        0.0)
                        l = l * corr + p.sum(1)
                        if pv == "exact":         # bf16 pools: P in hi, lo
                            ph, pl = _bf16_split(p)
                            o = o * corr[:, None] + pl @ vt + ph @ vt
                        else:
                            o = o * corr[:, None] + _product(p, vt, pv)
                        m = m_new
                partials[bi].append((o, m, l))
            # the merge: m* over live segments, coefficients exp(m_s - m*)
            for bi, shares in partials.items():
                if not shares:                    # no live page: zeros
                    continue
                m_star = torch.stack([torch.where(l > 0, m, NEG_INF)
                                      for o, m, l in shares]).amax(0)
                num = torch.zeros_like(shares[0][0])
                den = torch.zeros_like(shares[0][2])
                for o, m, l in shares:
                    c = torch.where(l > 0, torch.exp(m - m_star), 0.0)
                    num += c[:, None] * o
                    den += c * l
                out[bi, kh * g + r0:kh * g + r0 + num.shape[0]] = (
                    num / torch.clamp(den, min=1e-30)[:, None])
    return out


def _paged_inputs(seed, b, h, kv, d, dv, page, p_max, q_dtype, pool_dtype):
    """Pools and a table with holes past each length and one below, a lane
    of length 0, a lane that is full."""
    rng = np.random.default_rng(seed)
    e = b * p_max + 2

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    q = arr(b, h, d).to(q_dtype)
    pk, pv = arr(e, page, kv, d).to(pool_dtype), arr(e, page, kv, dv).to(
        pool_dtype)
    table = rng.permutation(e - 1)[:b * p_max].reshape(b, p_max) + 1
    lengths = rng.integers(1, p_max * page + 1, b)
    lengths[0], lengths[-1] = 0, p_max * page
    for i in range(b):
        table[i, -(-lengths[i] // page):] = -1
    table[-1, 1] = -1
    return (q, pk, pv, torch.from_numpy(table.astype(np.int32)),
            torch.from_numpy(lengths.astype(np.int32)))


@pytest.mark.parametrize("form", ["float32", "bfloat16_q", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (20, 50.0)])
def test_paged_packed_schedule_matches_plain(form, window, cap):
    """deepseek-v3's widths (K 576, V 512, scale 1/sqrt(192)) at a small
    group (48 rows: a full and a ragged row tile of 32) and few pages;
    each form's products as the kernel takes them."""
    q_dtype = F32 if form == "float32" else BF16
    pool_dtype = BF16 if form == "bfloat16" else F32
    q, pk, pv, table, lengths = _paged_inputs(
        7 + window, 3, 48, 1, 576, 512, 8, 5, q_dtype, pool_dtype)
    kw = dict(window=window, logit_cap=cap, scale=1.0 / math.sqrt(192.0))
    qk, pv_mode = {"float32": ("x3", "x3"), "bfloat16_q": ("k_split", "x3"),
                   "bfloat16": ("exact", "exact")}[form]
    got = paged_packed_emulated(
        q, pk, pv, table, lengths, n_split=2,
        rows=PACKED_ROWS, qk=qk, pv=pv_mode, **kw)
    want = paged_attention_ref(q.float(), pk.float(), pv.float(), table,
                               lengths, **kw)
    assert not got[0].any()                     # length 0: zeros
    if form == "bfloat16":      # the output rounded once, in the working type
        torch.testing.assert_close(got.to(BF16).float(),
                                   want.to(BF16).float(), **BF16_TOL)
    else:
        torch.testing.assert_close(got, want, **TOL)


def test_paged_one_tf32_product_of_k_misses_the_tolerance():
    """Why the bf16-q form over the fp32 pool splits K: with one TF32
    product of the pool's values the output leaves the fp32 tolerance."""
    q, pk, pv, table, lengths = _paged_inputs(3, 2, 16, 1, 576, 576, 8, 4,
                                              BF16, F32)
    kw = dict(scale=1.0 / math.sqrt(192.0))
    want = paged_attention_ref(q.float(), pk, pv, table, lengths, **kw)
    got = paged_packed_emulated(q, pk, pv, table, lengths, n_split=1,
                                qk="one", pv="x3", **kw)
    assert not torch.allclose(got, want, **TOL)
