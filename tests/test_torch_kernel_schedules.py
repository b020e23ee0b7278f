"""The paged-attention and RWKV-6 kernels' host-side choices and the math
their schedules rest on, on the CPU (no card, no JAX).

- ``paged_splits`` / ``paged_split_range`` / ``paged_live_range``: the
  split count is a function of shapes and the SM count only, stays within
  what the kernel takes (at least 1, at most one split per page of the
  table, the grid's y limit, the merge's shared memory), the shares tile a
  sequence's live pages exactly and fit the kernel's list of
  ``ceil(p_max / n_split)`` pages, and the live range holds exactly the
  pages the plain version runs.
- The split-and-merge: per-share partials computed in plain torch, empty
  shares as (acc 0, m -1e30, l 0), merged by ``models/attention.py``
  ``merge_partials``, give ``paged_attention_ref``'s answer (atol 1e-5,
  rtol 1e-5: fp32 sums in another order) and zeros for a lane of holes.
- ``rwkv6_schedule`` / ``rwkv6_n_col``: the decode threshold, and the
  prefill grid's column split (slices of multiples of 8 columns, the grid
  within its blocks an SM, maximal).
- The prefill schedule's sub-chunk factorisation, emulated in float64
  (products taken plainly), against the step-by-step oracle within 1e-9,
  also where a chunk's decay sums below -88 and the chunked plain
  version's exp(-cum) overflows in fp32.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.paged_attention.kernel import (  # noqa: E402
    BLOCKS_PER_SM as PAGED_PER_SM, BLOCKS_PER_SM_WIDE, MAX_SPLITS,
    MERGE_FLOATS,
    paged_live_range, paged_row_groups, paged_split_range, paged_splits)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    NEG_INF, paged_attention_ref)
from repro_torch.kernels.rwkv6_scan.kernel import (  # noqa: E402
    BLOCKS_PER_SM as RWKV_PER_SM, DECODE_MAX, padded_dim, rwkv6_n_col,
    rwkv6_schedule)
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: E402
    rwkv6_chunked_ref, rwkv6_scan_ref)
from repro_torch.models.attention import merge_partials  # noqa: E402

SMS = (1, 78, 114, 132)


@pytest.mark.parametrize("sms", SMS)
def test_paged_splits_stay_within_the_kernel(sms):
    for p_max in (0, 1, 2, 5, 16, 64, 257):
        for rows in (1, 2, 3, 32, 100, 396, 397, 5000):
            for g in (1, 2, 12, 64):
                ng = paged_splits(p_max, rows, sms, g)
                assert 1 <= ng and g * (ng + 1) <= MERGE_FLOATS or ng == 1
            n = paged_splits(p_max, rows, sms)
            assert 1 <= n <= max(p_max, 1) and n <= MAX_SPLITS
            pps = -(-p_max // n)                 # the kernel's list length
            assert n * pps >= p_max              # the shares cover p_max
            assert rows * n <= max(PAGED_PER_SM * sms, rows)
    # the serving width: 8 sequences x 4 KV heads, g = 2, p_max 64
    assert paged_row_groups(8, 4) == 1
    assert paged_splits(64, 32, 132) == 12
    assert paged_row_groups(48, 4) == 3          # g = 12: three row groups


@pytest.mark.parametrize("sms", SMS)
def test_paged_splits_at_mla_width(sms):
    """MLA's decode (128 query heads on one latent KV head, 576 wide): 32
    row groups of 4, the merge's cap at g = 128 (MERGE_FLOATS // 128 - 1
    = 95 shares), and the wide instantiation's one resident block an SM
    in the fill; below 257 the narrow rule's three."""
    assert paged_row_groups(128, 1) == 32
    assert MERGE_FLOATS // 128 - 1 == 95
    for p_max in (1, 32, 64, 200, 4096):
        for b in (1, 2, 8):
            rows = b * paged_row_groups(128, 1)
            n = paged_splits(p_max, rows, sms, 128, 576)
            assert 1 <= n <= min(max(p_max, 1), 95)
            assert 128 * (n + 1) <= MERGE_FLOATS
            assert rows * n <= max(BLOCKS_PER_SM_WIDE * sms, rows)
            assert n <= paged_splits(p_max, rows, sms, 128, 256)
    # deepseek-v3's serving decode: 8 slots, 64 pages: one share
    assert paged_splits(64, 8 * 32, 132, 128, 576) == 1


def test_paged_split_ranges_tile_the_live_pages():
    for p_max in (1, 7, 64):
        for first in range(0, p_max + 1, 3):
            for last in range(first, p_max + 1, 2):
                for n_split in range(1, p_max + 1):
                    got = [paged_split_range(s, n_split, first, last)
                           for s in range(n_split)]
                    assert got[0][0] == first and got[-1][1] == last
                    for (a, b), (c, _) in zip(got, got[1:]):
                        assert a <= b == c
                    cap = -(-p_max // n_split)
                    assert all(b - a <= cap for a, b in got)


@pytest.mark.parametrize("page,window", [(4, 0), (4, 3), (8, 20), (32, 100),
                                         (32, 4096)])
def test_paged_live_range_holds_the_pages_that_run(page, window):
    p_max = 9
    for length in range(0, p_max * page + 1):
        first, last = paged_live_range(length, p_max, page, window)
        run = [ip for ip in range(p_max) if ip * page < length and (
            not window or ip * page + page - 1 > length - 1 - window)]
        assert list(range(first, last)) == run


def _split_partials(q, pk, pv, table, lengths, n_split, *, window, cap,
                    scale):
    """Per-share (acc, m, l) of every (sequence, KV head), as the kernel
    cuts and computes them; empty shares are (0, -1e30, 0)."""
    b, h, d = q.shape
    _, page, kv, dv = pv.shape
    g = h // kv
    p_max = table.shape[1]
    o = torch.zeros((n_split, b, kv, g, dv), dtype=torch.float64)
    m = torch.full((n_split, b, kv, g), NEG_INF, dtype=torch.float64)
    lsum = torch.zeros((n_split, b, kv, g), dtype=torch.float64)
    for bi in range(b):
        length = int(lengths[bi])
        first, last = paged_live_range(length, p_max, page, window)
        lim = length - 1 - window
        for s in range(n_split):
            lo, hi = paged_split_range(s, n_split, first, last)
            pos = [ip * page + t for ip in range(lo, hi)
                   if table[bi, ip] >= 0 for t in range(page)]
            pos = [x for x in pos
                   if x < length and (not window or x > lim)]
            if not pos:
                continue
            rows = [table[bi, x // page] for x in pos]
            ks = pk[rows, [x % page for x in pos]].double()  # (n, kv, d)
            vs = pv[rows, [x % page for x in pos]].double()
            qg = q[bi].double().reshape(kv, g, d)
            logit = torch.einsum("kgd,nkd->kgn", qg, ks) * scale
            if cap:
                logit = torch.tanh(logit / cap) * cap
            mx = logit.amax(-1)
            p = torch.exp(logit - mx[..., None])
            m[s, bi], lsum[s, bi] = mx, p.sum(-1)
            o[s, bi] = torch.einsum("kgn,nkd->kgd", p, vs)
    return o, m, lsum


@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (10, 30.0)])
def test_merged_split_partials_give_the_unsplit_answer(n_split, window,
                                                       cap):
    rng = np.random.default_rng(n_split * 10 + window)
    b, h, kv, d, page, p_max = 4, 4, 2, 8, 4, 9
    e = b * p_max + 2
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    pk, pv = (torch.from_numpy(rng.standard_normal(
        (e, page, kv, d)).astype(np.float32)) for _ in range(2))
    table = rng.permutation(e - 1)[:b * p_max].reshape(b, p_max) + 1
    lengths = np.array([p_max * page, 0, 13, p_max * page - 1])
    for i in range(b):
        table[i, -(-lengths[i] // page):] = -1
    table[0, 2:6] = -1                      # shares made of holes
    table[3, :] = -1                        # a lane of holes: zeros
    table = torch.from_numpy(table.astype(np.int32))
    lengths = torch.from_numpy(lengths.astype(np.int32))
    scale = 1 / math.sqrt(d)
    o, m, lsum = _split_partials(q, pk, pv, table, lengths, n_split,
                                 window=window, cap=cap, scale=scale)
    got = merge_partials(o, m, lsum).reshape(b, h, d).float()
    want = paged_attention_ref(q, pk, pv, table, lengths, window=window,
                               logit_cap=cap, scale=scale)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.isfinite(got).all()
    assert not got[1].any() and not got[3].any()


def test_rwkv6_schedule_switches_after_the_decode_threshold():
    assert [rwkv6_schedule(s) for s in (0, 1, 2, DECODE_MAX)] == \
        ["decode"] * 4
    assert rwkv6_schedule(DECODE_MAX + 1) == "prefill"


@pytest.mark.parametrize("sms", SMS)
def test_rwkv6_column_split_rule(sms):
    for d in range(1, 65):
        dp = padded_dim(d)
        assert dp in (16, 32, 64) and dp >= d
        for bh in (1, 2, 3, 20, 33, 40, 66, 100, 132, 133, 264, 1000):
            n = rwkv6_n_col(bh, 1, d, sms)
            assert n in (1, 2, 4, 8)
            assert (dp // n) % 8 == 0            # mma n8 tiles of columns
            assert n == 1 or bh * n <= RWKV_PER_SM * sms
            more = 2 * n
            assert (more > 8 or (dp // more) % 8 or
                    bh * more > RWKV_PER_SM * sms)
    assert rwkv6_n_col(1, 40, 64, 132) == 4      # 160 blocks at prefill


def _subchunk_scan(r, k, v, w, u, s0, chunk=64, sub=16):
    """The prefill schedule's algebra in float64: per chunk, sub-chunks
    of ``sub`` tokens with rt = r exp(lx), kh = k exp(tot - lc), the
    off-diagonal blocks through mid = exp(sum of the totals between), the
    diagonal blocks pairwise, the state through suf = exp(sum of the
    later totals). Every exponent is a sum of log decays, never
    positive."""
    b, s, h, d = r.shape
    st = s0.clone()
    ys = []
    tri = torch.tril(torch.ones(sub, sub, dtype=torch.bool), -1)
    for t0 in range(0, s, chunk):
        n = min(chunk, s - t0)
        nsub = -(-n // sub)

        def cut(x):
            x = x[:, t0:t0 + n]
            x = torch.cat([x, x.new_zeros(b, nsub * sub - n, h, d)], 1)
            return x.reshape(b, nsub, sub, h, d)
        rr, kk, vv, ww = cut(r), cut(k), cut(v), cut(w)
        lc = torch.cumsum(ww, 2)
        lx = lc - ww
        tot = lc[:, :, -1]                               # (b, nsub, h, d)
        rt = rr * torch.exp(lx)
        kh = kk * torch.exp(tot[:, :, None] - lc)
        y = torch.zeros(b, nsub, sub, h, d, dtype=r.dtype)
        new = torch.exp(tot.sum(1))[..., None] * st
        for a in range(nsub):
            pre = torch.exp(tot[:, :a].sum(1))[:, None]
            y[:, a] += torch.einsum("bihj,bhjc->bihc", rt[:, a] * pre, st)
            dec = torch.exp(lx[:, a][:, :, None] - lc[:, a][:, None])
            att = torch.einsum("bihj,bshj,bishj->bhis", rr[:, a], kk[:, a],
                               dec)
            att = torch.where(tri, att, 0.0) + torch.diag_embed(
                torch.einsum("bihj,hj,bihj->bhi", rr[:, a], u, kk[:, a]))
            y[:, a] += torch.einsum("bhis,bshc->bihc", att, vv[:, a])
            for c in range(a):
                mid = torch.exp(tot[:, c + 1:a].sum(1))[:, None]
                off = torch.einsum("bihj,bshj->bhis", rt[:, a],
                                   kh[:, c] * mid)
                y[:, a] += torch.einsum("bhis,bshc->bihc", off, vv[:, c])
            suf = torch.exp(tot[:, a + 1:].sum(1))[:, None]
            new = new + torch.einsum("bshj,bshc->bhjc", kh[:, a] * suf,
                                     vv[:, a])
        st = new
        ys.append(y.reshape(b, nsub * sub, h, d)[:, :n])
    return torch.cat(ys, 1), st


def _step_oracle64(r, k, v, w, u, s0):
    st = s0.clone()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               st + u[None, :, :, None] * kv))
        st = torch.exp(w[:, t])[..., None] * st + kv
    return torch.stack(ys, 1), st


@pytest.mark.parametrize("s,chunk,strong", [(100, 64, False),
                                            (97, 32, False), (13, 64, False),
                                            (150, 64, True), (70, 24, True)])
def test_subchunk_factorisation_matches_the_step_oracle(s, chunk, strong):
    rng = np.random.default_rng(s + chunk)
    b, h, d = 2, 2, 8
    r, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)))
               for _ in range(3))
    if strong:
        w = torch.from_numpy(-3.0 - 0.2 * rng.random((b, s, h, d)))
    else:
        w = torch.from_numpy(-np.exp(rng.standard_normal((b, s, h, d))
                                     * 0.5 - 1.0))
    u = torch.from_numpy(rng.standard_normal((h, d)) * 0.1)
    s0 = torch.from_numpy(rng.standard_normal((b, h, d, d)))
    y, st = _subchunk_scan(r, k, v, w, u, s0, chunk=chunk)
    want_y, want_s = _step_oracle64(r, k, v, w, u, s0)
    torch.testing.assert_close(y, want_y, atol=1e-9, rtol=1e-9)
    torch.testing.assert_close(st, want_s, atol=1e-9, rtol=1e-9)
    # fp32: finite, and within the fp32 oracle's reach
    f32 = [x.float() for x in (r, k, v, w, u, s0)]
    y32, s32 = _subchunk_scan(*f32, chunk=chunk)
    assert torch.isfinite(y32).all() and torch.isfinite(s32).all()
    oy, os_ = rwkv6_scan_ref(*f32)
    torch.testing.assert_close(y32, oy, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s32, os_, atol=1e-4, rtol=1e-4)
    if strong and chunk * 3.0 > 88:
        # the chunked plain version's split decay overflows here
        cy, _ = rwkv6_chunked_ref(*f32, chunk=chunk)
        assert not torch.isfinite(cy).all()
