"""Flash attention's fp32 wgmma form (``csrc/flash_attention_wgmma_f32.cu``,
``flash_form`` "f32_wgmma") emulated on the CPU (no card).

The kernel's arithmetic in torch: 64-row query tiles, key tiles of
4096 / d keys (a 16 KiB fp32 tile) shared by ``flash_parts`` blocks in turn
(the tile's last part merges them in order); in a block, at d 64, dealt
alternately to two consumer warpgroups whose states merge at the end, at d
128 and 256 split between them by halves of d (S summed from the halves);
the online softmax in log2 units, and every product in 3xTF32 with the
split the kernel takes: the raw fp32 value is its own hi part (the tensor
core reads an fp32 word as TF32 by dropping its low 13 bits) and lo = x -
trunc_tf32(x), itself read truncated. P.V is taken as the kernel takes it
(route (a) of the source
note): V transposed into V^T with each 8-key step's keys in the order
0 2 4 6 1 3 5 7, and P's A fragment read from the S accumulator in that
order. Held against the plain version (``attention_ref``) within atol =
rtol = 1e-4 at the cases the bf16 schedule's test uses, in fp32, plus
musicgen-large's G = 1; dropping one of P.V's lo products misses it.
Inputs come from seeded numpy generators.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    MAX_PARTS, flash_form, flash_parts)

F32 = torch.float32
TOL = dict(atol=1e-4, rtol=1e-4)
LOG2E = 1.4426950408889634
NEG_INF = -1e30
ROWS = 64                 # query rows a consumer warpgroup (kBM)
TILE_BYTES = 16384        # a K, K_lo, V^T or landing tile
# an 8-key step's slot c holds key PERM8[c]: the S accumulator's keys 2t,
# 2t + 1 are P's A-fragment columns t, t + 4
PERM8 = (0, 2, 4, 6, 1, 3, 5, 7)


def keys_per_tile(d: int) -> int:
    return TILE_BYTES // (4 * d)


def trunc(x):
    """The TF32 bits the tensor core reads of an fp32 value."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(F32)


def x3(a, b, lo_terms=("a", "b")):
    """a @ b in 3xTF32 as the kernel takes it: a_lo.b_hi + a_hi.b_lo +
    a_hi.b_hi, hi the raw value read truncated, lo = x - trunc(x) read
    truncated; ``lo_terms`` drops a_lo's or b_lo's product when missing."""
    ah, bh = trunc(a), trunc(b)
    out = ah @ bh
    if "a" in lo_terms:
        out = out + trunc(a - ah) @ bh
    if "b" in lo_terms:
        out = out + ah @ trunc(b - bh)
    return out


def _consumer(q, k, v, q0, tiles, t_first, bn, off, causal, window, cap,
              scale, pv_lo, halves):
    """One consumer warpgroup, or the two of the D-split together
    (``halves``: S summed from two halves of d, each in 3xTF32): rows q0..
    of every (batch, head) (q, k, v batched as (BH, S, d)) over the key
    tiles ``tiles``; returns (o, m, l) unnormalised."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    qt = torch.zeros((bh, ROWS, d))
    n = max(0, min(sq, q0 + ROWS) - q0)
    qt[:, :n] = q[:, q0:q0 + n]
    pos = torch.arange(q0, q0 + ROWS) + off
    o = torch.zeros((bh, ROWS, v.shape[-1]))
    m = torch.full((bh, ROWS), NEG_INF)
    l = torch.zeros((bh, ROWS))
    perm = torch.tensor([8 * (c // 8) + PERM8[c % 8] for c in range(bn)])
    cuts = [(0, d // 2), (d // 2, d)] if halves else [(0, d)]
    for it in tiles:
        k0 = (t_first + it) * bn
        kpos = torch.arange(k0, k0 + bn)
        kt = torch.zeros((bh, bn, d))
        vt = torch.zeros((bh, bn, v.shape[-1]))
        nk = max(0, min(sk, k0 + bn) - k0)      # TMA's zero fill past sk
        kt[:, :nk], vt[:, :nk] = k[:, k0:k0 + nk], v[:, k0:k0 + nk]
        parts = [x3(qt[..., a:e], kt[..., a:e].transpose(1, 2))
                 for a, e in cuts]
        s = parts[0] + parts[1] if halves else parts[0]
        x = (cap * LOG2E * torch.tanh(s * scale / cap) if cap
             else s * scale * LOG2E)
        ok = kpos[None, :] < sk
        if causal:
            ok = ok & (kpos[None, :] <= pos[:, None])
        if window:
            ok = ok & (kpos[None, :] > pos[:, None] - window)
        x = torch.where(ok, x, -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * corr + p.sum(-1)
        # V^T in the slot order, P's A fragments in the same order
        v_t = vt[:, perm].transpose(1, 2)
        o = o * corr[..., None] + x3(p[..., perm], v_t.transpose(1, 2),
                                     ("a", "b") if pv_lo else ("a",))
        m = m_new
    return o, m, l


def _merge(a, b):
    """Two (o, m, l) states of the same rows as one (the kernel's merges:
    its two dealt consumers, and a q-tile's parts)."""
    (o0, m0, l0), (o1, m1, l1) = a, b
    mm = torch.maximum(m0, m1)
    ca, cb = torch.exp2(m0 - mm), torch.exp2(m1 - mm)
    return o0 * ca[..., None] + o1 * cb[..., None], mm, l0 * ca + l1 * cb


def flash_f32_wgmma_emulated(q, k, v, *, window=0, logit_cap=0.0,
                             scale=None, causal=True, pv_lo=True, sms=132):
    """The fp32 wgmma kernel's function: (B, H, Sq, d) q, (B, KV, Sk, d) k
    and v -> (B, H, Sq, d). Each 64-row tile's key tiles go to
    ``flash_parts`` blocks (on a card of ``sms`` SMs) in turn; in a block,
    at d 64 the two consumers take its tiles alternately and merge, at d
    128 and 256 they split d (the D-split); the tile's last part merges
    all parts' states in part order."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    bn = keys_per_tile(d)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    g = h // kv
    qf = q.reshape(b * h, sq, d)
    kf = k.repeat_interleave(g, dim=1).reshape(b * h, sk, d)
    vf = v.repeat_interleave(g, dim=1).reshape(b * h, sk, v.shape[-1])
    out = torch.zeros((b * h, sq, v.shape[-1]))
    off = sk - sq
    n_parts = flash_parts(b, h, sq, sms)
    deal = d == 64
    for q0 in range(0, sq, ROWS):
        q_last = min(q0 + ROWS, sq) - 1
        k_end = min(sk, q_last + off + 1) if causal else sk
        t_first = (max(0, q0 + off - window + 1) if window else 0) // bn
        n_all = max(0, -(-(k_end - t_first * bn) // bn))
        args = (qf, kf, vf, q0)
        rest = (t_first, bn, off, causal, window, logit_cap, scale, pv_lo)
        states = []
        for p in range(n_parts):
            mine = list(range(p, n_all, n_parts))
            if deal:
                states.append(_merge(*(
                    _consumer(*args, mine[first::2], *rest, False)
                    for first in (0, 1))))
            else:
                states.append(_consumer(*args, mine, *rest, True))
        o, _m, l = states[0]
        for other in states[1:]:
            o, _m, l = _merge((o, _m, l), other)
        n = max(0, min(sq, q0 + ROWS) - q0)
        out[:, q0:q0 + n] = (o / torch.clamp(l, min=1e-30)[..., None])[:, :n]
    return out.reshape(b, h, sq, v.shape[-1])


def _inputs(seed, b, h, kv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d))]


def test_flash_parts():
    """Blocks a 64-row tile's key tiles take: one when the call's tiles fill
    the card, else about one block an SM, at most MAX_PARTS."""
    assert flash_parts(1, 8, 854, 132) == 2        # gemma2-2b's prefill
    assert flash_parts(1, 8, 550, 132) == 2
    assert flash_parts(1, 32, 923, 132) == 1       # musicgen-large's
    assert flash_parts(1, 25, 1369, 132) == 1      # hymba-1.5b's
    assert flash_parts(1, 2, 40, 132) == MAX_PARTS
    assert flash_parts(4, 8, 854, 132) == 1


def test_key_tiles_and_slot_order():
    """16 KiB tiles: 64, 32 and 16 keys at d 64, 128 and 256; the slot
    order makes the S accumulator's pair (2t, 2t + 1) P's columns (t,
    t + 4)."""
    assert [keys_per_tile(d) for d in (64, 128, 256)] == [64, 32, 16]
    assert [PERM8[t] for t in range(4)] == [2 * t for t in range(4)]
    assert [PERM8[t + 4] for t in range(4)] == [2 * t + 1 for t in range(4)]
    assert sorted(PERM8) == list(range(8))


@pytest.mark.parametrize("b,h,kv,sq,sk,d,window,cap", [
    (1, 4, 2, 150, 150, 64, 0, 50.0),      # ragged last tiles, the cap
    (1, 2, 1, 200, 200, 128, 70, 0.0),     # a window crossing key tiles
    (1, 2, 1, 40, 300, 64, 0, 30.0),       # Sk >> Sq
    (1, 2, 1, 130, 130, 256, 0, 50.0),     # gemma2's head dim and cap
    (2, 2, 2, 60, 60, 64, 0, 0.0),         # one key tile: one warpgroup
    (1, 2, 1, 1, 1, 64, 0, 0.0),           # a single query
    (1, 4, 4, 200, 200, 64, 0, 0.0),       # musicgen-large's G = 1
    (1, 8, 4, 300, 300, 256, 0, 50.0)])    # 40 tiles, 4 parts: gemma2's
def test_flash_f32_wgmma_schedule_matches_plain(b, h, kv, sq, sk, d, window,
                                                cap):
    """Every case runs in parts (fewer 64-row tiles than SMs), dealt at d
    64, D-split at d 128 and 256."""
    q, k, v = _inputs(sq + d + window, b, h, kv, sq, sk, d)
    assert flash_form(d, d, F32, (h * sq * d, sq * d, d), (0,)) == \
        "f32_wgmma"
    got = flash_f32_wgmma_emulated(q, k, v, window=window, logit_cap=cap)
    want = attention_ref(q, k, v, window=window, logit_cap=cap)
    torch.testing.assert_close(got, want, **TOL)


def test_flash_f32_wgmma_needs_v_lo():
    """P.V without its P_hi.V_lo product (V read as TF32 alone) misses the
    tolerance at gemma2's head dim: the kernel keeps all three."""
    q, k, v = _inputs(7, 1, 2, 1, 130, 130, 256)
    got = flash_f32_wgmma_emulated(q, k, v, logit_cap=50.0, pv_lo=False)
    want = attention_ref(q, k, v, logit_cap=50.0)
    assert not torch.allclose(got, want, **TOL)
