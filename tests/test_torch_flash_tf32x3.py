"""The numerical claim behind the flash-attention kernel's tensor cores.

``kernels/flash_attention/csrc/flash_attention.cu`` computes both of its
products, S = Q.K^T and O = P.V, with TF32 tensor-core instructions in the
split ("3xTF32") form: each fp32 operand x becomes hi = tf32(x), rounded
to nearest (ties away from zero, keeping 10 mantissa bits, as
``cvt.rna.tf32.f32`` does), and lo = x - hi, of which the tensor core reads
only the TF32 bits (it truncates the 13 below); a.b is taken as
a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in fp32. Here, in plain torch on the
CPU, that is emulated (a product of two TF32 values is exact in fp32) and
attention at the serving prefill's width (gemma2-2b: hd 256,
8 heads, 4 KV heads, 550 tokens) is held against the port's
``attention_ref`` within the port's fp32 tolerance, atol = rtol = 1e-4.
A single TF32 product per multiply misses that tolerance: that is why the
kernel splits. Inputs come from a seeded numpy generator.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
SERVE = dict(b=1, h=8, kv=4, s=550, d=256)    # the serving prefill's width


def tf32(x):
    """Round fp32 to TF32 (10 mantissa bits), to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x):
    """The TF32 bits of fp32 values, as the tensor core reads a register."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def product(a, b, mode):
    """a @ b in fp32 with the kernel's TF32 scheme: ``tf32x3`` (the split,
    small terms first) or ``tf32`` (one product of rounded operands)."""
    ah, bh = tf32(a), tf32(b)
    if mode == "tf32":
        return ah @ bh
    al, bl = tf32_truncated(a - ah), tf32_truncated(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def attention_emulated(q, k, v, *, window, logit_cap, mode):
    """attention_ref's function with both products taken by ``product``."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, sq, d)
    s = product(qg, k.transpose(-1, -2).unsqueeze(2), mode) / math.sqrt(d)
    if logit_cap:
        s = torch.tanh(s / logit_cap) * logit_cap
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    kpos = torch.arange(sk)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return product(p, v.unsqueeze(2), mode).reshape(b, h, sq, d)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    b, h, kv, s, d = (SERVE[x] for x in ("b", "h", "kv", "s", "d"))
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10                             # TF32's step at 1.0
    x = torch.tensor([1.0 + ulp / 2 - 2.0 ** -20, 1.0 + ulp / 2,
                      -(1.0 + ulp / 2), 1.0 + 3 * ulp / 4, 3.0e-3])
    got = tf32(x)
    assert got[0] == one                          # below half: down
    assert got[1] == 1.0 + ulp                    # a tie: away from zero
    assert got[2] == -(1.0 + ulp)
    assert got[3] == 1.0 + ulp
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert abs(float(got[4]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11


@pytest.mark.parametrize("window,cap", [(4096, 50.0), (0, 0.0)])
def test_split_tf32_holds_the_fp32_tolerance(window, cap):
    """3xTF32 at the serving width against the fp32 reference: within the
    kernel's atol = rtol = 1e-4 (the emulated error is about 2e-6, near
    fp32's own against an fp64 oracle, 1.5e-6)."""
    q, k, v = _inputs(window + 1)
    want = attention_ref(q, k, v, window=window, logit_cap=cap)
    got = attention_emulated(q, k, v, window=window, logit_cap=cap,
                             mode="tf32x3")
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("window,cap", [(4096, 50.0), (0, 0.0)])
def test_single_tf32_misses_the_fp32_tolerance(window, cap):
    """One TF32 product per multiply (10-bit operands) at the same width
    misses atol = rtol = 1e-4: the reason the kernel splits its operands."""
    q, k, v = _inputs(window + 1)
    want = attention_ref(q, k, v, window=window, logit_cap=cap)
    got = attention_emulated(q, k, v, window=window, logit_cap=cap,
                             mode="tf32")
    miss = (got - want).abs() > TOL["atol"] + TOL["rtol"] * want.abs()
    assert bool(miss.any())
    assert float((got - want).abs().max()) > 5e-4
