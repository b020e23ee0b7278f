"""``rwkv6_scan_fwd``: wrapper of the hand-written CUDA kernel.

Port of ``repro/kernels/rwkv6_scan/kernel.py``; the kernel lives in
``csrc/rwkv6_scan.cu`` (the source note there gives its bound, schedule
and decay form), built at first use by ``kernels/_build.py``. The TPU
version halves its chunk until it divides the sequence and always starts
from a zero state; the CUDA kernel takes a ragged last chunk and an
optional starting state ``s0``.

The wrapper checks dtype, shape and device, and that the head dimension is
contiguous: the kernel reads r, k, v and logw through (batch, sequence,
head) strides, so the model layout needs no copy. It launches the kernel
for tensors on a CUDA device and calls the plain chunked version (ref.py)
for tensors on the CPU; a CUDA tensor gets the kernel or an error.
``LAUNCHES`` and ``PLAIN_CALLS`` count the two, ``LAUNCHES_BY_DTYPE`` the
launches by the inputs' dtype.

Dtypes, as the TPU kernel takes them: r, k, v and logw share one dtype,
fp32, bf16 or fp16 (a mix raises); u is fp32, bf16 or fp16, but not the
other 16-bit type than r's; s0 and the final state are fp32; y is in r's
dtype. The kernel loads 16-bit inputs into fp32 and computes in fp32 as
the fp32 form does, rounding y once on its store (one template over bf16
and fp16).

The C entry picks its schedule and grid from shapes and the SM count
alone; ``rwkv6_schedule`` and ``rwkv6_n_col`` are the same rules as plain
functions (``rwkv6_info`` reports what the kernel picked, on the card).

The entry is a custom op (``repro_torch::rwkv6_scan``, ``_build.py
entry``) whose FLOP and bytes formulas are the chunked form's work
(``rwkv6_work``, ``chip_smoke.py``'s bound).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels._build import (check_tensor, entry, kernel_info,
                                        library, raise_on, refuse_grad)
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_chunked_ref

LAUNCHES: Dict[str, int] = {"rwkv6_scan": 0}
LAUNCHES_BY_DTYPE: Dict[str, int] = {"float32": 0, "bfloat16": 0,
                                     "float16": 0}
PLAIN_CALLS: Dict[str, int] = {"rwkv6_scan": 0}
DTYPES = (torch.float32, torch.bfloat16, torch.float16)   # r, k, v, logw, u
# the C entry's type codes (csrc kF32, kBF16, kF16)
TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 64                   # the kernel's shared-memory tiles
MAX_CHUNK = 64
DECODE_MAX = 8                      # seq <= this: the decode schedule
BLOCKS_PER_SM = 2                   # the prefill grid's target (csrc)
INFO_KEYS = ("schedule", "n_col", "grid_blocks", "threads", "registers",
             "static_smem", "dynamic_smem", "blocks_per_sm")


def padded_dim(d: int) -> int:
    """The head dim as the prefill kernel pads it: 16, 32 or 64."""
    return 16 if d <= 16 else 32 if d <= 32 else 64


def rwkv6_schedule(seq: int) -> str:
    """The kernel's schedule for a call of ``seq`` tokens."""
    return "decode" if seq <= DECODE_MAX else "prefill"


def rwkv6_n_col(b: int, h: int, d: int, sms: int) -> int:
    """Column blocks of the prefill grid (H, B, n_col): doubled while each
    block's slice of the state stays a multiple of 8 columns of the head
    dim padded to 16, 32 or 64, and the grid within ``BLOCKS_PER_SM``
    blocks an SM."""
    dp = padded_dim(d)
    n = 1
    while n < 8 and (dp // (2 * n)) % 8 == 0 and \
            b * h * 2 * n <= BLOCKS_PER_SM * sms:
        n *= 2
    return n


def rwkv6_info(b: int, s: int, h: int, d: int, chunk: int = 64,
               dtype=torch.float32) -> Dict[str, int]:
    """What the kernel launches for these shapes on the current card (the
    form of the inputs' ``dtype``): schedule (0 decode, 1 prefill), column
    blocks, grid, registers, shared memory and resident blocks per SM
    (needs the card)."""
    return kernel_info("rwkv6_scan", "rwkv6_scan_info",
                       (b, s, h, d, chunk, TYPE_CODE[dtype]), INFO_KEYS)


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS, LAUNCHES_BY_DTYPE):
        for k in counts:
            counts[k] = 0


def rwkv6_scan_fwd(r, k, v, logw, u, *, chunk: int = 64, s0=None):
    """r,k,v,logw: (B,S,H,hd) of one dtype, fp32, bf16 or fp16, any
    strides with hd contiguous; u: (H,hd) fp32 or a 16-bit dtype (not the
    other one than r's); s0: (B,H,hd,hd) fp32 or
    None (zeros). Returns (y (B,S,H,hd) in r's dtype, s_final (B,H,hd,hd)
    fp32), both contiguous."""
    refuse_grad("rwkv6_scan", r, k, v, logw, u, s0)
    b, s, h, d = r.shape
    dev = r.device
    if r.dtype not in DTYPES:
        raise TypeError(f"r: expected torch.float32, torch.bfloat16 or "
                        f"torch.float16, got {r.dtype}")
    mixed = [f"{n} is {t.dtype}" for n, t in (("k", k), ("v", v),
                                              ("logw", logw))
             if t.dtype != r.dtype]
    if mixed:
        raise TypeError(f"rwkv6_scan: r, k, v and logw must share one dtype; "
                        f"r is {r.dtype}, {', '.join(mixed)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        check_tensor(name, t, r.dtype, (b, s, h, d), dev, contiguous=False)
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
    if u.dtype not in DTYPES or (r.dtype != torch.float32
                                 and u.dtype not in (torch.float32, r.dtype)):
        raise TypeError(f"u: expected torch.float32 or r's {r.dtype}, got "
                        f"{u.dtype}")
    check_tensor("u", u, u.dtype, (h, d), dev)
    if s0 is not None:
        check_tensor("s0", s0, torch.float32, (b, h, d, d), dev)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"rwkv6_scan: no kernel for device {dev}")
    if dev.type == "cuda":
        if d > MAX_HEAD_DIM:
            raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}, the kernel's "
                             "limit")
        if chunk > MAX_CHUNK:
            raise ValueError(f"chunk {chunk} > {MAX_CHUNK}, the kernel's "
                             "limit")
    y, s_out = entry(torch.ops.repro_torch.rwkv6_scan.default, _scan,
                     r, k, v, logw, u, s0, int(chunk))
    return y, s_out


def _scan(r, k, v, logw, u, s0, chunk: int):
    """The launch (the CPU's plain chunked version)."""
    b, s, h, d = r.shape
    dev = r.device
    if dev.type == "cpu":
        PLAIN_CALLS["rwkv6_scan"] += 1
        return rwkv6_chunked_ref(r, k, v, logw, u, s0, chunk=chunk)
    y = torch.empty((b, s, h, d), dtype=r.dtype, device=dev)
    s_out = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    lib = library("rwkv6_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rwkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            y.data_ptr(), s_out.data_ptr(), b, s, h, d, chunk,
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *logw.stride()[:3], *y.stride()[:3],
            TYPE_CODE[r.dtype], TYPE_CODE[u.dtype], stream)
    raise_on(err, "rwkv6_scan")
    LAUNCHES["rwkv6_scan"] += 1
    LAUNCHES_BY_DTYPE[str(r.dtype).split(".")[1]] += 1
    return y, s_out


# ---------------------------------------------------------------------------
# the entry as a custom op: fake implementation, FLOP and bytes formulas
# ---------------------------------------------------------------------------
Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::rwkv6_scan", mutates_args=())
def _scan_op(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
             s0: Optional[Tensor], chunk: int) -> Tuple[Tensor, Tensor]:
    return _scan(r, k, v, logw, u, s0, chunk)


@_scan_op.register_fake
def _(r, k, v, logw, u, s0, chunk):
    b, s, h, d = r.shape
    return (r.new_empty((b, s, h, d)),
            r.new_empty((b, h, d, d), dtype=torch.float32))


def rwkv6_work(b: int, s: int, h: int, d: int, chunk: int,
               with_state: bool, itemsize: int = 4):
    """(flops, bytes) the chunked form needs for one call: per (b, h) and
    chunk of L tokens, L hd^2 multiply-adds for the inter-chunk read and as
    many for the state update, hd L (L - 1) / 2 for the intra-chunk
    matrix, hd L (L + 1) / 2 for its product with v and hd L for the bonus
    (2 flops each; exps not counted). Bytes: r, k, v, logw and y and u at
    ``itemsize`` (the inputs' dtype), the fp32 state written and, when
    carried in, read."""
    sq = 0
    for c0 in range(0, s, chunk):
        n = min(chunk, s - c0)
        sq += n * n
    macs = b * h * (2 * s * d * d + d * sq + d * s)
    n_bytes = (itemsize * (5 * b * s * h * d + h * d)
               + 4 * (2 if with_state else 1) * b * h * d * d)
    return 2 * macs, n_bytes


def _work(r, k, v, logw, u, s0, chunk, *_a, **_k):
    b, s, h, d = r.shape
    return rwkv6_work(b, s, h, d, chunk, s0 is not None, r.element_size())


def _register_formulas():
    from torch.utils.flop_counter import register_flop_formula
    from repro_torch.utils.op_stats import register_bytes_formula
    packet = torch.ops.repro_torch.rwkv6_scan
    register_flop_formula(packet, get_raw=True)(
        lambda *a, out_val=None, **k: _work(*a, **k)[0])
    register_bytes_formula(packet)(
        lambda *a, out_val=None, **k: _work(*a, **k)[1])


_register_formulas()
