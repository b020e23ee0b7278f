"""``flash_attention_fwd``: wrapper of the hand-written CUDA kernel.

Port of ``repro/kernels/flash_attention/kernel.py``; the kernel lives in
``csrc/flash_attention.cu`` (the source note there gives its bound, tiles
and design), built at first use by ``kernels/_build.py``. The TPU version
takes block sizes and halves them until they divide the sequence; the CUDA
kernel has fixed tiles and masks a ragged last tile, so it takes none.

The wrapper checks dtype, shape and device, and that the head dimension is
contiguous: the kernel reads q, k, v and writes the output through
(batch, head, sequence) strides, so views of the model layout need no
copy; the kernel itself stages a tensor with 16-byte copies where its
base and strides allow and with 4-byte copies otherwise. It launches the
kernel for tensors on a CUDA device and calls the plain version (ref.py)
for tensors on the CPU; a CUDA tensor gets the kernel or an error.
``LAUNCHES`` and ``PLAIN_CALLS`` count the two, ``LAUNCHES_BY_DTYPE``
splits the launches by dtype (``float32``, ``bfloat16``, ``float16``) and
``LAUNCHES_BY_FORM`` by instantiation: ``f32_wgmma``, ``bf16_wgmma`` and
``f16_wgmma``, the warpgroup-product kernels at d = dv in {64, 128, 256}
with 16-byte aligned bases and strides (TMA's rule, in bytes) of
``csrc/flash_attention_wgmma_f32.cu`` (fp32, 3xTF32) and
``csrc/flash_attention_wgmma.cu`` (bf16; its fp16 library
``flash_attention_wgmma_f16.cu``); ``float32``, ``bf16_mma`` and
``f16_mma``, ``csrc/flash_attention.cu``'s mma.sync forms, for every other
shape (odd or unaligned head dims and rows, the wide 576 / 512 form).
``flash_form`` makes that choice from shapes alone (no read-back). The
fp32 wgmma form shares each 64-row tile's key tiles over ``flash_parts``
blocks when the call's tiles do not fill the card (scratch from
``flash_scratch``; the parts merge in a fixed order, so the output does
not depend on which block finishes last).
q, k and v are all fp32, all bf16 or all fp16, as the TPU kernel takes
any, and the output is in q's dtype; any other dtype or mix raises. fp32:
the kernel's products run on the tensor cores in 3xTF32, accurate to
fp32's level. bf16 and fp16: the kernel's 16-bit forms, one template over
the two types (products on the tensor cores in the inputs' type, softmax
and sums in fp32, the output rounded once: in fp16 only the output can
overflow); no input is cast to reach a form. The plain version computes
in fp32 and rounds its output to q's dtype. V has a width of its
own: MLA's prefill (K 576, V 512) runs on the kernel's wide
instantiation without padding V.

The entry is a custom op (``repro_torch::flash_attention``, ``_build.py
entry``) whose FLOP formula counts QK^T and PV over the causal (or
windowed) positions and whose bytes formula counts q, k, v read and the
output written once, the bound's work.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.kernels._build import (check_tensor, entry, kernel_info,
                                       library, raise_on, refuse_grad)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention.kernel import sm_count

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
PLAIN_CALLS: Dict[str, int] = {"flash_attention": 0}
LAUNCHES_BY_DTYPE: Dict[str, int] = {"float32": 0, "bfloat16": 0,
                                     "float16": 0}
LAUNCHES_BY_FORM: Dict[str, int] = {"float32": 0, "f32_wgmma": 0,
                                    "bf16_mma": 0, "bf16_wgmma": 0,
                                    "f16_mma": 0, "f16_wgmma": 0}
DTYPES = (torch.float32, torch.bfloat16, torch.float16)   # the forms
# a 16-bit dtype's form prefix, and its libraries' and C entries' tag
TAG16 = {torch.bfloat16: "bf16", torch.float16: "f16"}
# every dtype's wgmma form prefix and C entry tag
WGMMA_TAG = {torch.float32: "f32", **TAG16}
WGMMA_HEAD_DIMS = (64, 128, 256)    # the wgmma kernel's d = dv
ROWS = 64                           # the wgmma kernels' query rows a tile
MAX_PARTS = 4                       # blocks an fp32 wgmma tile's keys take
NARROW_HEAD_DIM = 256               # the narrow instantiation: dk, dv
MAX_HEAD_DIM = 576                  # the wide one: dk (MLA's latent + rope)
MAX_V_HEAD_DIM = 512                # and dv (MLA's latent)
INFO_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
             "blocks_per_sm", "threads", "rows_per_block")
WGMMA_INFO_KEYS = INFO_KEYS + ("stages",)
F32_WGMMA_INFO_KEYS = WGMMA_INFO_KEYS + ("keys_per_tile",)


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS, LAUNCHES_BY_DTYPE,
                   LAUNCHES_BY_FORM):
        for k in counts:
            counts[k] = 0


def flash_form(d: int, dv: int, dtype, strides=(), ptrs=()) -> str:
    """The instantiation a call launches (a ``LAUNCHES_BY_FORM`` key): the
    dtype's wgmma kernel where d = dv is 64, 128 or 256 and every base
    pointer in ``ptrs`` and element stride in ``strides`` (of the dims of
    size above 1) is 16-byte aligned in bytes (strides of 4 fp32 or 8
    16-bit values), else the mma.sync one ("float32" for fp32)."""
    size = 4 if dtype == torch.float32 else 2
    if (d == dv and d in WGMMA_HEAD_DIMS
            and all(s * size % 16 == 0 for s in strides)
            and all(p % 16 == 0 for p in ptrs)):
        return f"{WGMMA_TAG[dtype]}_wgmma"
    return "float32" if dtype == torch.float32 else f"{TAG16[dtype]}_mma"


def flash_parts(b: int, h: int, sq: int, sms: int) -> int:
    """Blocks the fp32 wgmma form splits each 64-row query tile's key tiles
    over (tiles p, p + n, ...; the tile's last block to finish merges the
    parts): 1 when the call's tiles fill the card's ``sms`` SMs, else
    enough for about one block an SM, at most MAX_PARTS. gemma2-2b's
    prefill (8 heads, 14 tiles at 854 tokens) takes 2."""
    n = b * h * -(-sq // ROWS)
    return 1 if n >= sms else min(MAX_PARTS, -(-sms // n))


def flash_info(d: int, dv: Optional[int] = None, dtype=torch.float32,
               form: Optional[str] = None) -> Dict[str, int]:
    """The CUDA kernel's registers, shared memory, resident blocks per SM
    and block shape at head dims ``d`` and ``dv`` (default ``d``), of the
    form of ``dtype`` (``form`` a ``LAUNCHES_BY_FORM`` key of the dtype,
    by default the wgmma form where d = dv takes it; fp32's adds its key
    tile); needs the card."""
    dv = d if dv is None else dv
    form = form or flash_form(d, dv, dtype)
    if form.endswith("_wgmma"):
        tag = WGMMA_TAG[dtype]
        return kernel_info(wgmma_library(dtype),
                           f"flash_attention_{tag}_wgmma_info", (d,),
                           F32_WGMMA_INFO_KEYS if tag == "f32"
                           else WGMMA_INFO_KEYS)
    fn = ("flash_attention_info" if dtype == torch.float32
          else f"flash_attention_{TAG16[dtype]}_info")
    return kernel_info("flash_attention", fn, (d, dv), INFO_KEYS)


def wgmma_library(dtype) -> str:
    """The library of ``dtype``'s wgmma form."""
    return {torch.float32: "flash_attention_wgmma_f32",
            torch.bfloat16: "flash_attention_wgmma",
            torch.float16: "flash_attention_wgmma_f16"}[dtype]


def check_head_dims(d: int, dv: int) -> None:
    """Raise unless an instantiation takes (d, dv): the narrow one d = dv
    up to 256, the wide one any other d up to 576 with dv up to 512."""
    if (d != dv or d > NARROW_HEAD_DIM) and (d > MAX_HEAD_DIM
                                             or dv > MAX_V_HEAD_DIM):
        raise ValueError(f"head dims ({d}, {dv}) past the kernel's limits "
                         f"({MAX_HEAD_DIM}, {MAX_V_HEAD_DIM})")


def flash_attention_fwd(q, k, v, *, causal=True, window=0, logit_cap=0.0,
                        scale=None):
    """q: (B,H,Sq,hd); k: (B,KV,Sk,hd); v: (B,KV,Sk,hd_v) -> (B,H,Sq,hd_v)
    in q's dtype (fp32, bf16 or fp16; k and v the same). Any strides with the
    last dimension contiguous; on the card the output is laid out as
    (B,Sq,H,hd_v) in memory (the model layout) and returned as its
    (B,H,Sq,hd_v) view. The default scale is 1/sqrt(hd)."""
    refuse_grad("flash_attention", q, k, v)
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    dev = q.device
    if q.dtype not in DTYPES:
        raise TypeError(f"q: expected torch.float32, torch.bfloat16 or "
                        f"torch.float16, got {q.dtype}")
    for name, t, shape in (("q", q, (b, h, sq, d)), ("k", k, (b, kv, sk, d)),
                           ("v", v, (b, kv, sk, dv))):
        check_tensor(name, t, q.dtype, shape, dev, contiguous=False)
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
    if kv <= 0 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    if dev.type == "cuda":
        check_head_dims(d, dv)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    return entry(torch.ops.repro_torch.flash_attention.default, _flash,
                 q, k, v, bool(causal), int(window or 0),
                 float(logit_cap or 0.0), scale)


def _flash(q, k, v, causal: bool, window: int, logit_cap: float,
           scale: float):
    """The launch (the CPU's plain version)."""
    dev = q.device
    if dev.type == "cpu":
        PLAIN_CALLS["flash_attention"] += 1
        out = attention_ref(q, k, v, causal=causal, window=window,
                            logit_cap=logit_cap, scale=scale).to(q.dtype)
        # the kernel's layout (the op's fake), which DTensor's metadata takes
        return out.transpose(1, 2).contiguous().transpose(1, 2)
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    out = torch.empty((b, sq, h, dv), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    form = flash_form(d, dv, q.dtype, _outer_strides(q, k, v),
                      (q.data_ptr(), k.data_ptr(), v.data_ptr()))
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            kv, sq, sk)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:3])
    tail = (int(bool(causal)), int(window or 0), float(scale),
            float(logit_cap or 0.0))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if form == "f32_wgmma":
            parts = flash_parts(b, h, sq, sm_count(dev))
            part, count = flash_scratch(b, h, sq, d, parts, dev)
            err = library(wgmma_library(q.dtype)).flash_attention_f32_wgmma(
                *head, d, *strides, *tail, data_ptr(part), data_ptr(count),
                parts, stream)
        elif form.endswith("_wgmma"):
            err = getattr(library(wgmma_library(q.dtype)),
                          f"flash_attention_{TAG16[q.dtype]}_wgmma")(
                *head, d, *strides, *tail, stream)
        else:
            fn = ("flash_attention" if form == "float32"
                  else f"flash_attention_{TAG16[q.dtype]}")
            err = getattr(library("flash_attention"), fn)(
                *head, d, dv, *strides, *tail, stream)
    raise_on(err, form)
    LAUNCHES["flash_attention"] += 1
    LAUNCHES_BY_DTYPE[str(q.dtype).split(".")[1]] += 1
    LAUNCHES_BY_FORM[form] += 1
    return out


def flash_scratch(b, h, sq, d, parts, dev):
    """The fp32 wgmma form's scratch for ``parts`` > 1: each part's
    unnormalised (o, m, l) of every 64-row tile, and the tiles' counters of
    finished parts, zero (the kernel leaves them zero); (None, None) for
    one part."""
    if parts == 1:
        return None, None
    n_qt = -(-sq // ROWS)
    return (torch.empty(b * h * n_qt * parts * ROWS * (d + 2), device=dev),
            torch.zeros(b * h * n_qt, dtype=torch.int32, device=dev))


def data_ptr(t):
    """A tensor's address for a C entry, None for no tensor."""
    return None if t is None else t.data_ptr()


def _outer_strides(*ts):
    """The (batch, head, sequence) strides of the dims of size above 1."""
    return [st for t in ts for n, st in zip(t.shape[:3], t.stride()[:3])
            if n > 1]


# ---------------------------------------------------------------------------
# the entry as a custom op: fake implementation, FLOP and bytes formulas
# ---------------------------------------------------------------------------
Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
              logit_cap: float, scale: float) -> Tensor:
    return _flash(q, k, v, causal, window, logit_cap, scale)


@_flash_op.register_fake
def _(q, k, v, causal, window, logit_cap, scale):
    b, h, sq, _d = q.shape
    return q.new_empty((b, sq, h, v.shape[-1])).transpose(1, 2)


def visible_pairs(sq: int, sk: int, causal: bool = True,
                  window: int = 0) -> int:
    """(query, key) pairs a query block attends to: queries at positions
    sk-sq..sk-1 (suffix alignment), keys at or before each (with
    ``causal``) and inside the window (with one)."""
    if not causal:
        return sum(sk - max(0, sk - sq + i - window + 1)
                   if window and window > 0 else sk for i in range(sq))

    def upto(n: int) -> int:          # sum of min(m, window) for m = 1..n
        if not window or window <= 0 or n <= window:
            return n * (n + 1) // 2
        return window * (window + 1) // 2 + (n - window) * window
    return upto(sk) - upto(sk - sq)


def flash_work(q, k, v, causal=True, window=0):
    """(flops, bytes) of one call: QK^T (d wide) and PV (dv wide) over the
    visible pairs of every head, 2 flops a multiply-add; q, k and v read
    and the output written once (``chip_smoke.py``'s bound)."""
    b, h, sq, d = q.shape
    sk, dv = k.shape[2], v.shape[-1]
    pairs = visible_pairs(sq, sk, causal, window)
    flops = 2 * (d + dv) * h * b * pairs
    n_bytes = (q.numel() + k.numel() + v.numel() + b * h * sq * dv) \
        * q.element_size()
    return flops, n_bytes


def _register_formulas():
    from torch.utils.flop_counter import register_flop_formula
    from repro_torch.utils.op_stats import register_bytes_formula
    packet = torch.ops.repro_torch.flash_attention

    @register_flop_formula(packet, get_raw=True)
    def _flops(q, k, v, causal, window, *_a, out_val=None, **_k):
        return flash_work(q, k, v, causal, window)[0]

    @register_bytes_formula(packet)
    def _bytes(q, k, v, causal, window, *_a, out_val=None, **_k):
        return flash_work(q, k, v, causal, window)[1]


_register_formulas()
