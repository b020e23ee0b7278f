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
``LAUNCHES`` and ``PLAIN_CALLS`` count the two. fp32 in and out: the
kernel's products run on the tensor cores in 3xTF32, accurate to fp32's
level. V has a width of its own: MLA's prefill (K 576, V 512) runs on
the kernel's wide instantiation without padding V.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.kernels._build import (check_tensor, kernel_info, library,
                                       raise_on, refuse_grad)
from repro_torch.kernels.flash_attention.ref import attention_ref

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
PLAIN_CALLS: Dict[str, int] = {"flash_attention": 0}
NARROW_HEAD_DIM = 256               # the narrow instantiation: dk, dv
MAX_HEAD_DIM = 576                  # the wide one: dk (MLA's latent + rope)
MAX_V_HEAD_DIM = 512                # and dv (MLA's latent)
INFO_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
             "blocks_per_sm", "threads", "rows_per_block")


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


def flash_info(d: int, dv: Optional[int] = None) -> Dict[str, int]:
    """The CUDA kernel's registers, shared memory, resident blocks per SM
    and block shape at head dims ``d`` and ``dv`` (default ``d``; needs
    the card)."""
    return kernel_info("flash_attention", "flash_attention_info",
                       (d, d if dv is None else dv), INFO_KEYS)


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
    fp32. Any strides with the last dimension contiguous; on the card the
    output is laid out as (B,Sq,H,hd_v) in memory (the model layout) and
    returned as its (B,H,Sq,hd_v) view. The default scale is
    1/sqrt(hd)."""
    refuse_grad("flash_attention", q, k, v)
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    dev = q.device
    for name, t, shape in (("q", q, (b, h, sq, d)), ("k", k, (b, kv, sk, d)),
                           ("v", v, (b, kv, sk, dv))):
        check_tensor(name, t, torch.float32, shape, dev, contiguous=False)
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
    if kv <= 0 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if dev.type == "cpu":
        PLAIN_CALLS["flash_attention"] += 1
        return attention_ref(q, k, v, causal=causal, window=window,
                             logit_cap=logit_cap, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    check_head_dims(d, dv)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, sq, h, dv), dtype=torch.float32,
                      device=dev).transpose(1, 2)
    lib = library("flash_attention")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            kv, sq, sk, d, dv, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], int(bool(causal)),
            int(window or 0), float(scale), float(logit_cap or 0.0), stream)
    raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
