"""Plain PyTorch version of flash attention (independent of
models.attention).

Port of ``repro/kernels/flash_attention/ref.py``: the kernel wrapper
(kernel.py) runs it for tensors on the CPU, and the tests and
``chip_smoke.py`` hold the CUDA kernel against it."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window: int = 0,
                  logit_cap: float = 0.0, scale=None):
    """q: (B,H,Sq,hd); k: (B,KV,Sk,hd); v: (B,KV,Sk,hd_v). Queries at
    positions Sk-Sq..Sk-1 (suffix alignment). Returns (B,H,Sq,hd_v) fp32."""
    b, h, sq, d = q.shape
    kv = k.shape[1]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, kv, g, sq, d)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * scale
    if logit_cap:
        logits = torch.tanh(logits / logit_cap) * logit_cap
    sk = k.shape[2]
    qpos = torch.arange(sq, device=q.device) + (sk - sq)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window and window > 0:
        mask = mask & (kpos[None, :] > (qpos[:, None] - window))
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return out.reshape(b, h, sq, v.shape[-1])
