"""Plain PyTorch versions of the RWKV-6 recurrence.

Port of ``repro/kernels/rwkv6_scan/ref.py`` (the step-by-step oracle), and
beside it the chunked schedule that the TPU kernel and the reference model
run (``repro/models/ssm.py`` ``_rwkv_chunk``, looped over chunks). The
kernel wrapper (kernel.py) runs ``rwkv6_chunked_ref`` for tensors on the
CPU; the tests and ``chip_smoke.py`` hold the CUDA kernel against both.
"""
from __future__ import annotations

import torch


def rwkv6_scan_ref(r, k, v, logw, u, s0):
    """r,k,v,logw: (B,S,H,hd); u: (H,hd); s0: (B,H,hd,hd).

    y_t = r_t @ (S_{t-1} + (u*k_t)^T v_t);  S_t = diag(w_t) S_{t-1} + k_t^T v_t
    Returns (y (B,S,H,hd) fp32, s_final (B,H,hd,hd) fp32).
    """
    w = torch.exp(logw.float())
    r, k, v, u = r.float(), k.float(), v.float(), u.float()
    s = s0.float().clone()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,H,hd,hd)
        att = s + u[None, :, :, None] * kv
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], att))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _chunk(r, k, v, logw, u, s_in):
    """One chunk (all fp32), the reference's ``_rwkv_chunk``: r,k,v,logw
    (B,C,H,hd), u (H,hd), s_in (B,H,hd,hd) -> (y (B,C,H,hd), s_out). The
    decay factors are the reference's ``exp(cum_excl) * exp(-cum)``
    product; ``exp(-cum)`` overflows fp32 once a chunk's summed log decay
    passes -88 (the CUDA kernel takes them pairwise and cannot)."""
    cum = torch.cumsum(logw, dim=1)                            # inclusive
    cum_excl = cum - logw                                      # exclusive
    r_dec = r * torch.exp(cum_excl)
    y = torch.einsum("bchk,bhkv->bchv", r_dec, s_in)
    att = torch.einsum("bchk,bshk->bhcs", r_dec, k * torch.exp(-cum))
    c_len = r.shape[1]
    tri = torch.tril(torch.ones((c_len, c_len), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    att = torch.where(tri[None, None], att, 0.0)
    y = y + torch.einsum("bhcs,bshv->bchv", att, v)
    y = y + torch.sum(r * (u[None, None] * k), dim=-1, keepdim=True) * v
    total = cum[:, -1][:, None]                                # (B,1,H,hd)
    k_dec = k * torch.exp(total - cum)
    s_out = torch.exp(total[:, 0])[..., None] * s_in + torch.einsum(
        "bshk,bshv->bhkv", k_dec, v)
    return y, s_out


def rwkv6_chunked_ref(r, k, v, logw, u, s0=None, chunk: int = 64):
    """The chunked schedule: chunks of ``chunk`` tokens, the last one
    ragged when ``chunk`` does not divide S. ``s0=None`` starts from
    zeros, as the TPU kernel does. Same arguments as ``rwkv6_scan_ref``;
    computes in fp32 and returns y in r's dtype (as the TPU kernel and the
    CUDA kernel store it) and the final state in fp32."""
    b, s, h, d = r.shape
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    y_dtype = r.dtype
    r, k, v, logw, u = (t.float() for t in (r, k, v, logw, u))
    st = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
          if s0 is None else s0.float())
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(c0 + chunk, s))
        y, st = _chunk(r[:, sl], k[:, sl], v[:, sl], logw[:, sl], u, st)
        ys.append(y)
    if not ys:
        return r.new_zeros((b, 0, h, d), dtype=y_dtype), st.clone()
    return torch.cat(ys, dim=1).to(y_dtype), st
