"""Plain PyTorch version of paged decode attention (the DBS read through a
block table).

Port of ``repro/kernels/paged_attention/ref.py``. Hole semantics match the
DBS data plane (``dbs_rw_read`` / the fused read gather): a block-table
entry of -1 is an unallocated page — the gather clamps the index so nothing
reads out of bounds, and every position on a hole page is masked out of
the softmax. The kernel wrapper (kernel.py) runs it for tensors on the
CPU, the ``torch``/``ref`` serving kernels run it on any device, and the
tests and ``chip_smoke.py`` hold the CUDA kernel against it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_ref(q, pool_k, pool_v, block_table, lengths, *,
                        window: int = 0, logit_cap: float = 0.0, scale=None,
                        return_lse: bool = False):
    """q: (B,H,hd); pools: (E,page,KV,hd) extent ids; block_table: (B,P)
    (holes -1); lengths: (B,) tokens in cache (the query attends to
    positions < lengths, i.e. the query position is lengths-1 having just
    been written). Returns (B,H,hd) fp32; with ``return_lse`` also (B,H)
    log-sum-exp of the live logits (NEG_INF on a row with none)."""
    b, h, d = q.shape
    _e, page, kv, _ = pool_k.shape
    p_max = block_table.shape[1]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    tbl = block_table.clamp(min=0).long()            # clamped gather
    k = pool_k[tbl].reshape(b, p_max * page, kv, -1)
    v = pool_v[tbl].reshape(b, p_max * page, kv, -1)
    pos = torch.arange(p_max * page, device=q.device)
    lengths = lengths.to(q.device)
    valid = pos[None, :] < lengths[:, None]          # (B,S)
    # hole pages contribute nothing, whatever extent row the clamp gathered
    valid = valid & (block_table >= 0).repeat_interleave(page, dim=1)
    if window and window > 0:
        valid = valid & (pos[None, :] > (lengths[:, None] - 1 - window))

    qf = q.float().reshape(b, kv, g, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) * scale
    if logit_cap:
        logits = torch.tanh(logits / logit_cap) * logit_cap
    vmask = valid[:, None, None]
    logits = torch.where(vmask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(vmask, w, 0.0)                    # all-hole lanes -> 0
    out = torch.einsum("bkgs,bskd->bkgd", w, v.float())
    out = out.reshape(b, h, v.shape[-1])
    if not return_lse:
        return out
    m = logits.amax(dim=-1, keepdim=True)
    total = torch.where(vmask, torch.exp(logits - m), 0.0).sum(dim=-1)
    lse = torch.where(total > 0, m[..., 0] + torch.log(total), NEG_INF)
    return out, lse.reshape(b, h)


def paged_attention_pool_ref(q, pool, block_table, lengths, *, k_plane,
                             v_plane, window: int = 0, logit_cap: float = 0.0,
                             scale=None):
    """Plane-indexed version over ONE engine extent pool
    (E, page, n_planes, KV, hd): the serving engine's ``kernel="torch"`` /
    ``"ref"`` route and the kernel's plain counterpart."""
    return paged_attention_ref(q, pool[:, :, k_plane], pool[:, :, v_plane],
                               block_table, lengths, window=window,
                               logit_cap=logit_cap, scale=scale)
