"""Attention implementations (the plain PyTorch paths).

Port of ``repro/models/attention.py``:

- ``dense_attention``   : materializes (Sq, Skv) scores — oracle & tiny smokes.
- ``chunked_attention`` : the FlashAttention algorithm in plain torch — a
                          loop over KV chunks with an online-softmax carry.
- ``banded_attention``  : sliding-window layers — a loop over Q chunks, each
                          attending to a (window + chunk) KV band.

Decode-side cores (one new token against a cache) live here too, with the
split-KV partial/merge pair (FlashDecoding-style log-sum-exp merge) and the
paged gather through DBS block tables. The hand-written CUDA kernels in
``repro_torch.kernels`` implement the same contracts.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.layers import apply_rope  # noqa: F401 (re-export)
from repro_torch.models.layers import softcap as _softcap

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1


def _gqa_expand(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,H,hd) -> (B,S,KV,G,hd) grouping query heads per KV head."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
          window: int) -> torch.Tensor:
    """Causal (+ optional sliding window) mask: (B, Sq, Sk) booleans."""
    m = k_pos[:, None, :] <= q_pos[:, :, None]
    if window and window > 0:
        m = m & (k_pos[:, None, :] > (q_pos[:, :, None] - window))
    return m


# ---------------------------------------------------------------------------
# dense (oracle)
# ---------------------------------------------------------------------------
def dense_attention(q, k, v, q_pos, k_pos, *, window: int = 0,
                    logit_cap: float = 0.0, scale: Optional[float] = None):
    """q: (B,Sq,H,hd); k,v: (B,Sk,KV,hd); *_pos: (B,S*) absolute positions."""
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = _gqa_expand(q, n_kv)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    logits = _softcap(logits, logit_cap)
    mask = _mask(q_pos, k_pos, window)[:, None, None]          # (B,1,1,Sq,Sk)
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# chunked flash (global layers, prefill)
# ---------------------------------------------------------------------------
def chunked_attention(q, k, v, q_pos, k_pos, *, window: int = 0,
                      logit_cap: float = 0.0, scale: Optional[float] = None,
                      chunk: int = 1024, remat_chunks: bool = True,
                      unroll: bool = False):
    """``remat_chunks``/``unroll`` shape the reference's compiled scan and
    change no value; they are accepted for signature parity."""
    b, sq, h, d = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if sk % chunk:
        chunk = math.gcd(sk, chunk) or sk
    n_chunks = sk // chunk
    qg = _gqa_expand(q, n_kv).float().movedim(1, 3)           # (B,KV,G,Sq,d)
    g = h // n_kv
    dv = v.shape[-1]
    m = torch.full((b, n_kv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, n_kv, g, sq), device=q.device)
    acc = torch.zeros((b, n_kv, g, sq, dv), device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kc, vc, kp = k[:, sl], v[:, sl], k_pos[:, sl]
        logits = torch.einsum("bkgqd,bskd->bkgqs", qg, kc.float()) * scale
        logits = _softcap(logits, logit_cap)
        mask = _mask(q_pos, kp, window)[:, None, None]
        logits = torch.where(mask, logits, NEG_INF)
        m_cur = torch.amax(logits, dim=-1)
        m_new = torch.maximum(m, m_cur)
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p, vc.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.movedim(3, 1).reshape(b, sq, h, dv)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# banded sliding-window (local layers, prefill)
# ---------------------------------------------------------------------------
def banded_attention(q, k, v, q_pos, k_pos, *, window: int,
                     logit_cap: float = 0.0, scale: Optional[float] = None,
                     q_chunk: int = 1024, remat_chunks: bool = True,
                     unroll: bool = False):
    """Sliding-window attention reading only a (window + q_chunk) KV band per
    query chunk: memory traffic O(S·W)."""
    b, sq, h, d = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if sq % q_chunk:
        q_chunk = math.gcd(sq, q_chunk) or sq
    band = window + q_chunk
    if band >= sk:  # band covers everything: fall back
        return chunked_attention(q, k, v, q_pos, k_pos, window=window,
                                 logit_cap=logit_cap, scale=scale)
    n_q = sq // q_chunk
    qg = _gqa_expand(q, n_kv).float().movedim(1, 3)           # B,KV,G,Sq,d
    outs = []
    for qi in range(n_q):
        start = min(max(qi * q_chunk + q_chunk - band, 0), sk - band)
        ks, vs = k[:, start:start + band], v[:, start:start + band]
        kp = k_pos[:, start:start + band]
        qp = q_pos[:, qi * q_chunk:(qi + 1) * q_chunk]
        qb = qg[:, :, :, qi * q_chunk:(qi + 1) * q_chunk]     # (B,KV,G,qc,d)
        logits = torch.einsum("bkgqd,bskd->bkgqs", qb, ks.float()) * scale
        logits = _softcap(logits, logit_cap)
        mask = _mask(qp, kp, window)[:, None, None]
        logits = torch.where(mask, logits, NEG_INF)
        w = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bkgqs,bskd->bkgqd", w, vs.float()))
    dv = v.shape[-1]
    out = torch.cat(outs, dim=3)                              # B,KV,G,Sq,dv
    out = out.movedim(3, 1).reshape(b, sq, h, dv)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# decode cores
# ---------------------------------------------------------------------------
def decode_attention(q, k_cache, v_cache, q_pos, k_pos, *, window: int = 0,
                     logit_cap: float = 0.0, scale: Optional[float] = None):
    """Single-step decode against a dense cache.

    q: (B,1,H,hd); caches: (B,S,KV,hd); q_pos: (B,1); k_pos: (B,S) with
    out-of-range slots marked by k_pos > q_pos (they mask off naturally).
    """
    o, m, l = decode_partial(q, k_cache, v_cache, q_pos, k_pos,
                             window=window, logit_cap=logit_cap, scale=scale)
    return finish_partial(o, m, l).to(q.dtype)


def decode_partial(q, k_cache, v_cache, q_pos, k_pos, *, window: int = 0,
                   logit_cap: float = 0.0, scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split-KV partial attention: returns unnormalized (o, m, l), the
    per-stripe piece of a distributed paged read; stripes merge with
    :func:`merge_partials`."""
    b, sq, h, d = q.shape
    n_kv = k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    # products in the cache dtype with fp32 results, as the reference's
    # preferred_element_type=float32
    qg = _gqa_expand(q, n_kv).to(k_cache.dtype)              # (B,1,KV,G,d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float() * scale
    logits = _softcap(logits, logit_cap)
    mask = _mask(q_pos, k_pos, window)[:, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    m = torch.amax(logits, dim=-1)                            # (B,KV,G,1)
    p = torch.exp(logits - m[..., None])
    p = torch.where(mask, p, 0.0)                  # kill all-masked row exp(0)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_cache.dtype),
                     v_cache).float()
    return o, m, l


def merge_partials(o_parts, m_parts, l_parts):
    """Merge split-KV partials (stacked on axis 0) -> normalized output."""
    m_star = torch.amax(m_parts, dim=0)
    corr = torch.exp(m_parts - m_star)
    l_star = torch.sum(l_parts * corr, dim=0)
    o_star = torch.sum(o_parts * corr[..., None], dim=0)
    return o_star / torch.clamp(l_star[..., None], min=1e-30)


def finish_partial(o, m, l):
    """(B,KV,G,1,d) unnormalized -> (B,1,H,d) normalized output."""
    b, kv, g, sq, d = o.shape
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, kv * g, sq, d).transpose(1, 2)


# ---------------------------------------------------------------------------
# paged decode (gather path — the DBS read through the block table)
# ---------------------------------------------------------------------------
def paged_gather(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """pool: (E, page, ...); block_table: (B, P) -> (B, P*page, ...).

    The gather *is* DBS's in-memory extent-map lookup: O(1) per page and
    independent of the snapshot-chain length. A hole id (-1) reads the
    pool's last row, as negative indices wrap in the reference's gather."""
    g = pool[block_table.long()]                              # (B,P,page,...)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def paged_decode_attention(q, pool_k, pool_v, block_table, q_pos, *,
                           window: int = 0, logit_cap: float = 0.0,
                           scale: Optional[float] = None,
                           page_owner_stride: int = 1, owner_rank: int = 0,
                           stripe_slice: bool = True):
    """Decode attention reading KV through DBS block tables.

    pool_k/pool_v: (E, page, KV, hd); block_table: (B, P_max) local extent
    ids; page ``p`` of a sequence is owned by shard ``p %
    page_owner_stride`` (pages this shard does not own are masked).
    Returns unnormalized partials (o, m, l); single-shard callers normalize
    via :func:`finish_partial`. ``stripe_slice`` gathers only the owned
    pages when P divides by the stride.
    """
    b, p_max = block_table.shape
    page = pool_k.shape[1]
    stride = page_owner_stride
    dev = q.device
    if stripe_slice and stride > 1 and p_max % stride == 0:
        bt = block_table.reshape(b, p_max // stride, stride)[:, :, owner_rank]
        k = paged_gather(pool_k, bt)                          # owned pages only
        v = paged_gather(pool_v, bt)
        l_idx = torch.arange(p_max // stride, dtype=torch.int32, device=dev)
        pos = ((l_idx * stride + owner_rank)[:, None] * page
               + torch.arange(page, dtype=torch.int32, device=dev)[None, :])
        k_pos = pos.reshape(-1).expand(k.shape[:2])
        return decode_partial(q, k, v, q_pos, k_pos, window=window,
                              logit_cap=logit_cap, scale=scale)
    k = paged_gather(pool_k, block_table)                     # (B, P*page, KV, hd)
    v = paged_gather(pool_v, block_table)
    page_idx = torch.arange(p_max, dtype=torch.int32, device=dev)
    owner_ok = (page_idx % page_owner_stride) == owner_rank   # (P,)
    pos = (page_idx[:, None] * page
           + torch.arange(page, dtype=torch.int32, device=dev)[None, :])
    k_pos = pos.reshape(-1).expand(b, p_max * page)
    # non-owned pages pushed out of causal range
    k_pos = torch.where(owner_ok.repeat_interleave(page)[None, :], k_pos,
                        INT32_MAX)
    return decode_partial(q, k, v, q_pos, k_pos, window=window,
                          logit_cap=logit_cap, scale=scale)
