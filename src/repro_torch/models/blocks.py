"""Transformer, hybrid and RWKV blocks, the layer schedule and cache
structures.

Port of ``repro/models/blocks.py`` for global- and local-attention layers,
MLA layers (deepseek-v3's low-rank latent attention, run in the absorbed
latent basis), hybrid layers (attention and a Mamba branch side by side,
hymba), RWKV-6 layers (time mix and channel mix, ``models/ssm.py``), each
with a dense or a dropless MoE MLP. A model is a sequence of
*segments*; each segment is ``count`` repetitions of a static tuple of
layer signatures. ``forward``, prefill and decode walk the layers one by
one and thread heterogeneous per-layer caches (paged DBS pools for global
attention, ring buffers for sliding-window layers, O(1) recurrent states
for Mamba and RWKV, dense caches otherwise).

Caches are updated in place and returned (the reference returns new
arrays): at full width a decode step would otherwise copy every ring cache.
A cache entry that is a view (the serving engine's per-slot rows) writes
through to the tensor it views; so does a hybrid layer's Mamba state.

MoE MLPs pick their form from shapes alone (``layers.apply_moe``): every
expert on every token where that is small (every decode step: nothing
waits on the host), per-expert groups otherwise.

An MLA layer's cache holds one shared KV "head": keys of the latent plus
the rope part (576 wide on deepseek-v3), values of the latent (512), and
its attention runs H query heads on it (GQA with one KV head) at the
explicit scale 1/sqrt(nope + rope), on every cache kind and in every
attention route. A layer kind the port does not know raises a
``ValueError``. A layer's output passes through
``distributed.runtime.constrain`` where the reference's does: a no-op
unless a launcher installed an activation placement.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.configs.base import (ArchConfig, ATTN_GLOBAL, ATTN_HYBRID,
                                      ATTN_LOCAL, ATTN_MLA, ATTN_RWKV,
                                      MLP_MOE)
from repro_torch.core.dbs import last_live_lane
from repro_torch.distributed.runtime import constrain
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (Params, apply_mlp, apply_moe,
                                       dense_init, init_mlp, init_moe,
                                       rms_norm)

INT32_MAX = 2 ** 31 - 1
PORTED_ATTN = (ATTN_GLOBAL, ATTN_LOCAL, ATTN_MLA, ATTN_HYBRID, ATTN_RWKV)


# ---------------------------------------------------------------------------
# layer schedule
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LayerSig:
    attn: str          # global | local | mla | hybrid | rwkv6
    window: int        # 0 = full attention
    mlp: str           # dense | moe


@dataclass(frozen=True)
class Segment:
    sigs: Tuple[LayerSig, ...]
    count: int
    first_layer: int   # global index of the segment's first layer


def layer_sigs(cfg: ArchConfig) -> List[LayerSig]:
    out = []
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        window = 0
        if kind == ATTN_LOCAL:
            window = cfg.sliding_window
        elif kind == ATTN_HYBRID:
            window = 0 if i in cfg.global_layer_indices else cfg.sliding_window
        out.append(LayerSig(kind, window, cfg.mlp_kind(i)))
    return out


def layer_schedule(cfg: ArchConfig) -> List[Segment]:
    sigs = layer_sigs(cfg)
    n = len(sigs)
    # try a small repeating unit (gemma2: LG, gemma3: LLLLLG)
    for u in range(1, 9):
        reps, tail = divmod(n, u)
        if reps < 2:
            break
        unit = tuple(sigs[:u])
        if tuple(sigs) == (unit * (reps + 1))[:n]:
            segs = [Segment(unit, reps, 0)]
            if tail:
                segs.append(Segment(tuple(sigs[reps * u:]), 1, reps * u))
            return segs
    # fallback: run-length segments (hymba, deepseek)
    segs: List[Segment] = []
    i = 0
    while i < n:
        j = i
        while j < n and sigs[j] == sigs[i]:
            j += 1
        segs.append(Segment((sigs[i],), j - i, i))
        i = j
    return segs


def check_ported(sig: LayerSig) -> None:
    """Raise a ValueError for a layer kind the port does not know."""
    if sig.attn not in PORTED_ATTN:
        raise ValueError(f"unknown layer kind {sig.attn!r}: the port runs "
                         f"{', '.join(PORTED_ATTN)}")


# ---------------------------------------------------------------------------
# per-layer parameter init
# ---------------------------------------------------------------------------
def init_layer(gen: torch.Generator, cfg: ArchConfig, sig: LayerSig) -> Params:
    """One layer's parameters, drawn from ``gen`` on its device."""
    check_ported(sig)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dev = gen.device
    norm_w = (lambda n: torch.zeros((n,), device=dev)) if _gemma(cfg) else (
        lambda n: torch.ones((n,), device=dev))
    p: Params = {"ln1": norm_w(d), "ln2": norm_w(d)}
    if sig.attn == ATTN_RWKV:
        p["tmix_cmix"] = ssm.init_rwkv6(gen, cfg)
        return p
    if sig.attn == ATTN_MLA:
        m = cfg.mla
        qh = cfg.n_heads * (m.nope_head_dim + m.rope_head_dim)
        p["q_a"] = dense_init(gen, d, m.q_lora_rank)
        p["q_a_norm"] = torch.ones((m.q_lora_rank,), device=dev)
        p["q_b"] = dense_init(gen, m.q_lora_rank, qh)
        p["kv_a"] = dense_init(gen, d, m.kv_lora_rank + m.rope_head_dim)
        p["kv_a_norm"] = torch.ones((m.kv_lora_rank,), device=dev)
        p["kv_b"] = dense_init(gen, m.kv_lora_rank,
                               cfg.n_heads * (m.nope_head_dim + m.v_head_dim))
        p["o"] = dense_init(gen, cfg.n_heads * m.v_head_dim, d)
    else:
        p.update({
            "q": dense_init(gen, d, cfg.n_heads * hd),
            "k": dense_init(gen, d, cfg.n_kv_heads * hd),
            "v": dense_init(gen, d, cfg.n_kv_heads * hd),
            "o": dense_init(gen, cfg.n_heads * hd, d),
        })
        if cfg.qk_norm:
            p["q_norm"] = torch.ones((hd,), device=dev)
            p["k_norm"] = torch.ones((hd,), device=dev)
        if sig.attn == ATTN_HYBRID:
            p["mamba"] = ssm.init_mamba(gen, cfg)
            p["fuse_norm_attn"] = torch.ones((d,), device=dev)
            p["fuse_norm_ssm"] = torch.ones((d,), device=dev)
    if cfg.post_norms:
        p["ln1_post"] = norm_w(d)
        p["ln2_post"] = norm_w(d)
    p["mlp"] = (init_moe(gen, cfg) if sig.mlp == MLP_MOE
                else init_mlp(gen, cfg))
    return p


def _gemma(cfg: ArchConfig) -> bool:
    return cfg.name.startswith("gemma")


def _norm(cfg):
    def f(x, w):
        return rms_norm(x, w, cfg.norm_eps, gemma_style=_gemma(cfg))
    return f


# ---------------------------------------------------------------------------
# cache structures
# ---------------------------------------------------------------------------
def init_layer_cache(cfg: ArchConfig, sig: LayerSig, batch: int, max_len: int,
                     *, paged: bool, dtype=torch.bfloat16,
                     page_owner_stride: int = 1, device=None) -> Params:
    """Cache dict for one layer on ``device``."""
    check_ported(sig)
    if sig.attn == ATTN_RWKV:
        return {"rwkv": ssm.rwkv6_init_state(cfg, batch, dtype, device)}
    page = cfg.page_blocks
    if sig.attn == ATTN_MLA:
        m = cfg.mla
        kd, vd = m.kv_lora_rank + m.rope_head_dim, m.kv_lora_rank
        n_kv = 1
    else:
        kd = vd = cfg.resolved_head_dim
        n_kv = cfg.n_kv_heads
    z = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    c: Params = {}
    if sig.attn == ATTN_HYBRID:
        e = cfg.ssm.expand * cfg.d_model
        c["mamba"] = {"conv": z((batch, cfg.ssm.conv_kernel - 1, e)),
                      "ssm": z((batch, e, cfg.ssm.state_dim), torch.float32)}
    if sig.window:  # sliding-window ring buffer
        w = min(sig.window, max_len)
        c["ring_k"] = z((batch, w, n_kv, kd))
        c["ring_v"] = z((batch, w, n_kv, vd))
        c["ring_pos"] = torch.full((batch, w), INT32_MAX, dtype=torch.int32,
                                   device=device)
    elif paged:
        stride = max(page_owner_stride, 1)
        n_pages = math.ceil(max_len / page)
        padded = math.ceil(n_pages / stride) * stride
        # global pool: one extent per (sequence, padded page); stripe r of
        # the extent dim holds pages p with p % stride == r.
        n_ext = max(stride, batch * padded)
        c["pool_k"] = z((n_ext, page, n_kv, kd))
        c["pool_v"] = z((n_ext, page, n_kv, vd))
        c["block_table"] = z((batch, n_pages), torch.int32)
    else:
        c["k"] = z((batch, max_len, n_kv, kd))
        c["v"] = z((batch, max_len, n_kv, vd))
    return c


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------
@dataclass
class BlockCtx:
    """Everything a block needs besides params and the hidden state."""
    mode: str                               # train (forward) | prefill | decode
    q_pos: torch.Tensor                     # (B, Sq) absolute positions
    k_pos: Optional[torch.Tensor] = None    # (B, Sk) for prefill
    cache: Optional[Params] = None
    attn_impl: str = "chunked"              # dense | chunked | cuda
    chunk: int = 1024
    ssm_chunk: int = 256
    unroll: bool = False
    paged_decode_fn: Optional[Callable] = None  # the serving engine's override
    page_owner_stride: int = 1
    owner_rank: int = 0


def _project_qkv(cfg, p, h):
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    q = (h @ p["q"].to(h.dtype)).reshape(b, s, cfg.n_heads, hd)
    k = (h @ p["k"].to(h.dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ p["v"].to(h.dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps, gemma_style=_gemma(cfg))
        k = rms_norm(k, p["k_norm"], cfg.norm_eps, gemma_style=_gemma(cfg))
    return q, k, v


def _project_mla(cfg, p, h, ctx):
    """Returns (q_eff, k_new, v_new, scale) in the *absorbed* latent basis.

    q_eff: (B,S,H,kv_rank+rope); k_new: (B,S,1,kv_rank+rope); v_new = the
    latent (B,S,1,kv_rank). The same for forward, prefill and decode:
    attention runs with one shared KV "head" and H query heads (GQA with
    n_kv = 1), at the scale of the unabsorbed heads, 1/sqrt(nope + rope).
    """
    m = cfg.mla
    b, s, _ = h.shape
    nope, rope, vd = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    qa = rms_norm(h @ p["q_a"].to(h.dtype), p["q_a_norm"], cfg.norm_eps)
    q = (qa @ p["q_b"].to(h.dtype)).reshape(b, s, cfg.n_heads, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = attn.apply_rope(q_rope, ctx.q_pos, cfg.rope_theta)

    kv = h @ p["kv_a"].to(h.dtype)                         # (B,S,rank+rope)
    c_kv = rms_norm(kv[..., :m.kv_lora_rank], p["kv_a_norm"], cfg.norm_eps)
    k_rope = kv[..., m.kv_lora_rank:].reshape(b, s, 1, rope)
    k_rope = attn.apply_rope(k_rope, ctx.q_pos, cfg.rope_theta)

    # absorb the k-part of kv_b into q:  q_lat = q_nope @ W_k^T (per head)
    w = p["kv_b"].to(h.dtype).reshape(m.kv_lora_rank, cfg.n_heads, nope + vd)
    w_k = w[..., :nope]                                    # (rank, H, nope)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_k)
    q_eff = torch.cat([q_lat, q_rope], dim=-1)
    k_new = torch.cat([c_kv[:, :, None, :], k_rope], dim=-1)
    v_new = c_kv[:, :, None, :]
    scale = 1.0 / math.sqrt(nope + rope)
    return q_eff, k_new, v_new, scale


def _mla_output(cfg, p, o_lat):
    """o_lat: (B,S,H,kv_rank) -> (B,S,D) through the absorbed v-part of
    kv_b, then the output projection."""
    m = cfg.mla
    w = p["kv_b"].to(o_lat.dtype).reshape(
        m.kv_lora_rank, cfg.n_heads, m.nope_head_dim + m.v_head_dim)
    w_v = w[..., m.nope_head_dim:]                         # (rank, H, vd)
    o = torch.einsum("bshr,rhv->bshv", o_lat, w_v)
    b, s = o.shape[:2]
    return o.reshape(b, s, cfg.n_heads * m.v_head_dim) @ p["o"].to(o.dtype)


def _full_attention(cfg, sig, q, k, v, ctx, scale=None):
    """prefill attention dispatch (q,k,v already rope'd)."""
    kwargs = dict(window=sig.window, logit_cap=cfg.attn_logit_softcap,
                  scale=scale)
    if ctx.attn_impl == "dense":
        return attn.dense_attention(q, k, v, ctx.q_pos, ctx.k_pos, **kwargs)
    if ctx.attn_impl == "cuda":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q, k, v, ctx.q_pos, ctx.k_pos, **kwargs)
    if ctx.attn_impl == "pallas":
        raise ValueError("attn_impl='pallas' is the TPU kernel; the port's "
                         "hand-written flash kernel is attn_impl='cuda'")
    if sig.window and sig.window > 0:
        return attn.banded_attention(q, k, v, ctx.q_pos, ctx.k_pos,
                                     window=sig.window,
                                     logit_cap=cfg.attn_logit_softcap,
                                     scale=scale, q_chunk=ctx.chunk,
                                     unroll=ctx.unroll)
    return attn.chunked_attention(q, k, v, ctx.q_pos, ctx.k_pos,
                                  chunk=ctx.chunk, unroll=ctx.unroll, **kwargs)


def _decode_attention(cfg, sig, p, q, k_new, v_new, ctx, cache, scale=None):
    """Single-token decode: write the new K/V into the cache (in place) and
    read it, for every cache kind."""
    b = q.shape[0]
    pos = ctx.q_pos[:, 0]                                      # (B,)
    new_cache = dict(cache)
    cap = cfg.attn_logit_softcap
    if "ring_k" in cache:
        rk, rv, rp = cache["ring_k"], cache["ring_v"], cache["ring_pos"]
        slot = (pos % rk.shape[1]).long()
        _store_token(rk, slot, k_new)
        _store_token(rv, slot, v_new)
        _scatter_seq(rp, slot[:, None], pos[:, None].to(rp.dtype))
        out = attn.decode_attention(q, rk, rv, ctx.q_pos, rp,
                                    window=sig.window, logit_cap=cap,
                                    scale=scale)
    elif "pool_k" in cache:
        # write + paged read, both inside the paged fn — the serving engine
        # overrides it to scatter into and attend over its extent pools
        fn = ctx.paged_decode_fn or _local_paged_decode
        out, pk, pv = fn(q, k_new, v_new, cache["pool_k"], cache["pool_v"],
                         cache["block_table"], ctx.q_pos,
                         window=sig.window, logit_cap=cap, scale=scale)
        new_cache.update(pool_k=pk, pool_v=pv)
    else:
        kc, vc = cache["k"], cache["v"]
        s_max = kc.shape[1]
        _store_token(kc, pos.long(), k_new)
        _store_token(vc, pos.long(), v_new)
        k_pos = torch.arange(s_max, dtype=torch.int32,
                             device=q.device).expand(b, s_max)
        out = attn.decode_attention(q, kc, vc, ctx.q_pos, k_pos,
                                    window=sig.window, logit_cap=cap,
                                    scale=scale)
    return out, new_cache


def _store_token(cache, slot, new) -> None:
    """``cache[b, slot[b]] = new[b, 0]`` for every row b, in place."""
    idx = slot[:, None, None, None].expand(-1, 1, *cache.shape[2:])
    _scatter_seq(cache, idx, new.to(cache.dtype))


def _scatter_seq(cache, idx, val) -> None:
    """``cache.scatter_(1, idx, val)``: a scatter along the sequence dim,
    which never crosses rows. A DTensor cache split by rows alone (a dry
    run's cell) takes it on each rank's own rows, its index and values
    moved to its placements first: DTensor has no rule for this scatter
    in every release, and its fallback would gather every row."""
    pl = tuple(getattr(cache, "placements", ()))
    if pl and all(p.is_shard(0) or not p.is_shard() for p in pl):
        from torch.distributed.tensor.experimental import local_map
        local_map(lambda c, i, v: c.scatter_(1, i, v), out_placements=None,
                  in_placements=(pl, pl, pl),
                  redistribute_inputs=True)(cache, idx, val)
        return
    cache.scatter_(1, idx, val)


def paged_write_local(pool_k, pool_v, block_table, pos, k_new, v_new,
                      stride: int = 1, rank=0):
    """Scatter one new token's K/V into the owner stripe's pool (local ids),
    in place. A lane that does not own its page, or whose page is a hole,
    targets the pool's last row at its offset (the reference's
    ``mode="drop"`` scatter at -1 lands on that row) and stores what is
    already there, unless an owning lane stores to that same slot: then it
    stores that lane's value, so every duplicate index of the scatter
    writes one value (``index_put_`` leaves their order undefined on CUDA).
    A position past the table reads its last page, as JAX clamps the
    gather."""
    b = pos.shape[0]
    e, page = pool_k.shape[:2]
    page_idx = pos // page
    lanes = torch.arange(b, device=pos.device)
    ext = block_table[lanes, page_idx.clamp(
        max=block_table.shape[1] - 1).long()]
    off = (pos % page).long()
    owned = ((page_idx % stride) == rank) & (ext >= 0)
    ext_w = torch.where(owned, ext, e - 1).long()
    src = last_live_lane(ext_w * page + off, owned)
    take = (src >= 0)[:, None, None]
    src = src.clamp(min=0)
    pool_k[ext_w, off] = torch.where(take, k_new[src, 0].to(pool_k.dtype),
                                     pool_k[ext_w, off])
    pool_v[ext_w, off] = torch.where(take, v_new[src, 0].to(pool_v.dtype),
                                     pool_v[ext_w, off])
    return pool_k, pool_v


def _local_paged_decode(q, k_new, v_new, pool_k, pool_v, block_table, q_pos,
                        *, window=0, logit_cap=0.0, scale=None):
    pool_k, pool_v = paged_write_local(pool_k, pool_v, block_table,
                                       q_pos[:, 0], k_new, v_new)
    o, m, l = attn.paged_decode_attention(
        q, pool_k, pool_v, block_table, q_pos, window=window,
        logit_cap=logit_cap, scale=scale)
    return attn.finish_partial(o, m, l).to(q.dtype), pool_k, pool_v


def _write_prefill_cache(cfg, sig, cache, k, v, ctx):
    """Store prefill K/V into the layer cache (ring / paged / dense), in
    place."""
    new_cache = dict(cache)
    b, s = k.shape[:2]
    if "ring_k" in cache:
        w = cache["ring_k"].shape[1]
        take = min(w, s)
        # slot = pos % w, the same rule decode uses — the ring stays
        # coherent for any prefill length.
        slots = (ctx.k_pos[:, -take:] % w).long()              # (B, take)
        rows = torch.arange(b, device=k.device)[:, None]
        cache["ring_k"][rows, slots] = k[:, -take:].to(cache["ring_k"].dtype)
        cache["ring_v"][rows, slots] = v[:, -take:].to(cache["ring_v"].dtype)
        cache["ring_pos"][rows, slots] = ctx.k_pos[:, -take:].to(torch.int32)
    elif "pool_k" in cache:
        # a ragged last page is zero-padded: decode writes each position
        # before any query reaches it
        page = cache["pool_k"].shape[1]
        n_pages = -(-s // page)
        pad = n_pages * page - s
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        ext = cache["block_table"][:, :n_pages].long()         # (B,P)
        kp = k.reshape(b, n_pages, page, *k.shape[2:])
        vp = v.reshape(b, n_pages, page, *v.shape[2:])
        cache["pool_k"][ext] = kp.to(cache["pool_k"].dtype)
        cache["pool_v"][ext] = vp.to(cache["pool_v"].dtype)
    else:
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
    return new_cache


def apply_block(cfg: ArchConfig, sig: LayerSig, p: Params, x: torch.Tensor,
                ctx: BlockCtx
                ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """One block. Returns (hidden, new_cache-or-None, aux_loss scalar)."""
    check_ported(sig)
    norm = _norm(cfg)
    new_cache = ctx.cache
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if sig.attn == ATTN_RWKV:
        tp = p["tmix_cmix"]
        cached = ctx.cache["rwkv"] if ctx.cache else None
        st = cached
        if st is None:                              # forward: no cache
            st = ssm.rwkv6_init_state(cfg, x.shape[0], x.dtype, x.device)
        h = norm(x, p["ln1"])
        y, st_t = ssm.rwkv6_time_mix(tp, h, st, cfg, chunk=ctx.ssm_chunk,
                                     impl=ctx.attn_impl)
        x = x + y
        h2 = norm(x, p["ln2"])
        y2, st_c = ssm.rwkv6_channel_mix(tp, h2, st)
        x = x + y2
        if cached is not None:
            # in place: the serving engine's per-slot views write through
            # (not into forward's fresh state, which backward reads)
            for key, val in {**st_t, **st_c}.items():
                cached[key].copy_(val)
        return x, new_cache, aux

    resid = x
    h = norm(x, p["ln1"])
    scale = None
    if sig.attn == ATTN_MLA:
        q, k, v, scale = _project_mla(cfg, p, h, ctx)
    else:
        q, k, v = _project_qkv(cfg, p, h)
        q = attn.apply_rope(q, ctx.q_pos, cfg.rope_theta)
        k = attn.apply_rope(k, ctx.q_pos, cfg.rope_theta)

    if ctx.mode == "decode":
        o, new_cache = _decode_attention(cfg, sig, p, q, k, v, ctx, ctx.cache,
                                         scale=scale)
    else:
        o = _full_attention(cfg, sig, q, k, v, ctx, scale=scale)
        if ctx.mode == "prefill":
            new_cache = _write_prefill_cache(cfg, sig, ctx.cache, k, v, ctx)

    if sig.attn == ATTN_MLA:
        att_out = _mla_output(cfg, p, o)
    else:
        b, s = o.shape[:2]
        att_out = o.reshape(b, s, -1) @ p["o"].to(o.dtype)

    if sig.attn == ATTN_HYBRID:
        # forward has no cache: the branch starts from the zero state
        mstate = ctx.cache["mamba"] if ctx.cache is not None else None
        if ctx.mode == "decode":
            m_out, m_state = ssm.mamba_step(p["mamba"], h, mstate)
        else:
            m_out, m_state = ssm.mamba_forward(p["mamba"], h, mstate,
                                               chunk=ctx.ssm_chunk)
        att_out = 0.5 * (norm(att_out, p["fuse_norm_attn"])
                         + norm(m_out, p["fuse_norm_ssm"]))
        if mstate is not None:
            # in place: the serving engine's per-slot views write through
            for key, val in m_state.items():
                mstate[key].copy_(val)

    if cfg.post_norms:
        att_out = norm(att_out, p["ln1_post"])
    x = resid + att_out

    # ---------------- MLP ---------------------------------------------------
    resid = x
    h = norm(x, p["ln2"])
    if sig.mlp == MLP_MOE:
        mlp_out, aux = apply_moe(p["mlp"], h, cfg)
    else:
        mlp_out = apply_mlp(p["mlp"], h, cfg)
    if cfg.post_norms:
        mlp_out = norm(mlp_out, p["ln2_post"])
    return constrain(resid + mlp_out), new_cache, aux
