"""Model assembly: init / forward / caches / prefill / decode over the layer
schedule.

Port of ``repro/models/model.py``, deepseek-v3's multi-token-prediction
head included (``init_params`` draws it, ``mtp_hidden`` runs it; its loss
is training's). ``forward`` walks the layers one by one (no scan over
stacked segments); with ``plan.remat`` other than ``"none"`` and autograd
recording, each layer runs under ``torch.utils.checkpoint``, so backward
keeps only the layers' inputs and recomputes the rest a layer at a time,
as the reference's ``jax.checkpoint`` a layer does. ``init_params`` draws
every weight from one ``torch.Generator`` on its device and holds the layers
unstacked (``params["layers_unstacked"]``, one dict per layer, as the
reference's ``unstack_params`` gives them); trees carried over from the
reference (``core/convert.py params_from_numpy``) keep its stacked
``segments``, which ``_iter_layers`` slices per layer as views (nested
parameter dicts, such as an RWKV layer's ``tmix_cmix``, included).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ExecutionPlan, MLP_DENSE
from repro_torch.models import blocks as B
from repro_torch.models.layers import (Params, embed_tokens, init_embeddings,
                                       lm_logits, normal, rms_norm)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random fp32 parameters drawn from ``gen``, made on ``gen.device``;
    with ``cfg.mtp_depth`` the MTP head ``p["mtp"]`` too: one block
    (``mtp_sig``), the ``(2d, d)`` projection and its norm."""
    p: Params = {"embed": init_embeddings(gen, cfg)}
    p["layers_unstacked"] = [B.init_layer(gen, cfg, sig)
                             for sig in B.layer_sigs(cfg)]
    fill = torch.zeros if cfg.name.startswith("gemma") else torch.ones
    p["final_norm"] = fill((cfg.d_model,), device=gen.device)
    if cfg.mtp_depth:
        p["mtp"] = {
            "block": B.init_layer(gen, cfg, mtp_sig(cfg)),
            "proj": normal(gen, (2 * cfg.d_model, cfg.d_model), 0.02),
            "norm": torch.ones((cfg.d_model,), device=gen.device),
        }
    return p


def mtp_sig(cfg: ArchConfig) -> B.LayerSig:
    """The MTP block's signature: the last layer's token mixer with a dense
    MLP of ``d_ff``."""
    return B.LayerSig(cfg.layer_kind(cfg.n_layers - 1), 0, MLP_DENSE)


def param_count_actual(params: Params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def tree_leaves(tree) -> List:
    """Leaves of nested dicts, lists and tuples, in insertion order."""
    return leaves_up_to(tree, tree)


def leaves_up_to(like, tree) -> List:
    """``tree``'s subtrees at ``like``'s leaves, in ``like``'s order."""
    if isinstance(like, dict):
        return [x for k in like for x in leaves_up_to(like[k], tree[k])]
    if isinstance(like, (list, tuple)):
        return [x for a, b in zip(like, tree) for x in leaves_up_to(a, b)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            plan: ExecutionPlan, positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S[,K]) -> (final hidden states (B,S,D), aux loss scalar):
    every layer over the whole sequence, no cache, the MoE layers' aux
    losses summed."""
    dtype = _dtype(plan.compute_dtype)
    x = embed_tokens(params["embed"], tokens, cfg, dtype)
    bsz, seq = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(seq, dtype=torch.int32,
                                 device=x.device).expand(bsz, seq)
    ctx = B.BlockCtx(mode="train", q_pos=positions, k_pos=positions,
                     attn_impl=plan.attn_impl, chunk=1024)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = plan.remat != "none" and torch.is_grad_enabled()
    for _li, sig, lp in _iter_layers(cfg, params):
        if remat:
            x, a = checkpoint(_train_block, cfg, sig, lp, x, ctx,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _train_block(cfg, sig, lp, x, ctx)
        aux = aux + a
    h = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 gemma_style=cfg.name.startswith("gemma"))
    return h, aux


def _train_block(cfg, sig, lp, x, ctx):
    x, _, a = B.apply_block(cfg, sig, lp, x, ctx)
    return x, a


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               paged: bool = True, dtype=torch.bfloat16,
               page_owner_stride: int = 1, device=None) -> List[Params]:
    """Per-layer cache list (global layer order) on ``device``."""
    return [B.init_layer_cache(cfg, sig, batch, max_len, paged=paged,
                               dtype=dtype,
                               page_owner_stride=page_owner_stride,
                               device=device)
            for sig in B.layer_sigs(cfg)]


def default_block_tables(cfg: ArchConfig, batch: int, max_len: int,
                         page_owner_stride: int = 1, batch_shards: int = 1,
                         device=None) -> torch.Tensor:
    """Identity page layout matching init_layer_cache's striped pool: page
    ``p`` of (locally indexed) sequence ``b_loc`` lives at local extent
    ``b_loc * K + p // stride`` on stripe ``p % stride``. The serving
    engine replaces it with DBS-allocated tables."""
    stride = max(page_owner_stride, 1)
    n_pages = math.ceil(max_len / cfg.page_blocks)
    k_per = math.ceil(n_pages / stride)
    b_local = (torch.arange(batch, dtype=torch.int32, device=device)
               % max(batch // max(batch_shards, 1), 1))
    p = torch.arange(n_pages, dtype=torch.int32, device=device)
    return (p // stride)[None, :] + (b_local * k_per)[:, None]


def with_block_tables(caches: List[Params], bt: torch.Tensor) -> List[Params]:
    out = []
    for c in caches:
        if c is not None and "block_table" in c:
            c = dict(c)
            c["block_table"] = bt[:, : c["block_table"].shape[1]]
        out.append(c)
    return out


# ---------------------------------------------------------------------------
# prefill / decode (layer by layer, heterogeneous caches)
# ---------------------------------------------------------------------------
def _iter_layers(cfg, params):
    """Yields (global_layer_idx, sig, layer_params)."""
    if "layers_unstacked" in params:
        for li, (sig, lp) in enumerate(zip(B.layer_sigs(cfg),
                                           params["layers_unstacked"])):
            yield li, sig, lp
        return
    schedule = B.layer_schedule(cfg)
    li = 0
    for seg, seg_p in zip(schedule, params["segments"]):
        for step in range(seg.count):
            for pi, sig in enumerate(seg.sigs):
                lp = tree_map(lambda a, s=step: a[s], seg_p[f"pos{pi}"])
                yield li, sig, lp
                li += 1


def stack_params(params: Params, cfg: ArchConfig) -> Params:
    """The reference's stacked layout from per-layer dicts: ``segments``,
    one dict a segment of ``pos<i>`` trees whose leaves stack the
    segment's layers on a leading dim, in the reference's key order
    (``embed``, ``segments``, ``final_norm``, ``mtp``). The inverse of
    ``unstack_params``; a segment's per-layer tensors are dropped as it is
    stacked."""
    layers = list(params["layers_unstacked"])
    segs = []
    for seg in B.layer_schedule(cfg):
        width = len(seg.sigs)
        seg_p = {}
        for pi in range(width):
            idx = [seg.first_layer + step * width + pi
                   for step in range(seg.count)]
            seg_p[f"pos{pi}"] = _stack_trees([layers[i] for i in idx])
            for i in idx:
                layers[i] = None
        segs.append(seg_p)
    out = {"embed": params["embed"], "segments": segs,
           "final_norm": params["final_norm"]}
    if "mtp" in params:
        out["mtp"] = params["mtp"]
    return out


def _stack_trees(trees: List) -> Params:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def unstack_params(params: Params, cfg: ArchConfig) -> Params:
    """Per-layer parameter dicts (views of the stacked segments)."""
    out = {k: v for k, v in params.items() if k != "segments"}
    out["layers_unstacked"] = [lp for _, _, lp in _iter_layers(cfg, params)]
    return out


def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            plan: ExecutionPlan, caches: List[Params],
            positions: Optional[torch.Tensor] = None,
            paged_decode_fn=None, page_owner_stride: int = 1,
            owner_rank: int = 0) -> Tuple[torch.Tensor, List[Params]]:
    """Full-sequence forward that also fills the caches (in place).

    Returns (logits of the last position (B,V), caches). ``plan.remat``
    shapes the reference's compiled graph only; no gradient is taken here."""
    dtype = _dtype(plan.compute_dtype)
    x = embed_tokens(params["embed"], tokens, cfg, dtype)
    bsz, seq = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(seq, dtype=torch.int32,
                                 device=x.device).expand(bsz, seq)
    new_caches = list(caches)
    for li, sig, lp in _iter_layers(cfg, params):
        ctx = B.BlockCtx(mode="prefill", q_pos=positions, k_pos=positions,
                         cache=caches[li], attn_impl=plan.attn_impl,
                         chunk=1024, paged_decode_fn=paged_decode_fn,
                         page_owner_stride=page_owner_stride,
                         owner_rank=owner_rank)
        x, new_caches[li], _ = B.apply_block(cfg, sig, lp, x, ctx)
    h = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps,
                 gemma_style=cfg.name.startswith("gemma"))
    logits = lm_logits(params["embed"], h, cfg)
    return logits[:, 0], new_caches


def decode_step(params: Params, tokens: torch.Tensor, pos: torch.Tensor,
                cfg: ArchConfig, plan: ExecutionPlan, caches: List[Params],
                paged_decode_fn=None, page_owner_stride: int = 1,
                owner_rank: int = 0) -> Tuple[torch.Tensor, List[Params]]:
    """One decode step. tokens: (B,) or (B,K); pos: (B,) current positions.

    Returns (logits (B,V) or (B,K,V), caches updated in place)."""
    dtype = _dtype(plan.compute_dtype)
    tok = tokens[:, None] if tokens.dim() == 1 else tokens[:, None, :]
    x = embed_tokens(params["embed"], tok, cfg, dtype)          # (B,1,D)
    q_pos = pos[:, None].to(torch.int32)
    new_caches = list(caches)
    for li, sig, lp in _iter_layers(cfg, params):
        ctx = B.BlockCtx(mode="decode", q_pos=q_pos, cache=caches[li],
                         attn_impl=plan.attn_impl,
                         paged_decode_fn=paged_decode_fn,
                         page_owner_stride=page_owner_stride,
                         owner_rank=owner_rank)
        x, new_caches[li], _ = B.apply_block(cfg, sig, lp, x, ctx)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 gemma_style=cfg.name.startswith("gemma"))
    logits = lm_logits(params["embed"], h, cfg)
    return logits[:, 0], new_caches


# ---------------------------------------------------------------------------
# deepseek MTP (multi-token prediction) auxiliary hidden states
# ---------------------------------------------------------------------------
def mtp_hidden(params: Params, h: torch.Tensor, tokens: torch.Tensor,
               cfg: ArchConfig, plan: ExecutionPlan) -> torch.Tensor:
    """DeepSeek-V3 MTP: combine h_t with emb(token_{t+1}) and run one extra
    block; the caller computes the t+2 loss on the result. h: (B,S,D) ->
    (B,S-1,D)."""
    mtp = params["mtp"]
    dtype = h.dtype
    emb_next = embed_tokens(params["embed"], tokens[:, 1:], cfg, dtype)
    h_in = torch.cat([rms_norm(h[:, :-1], mtp["norm"], cfg.norm_eps),
                      emb_next], dim=-1)
    h_in = h_in @ mtp["proj"].to(dtype)
    bsz, seq = h_in.shape[:2]
    positions = torch.arange(seq, dtype=torch.int32,
                             device=h.device).expand(bsz, seq)
    ctx = B.BlockCtx(mode="train", q_pos=positions, k_pos=positions,
                     attn_impl=plan.attn_impl)
    out, _, _ = B.apply_block(cfg, mtp_sig(cfg), mtp["block"], h_in, ctx)
    return out
