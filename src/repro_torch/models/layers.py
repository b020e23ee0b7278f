"""Shared layer primitives: norms, RoPE, MLPs, MoE, embeddings.

Port of ``repro/models/layers.py`` on torch tensors. Parameters are plain
dicts of tensors: ``init_*`` builds them, the ``apply``-style functions
consume them. Initialisation draws from an explicit ``torch.Generator`` on
the generator's own device, so a full-width model is made on the card
without passing through the host. The compute dtype is the caller's
(parameters are cast at the call site).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------
def normal(gen: torch.Generator, shape, std: float = 1.0) -> torch.Tensor:
    """Standard-normal fp32 draws on the generator's device, times std (in
    place: a 15 GB expert tensor is made without a second copy)."""
    return torch.randn(shape, generator=gen, device=gen.device).mul_(std)


def dense_init(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    return normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             *, gemma_style: bool = False) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = weight.float()
    out = x * (1.0 + w) if gemma_style else x * w
    return out.to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2-style tanh logit soft-capping; no-op when cap == 0."""
    if cap and cap > 0.0:
        return torch.tanh(x / cap) * cap
    return x


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu_sq":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    if theta <= 0:
        return x
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (hd/2,)
    angles = positions[..., :, None].float() * freqs            # (..., S, hd/2)
    angles = angles[..., None, :]                               # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, cfg: ArchConfig,
             d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"wi": dense_init(gen, d, f), "wo": dense_init(gen, f, d)}
    if cfg.gated_mlp:
        p["wg"] = dense_init(gen, d, f)
    return p


def gated(act, h: torch.Tensor, g: Optional[torch.Tensor]) -> torch.Tensor:
    """``act(h) * g`` (``act(h)`` when ``g`` is None) in fp32, rounded once
    to ``h``'s dtype: the reference's XLA fuses this elementwise chain and
    keeps it in fp32 between its ends, where eager ops would round after
    each one. In fp32 it is the plain product."""
    out = act(h.float())
    if g is not None:
        out = out * g.float()
    return out.to(h.dtype)


def apply_mlp(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    h = x @ p["wi"].to(x.dtype)
    h = gated(act, h, x @ p["wg"].to(x.dtype) if "wg" in p else None)
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# MoE — token-dropless top-k routing
# ---------------------------------------------------------------------------
def init_moe(gen: torch.Generator, cfg: ArchConfig) -> Params:
    mo = cfg.moe
    d, f, e = cfg.d_model, mo.d_ff_expert, mo.e_total
    p: Params = {
        "router": dense_init(gen, d, e),
        "wi": normal(gen, (e, d, f), 1.0 / math.sqrt(d)),
        "wo": normal(gen, (e, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.gated_mlp:
        p["wg"] = normal(gen, (e, d, f), 1.0 / math.sqrt(d))
    if mo.router_aux_free:
        p["router_bias"] = torch.zeros((e,), device=gen.device)
    if mo.n_shared:
        p["shared"] = init_mlp(gen, cfg, d_ff=mo.n_shared * mo.d_ff_shared)
    return p


def _moe_route(p: Params, xf: torch.Tensor, cfg: ArchConfig):
    """Router logits (T, E) in fp32 and the top-k experts (T, k) with their
    combine weights, as the reference routes."""
    mo = cfg.moe
    logits = (xf @ p["router"].to(xf.dtype)).float()
    if mo.n_experts_padded > mo.n_experts:
        # padded experts exist only for even expert-parallel sharding; the
        # router never selects them
        dead = torch.arange(mo.e_total, device=xf.device) >= mo.n_experts
        logits = torch.where(dead[None, :], -1e30, logits)
    if mo.router_aux_free:
        gates = torch.sigmoid(logits)
        top_idx = torch.topk(gates + p["router_bias"], mo.top_k, dim=-1)[1]
        top_gate = torch.gather(gates, -1, top_idx)
        top_w = top_gate / (torch.sum(top_gate, -1, keepdim=True) + 1e-9)
    else:
        top_logits, top_idx = torch.topk(logits, mo.top_k, dim=-1)
        top_w = torch.softmax(top_logits, dim=-1)
    return logits, top_idx, top_w


# The every-expert form's (E, T, max(d, f)) intermediates may take at
# most this many bytes; past it the grouped form runs (moe_form)
MOE_EVERY_EXPERT_BYTES = 1 << 30


def moe_form(cfg: ArchConfig, t: int, itemsize: int = 4) -> str:
    """The MoE form for ``t`` tokens, from shapes alone: ``"every"`` (every
    expert on every token) while its (E, T, max(d, f)) intermediates fit
    ``MOE_EVERY_EXPERT_BYTES``, else ``"grouped"``. Every decode step of
    the served models is every-expert (deepseek-v3 at 8 slots: 59 MB), and
    so is granite-moe's prefill (40 x 1000 x 1536 fp32: 246 MB), where
    every-expert measured faster on the card; deepseek-v3's prefill past
    146 tokens (256 experts x 7168 wide: 7.3 GB at 1000) is grouped."""
    mo = cfg.moe
    width = max(cfg.d_model, mo.d_ff_expert)
    fits = mo.e_total * t * width * itemsize <= MOE_EVERY_EXPERT_BYTES
    return "every" if fits else "grouped"


def _moe_every(p: Params, xf: torch.Tensor, top_idx, top_w,
               cfg: ArchConfig) -> torch.Tensor:
    """Every token through every expert as one batched product a weight,
    combined with the routing weights (zero for the experts a token did
    not select). Nothing is read back to the host, and each expert's
    weights are read once a call; a token's experts are summed in expert
    order (the reference: top-k order), within fp32 rounding of it."""
    mo = cfg.moe
    act = activation_fn(cfg.activation)
    t = xf.shape[0]
    xe = xf.expand(mo.e_total, t, cfg.d_model)               # (E, T, D)
    h = torch.bmm(xe, p["wi"].to(xf.dtype))                 # (E, T, F)
    h = gated(act, h, torch.bmm(xe, p["wg"].to(xf.dtype)) if "wg" in p
              else None)
    ys = torch.bmm(h, p["wo"].to(xf.dtype))                  # (E, T, D)
    comb = torch.zeros((t, mo.e_total), dtype=ys.dtype, device=xf.device)
    comb.scatter_(1, top_idx, top_w.to(ys.dtype))
    return torch.einsum("te,etd->td", comb, ys)


def _moe_grouped(p: Params, xf: torch.Tensor, top_idx, top_w,
                 cfg: ArchConfig) -> torch.Tensor:
    """The reference's sort-and-group: the (token, expert) pairs stably
    sorted by expert, one product per expert over its group, and the
    top-k-order combine. The group sizes are read back to the host once
    (no torch op takes a grouped fp32 product from device-side group
    offsets); empty groups launch nothing."""
    mo = cfg.moe
    act = activation_fn(cfg.activation)
    t = xf.shape[0]
    flat_ids = top_idx.reshape(-1)                           # (T*k,)
    order = torch.argsort(flat_ids, stable=True)
    xs = xf[order // mo.top_k]                               # by expert
    sizes = torch.bincount(flat_ids, minlength=mo.e_total).tolist()
    ys = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            seg = xs[start:start + n]
            h = seg @ p["wi"][e].to(xs.dtype)
            h = gated(act, h, seg @ p["wg"][e].to(xs.dtype) if "wg" in p
                      else None)
            ys[start:start + n] = h @ p["wo"][e].to(xs.dtype)
        start += n
    inv = torch.argsort(order)
    ys = ys[inv] * top_w.reshape(-1, 1).to(ys.dtype)
    return ys.reshape(t, mo.top_k, cfg.d_model).sum(dim=1)


def apply_moe(p: Params, x: torch.Tensor, cfg: ArchConfig):
    """Dropless top-k MoE: no capacity, no dropped token. Returns
    (out, aux), the Switch-style load-balance loss (zero under aux-free
    routing), as the reference's does.

    The form is ``moe_form``'s for the token count: every expert on every
    token with zero combine weights for the unselected ones, reading
    nothing back to the host, so the decode step never waits; or each
    expert on its own tokens, the reference's form, with one host read of
    the group sizes."""
    orig_shape = x.shape
    xf = x.reshape(-1, cfg.d_model)
    logits, top_idx, top_w = _moe_route(p, xf, cfg)
    if moe_form(cfg, xf.shape[0], xf.element_size()) == "every":
        out = _moe_every(p, xf, top_idx, top_w, cfg)
    else:
        out = _moe_grouped(p, xf, top_idx, top_w, cfg)
    mo = cfg.moe
    if "shared" in p:
        out = out + apply_mlp(p["shared"], xf, cfg)

    # Switch-style load-balance aux loss (skipped for aux-free routing).
    if mo.router_aux_free:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        probs = torch.softmax(logits, -1)
        flat_ids = top_idx.reshape(-1)
        counts = torch.zeros((mo.e_total,), dtype=torch.float32,
                             device=x.device).index_add_(
            0, flat_ids, torch.ones_like(flat_ids, dtype=torch.float32))
        aux = mo.n_experts * torch.sum(
            (counts / counts.sum().clamp(min=1.0)) * probs.mean(0))
    return out.reshape(orig_shape), aux


# ---------------------------------------------------------------------------
# Embeddings / output head
# ---------------------------------------------------------------------------
def init_embeddings(gen: torch.Generator, cfg: ArchConfig) -> Params:
    k_cb = cfg.n_codebooks
    shape = ((k_cb, cfg.vocab_size, cfg.d_model) if k_cb > 1
             else (cfg.vocab_size, cfg.d_model))
    p: Params = {"tokens": normal(gen, shape, 0.02)}
    if not cfg.tie_embeddings:
        hshape = ((k_cb, cfg.d_model, cfg.vocab_size) if k_cb > 1
                  else (cfg.d_model, cfg.vocab_size))
        p["lm_head"] = normal(gen, hshape, 0.02)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor, cfg: ArchConfig,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """tokens: (B, S) or (B, S, K) for multi-codebook archs."""
    emb = p["tokens"].to(dtype)
    tokens = tokens.long()
    if cfg.n_codebooks > 1:
        # sum the K codebook embeddings (musicgen)
        out = 0.0
        for k in range(cfg.n_codebooks):
            out = out + F.embedding(tokens[..., k], emb[k])
    else:
        # a lookup op (not indexing), so a table sharded on its vocab stays
        # sharded under DTensor
        out = F.embedding(tokens, emb)
    if cfg.post_norms or cfg.activation == "gelu_tanh":
        # gemma normalizes embeddings by sqrt(d_model)
        if cfg.name.startswith("gemma"):
            # the factor rounded to the compute dtype first, as the reference
            # does; a Python float keeps the op free of host tensors
            out = out * float(torch.tensor(math.sqrt(cfg.d_model),
                                           dtype=dtype))
    return out


def lm_logits(p: Params, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """h: (..., D) -> logits (..., V) or (..., K, V)."""
    if cfg.tie_embeddings:
        table = p["tokens"].to(h.dtype)
        if cfg.n_codebooks > 1:
            out = torch.einsum("...d,kvd->...kv", h, table)
        else:
            out = h @ table.T
    else:
        head = p["lm_head"].to(h.dtype)
        if cfg.n_codebooks > 1:
            out = torch.einsum("...d,kdv->...kv", h, head)
        else:
            out = h @ head
    return softcap(out, cfg.final_logit_softcap)
