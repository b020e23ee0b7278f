"""State-space and linear-recurrence token mixers: Mamba (the hybrid
heads of hymba) and RWKV-6 (Finch).

Port of ``repro/models/ssm.py``. Both run in the chunked formulation:
chunks of tokens with an O(1) carried fp32 state.

Mamba: the JAX package has no Pallas kernel for it, so these plain torch
ops are the port. Within a chunk the recurrence ``h_t = decay_t * h_{t-1}
+ inp_t`` runs as a log-depth (Hillis-Steele) scan over the ``(B, C, E,
N)`` pair, combining the same terms as the reference's
``jax.lax.associative_scan`` (a cumsum of ``exp(-L)`` would overflow fp32
once a chunk's log decay passes -88; a loop over the chunk's tokens would
be C sequential steps). The state is a dict ``{"conv": (B, K-1, E),
"ssm": (B, E, N) fp32}`` (the reference's tuple ``(conv, ssm)``), so the
serving engine's per-slot helpers slice and copy it like any other cache.

RWKV-6: under ``impl="cuda"`` the recurrence goes through
``kernels/rwkv6_scan`` (the hand-written kernel on the card, its plain
chunked version on the CPU), starting from the carried state;
``impl="pallas"`` (the TPU kernel) raises, as the port's flash dispatch
does; any other ``impl`` runs the plain chunked version.

Both keep the reference's chunk rule, ``s // chunk`` equal chunks, so CPU
parity compares like with like. Where that rule leaves a remainder (the
reference's reshape then fails, e.g. 513 tokens at chunk 256), the port
takes a ragged last chunk.

The functions are pure, as the reference's are: each returns the new
state pieces, and ``blocks.apply_block`` copies them into the cache.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rwkv6_scan import kernel as scan_kernel
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_chunked_ref
from repro_torch.models.layers import Params, dense_init, normal

LORA_RANK = 32


def _chunk_len(s: int, chunk: int) -> int:
    """The reference's rule: ``s // chunk`` equal chunks (at least one).
    Where they do not divide ``s``, the port's last chunk is ragged."""
    return s // max(1, s // chunk)


# ===========================================================================
# Mamba branch (hymba hybrid heads)
# ===========================================================================
def init_mamba(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """One Mamba branch's parameters, drawn from ``gen`` on its device (the
    reference's names, shapes and draws)."""
    d = cfg.d_model
    e = cfg.ssm.expand * d
    n = cfg.ssm.state_dim
    kconv = cfg.ssm.conv_kernel
    dt_rank = max(16, d // 16)
    dev = gen.device
    return {
        "in_proj": dense_init(gen, d, 2 * e),
        "conv": normal(gen, (kconv, e), 1.0 / math.sqrt(kconv)),
        "w_bc": dense_init(gen, e, 2 * n),
        "w_dt1": dense_init(gen, e, dt_rank),
        "w_dt2": dense_init(gen, dt_rank, e),
        "dt_bias": torch.full((e,), -4.6, device=dev),   # softplus^-1(0.01)
        "a_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                        device=dev).repeat(e, 1)),
        "d_skip": torch.ones((e,), device=dev),
        "out_proj": dense_init(gen, e, d),
    }


def mamba_init_state(p: Params, batch: int, dtype=torch.bfloat16,
                     device=None) -> Dict[str, torch.Tensor]:
    e = p["in_proj"].shape[-1] // 2
    n = p["a_log"].shape[-1]
    kconv = p["conv"].shape[0]
    device = device if device is not None else p["in_proj"].device
    return {"conv": torch.zeros((batch, kconv - 1, e), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, e, n), dtype=torch.float32,
                               device=device)}


def _linear_scan(decay: torch.Tensor, inp: torch.Tensor):
    """Inclusive scan of ``h_t = decay_t * h_{t-1} + inp_t`` along dim 1
    from h = 0, in log2(C) passes: pass ``d`` folds element ``t - d`` into
    ``t`` with the reference's combine ``(a1 * a2, b1 * a2 + b2)``. Returns
    (the decays' running products, the running states). Without autograd
    both inputs are consumed (overwritten); when an input needs a gradient
    each pass builds new tensors of the same values instead, since autograd
    keeps the overwritten ones."""
    c = decay.shape[1]
    d = 1
    if _tracked(decay, inp):
        while d < c:
            folded = inp[:, d:] + inp[:, :-d] * decay[:, d:]
            inp = torch.cat([inp[:, :d], folded], dim=1)
            decay = torch.cat([decay[:, :d], decay[:, d:] * decay[:, :-d]],
                              dim=1)
            d *= 2
        return decay, inp
    while d < c:
        inp[:, d:] += inp[:, :-d] * decay[:, d:]
        decay[:, d:] = decay[:, d:] * decay[:, :-d]
        d *= 2
    return decay, inp


def _tracked(*tensors) -> bool:
    """Whether autograd records an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _mamba_inner(p: Params, xz: torch.Tensor, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor, chunk: int = 256):
    """The prefill/decode core. xz: (B,S,2E) pre-activation projections;
    conv_state: (B,K-1,E) trailing inputs; ssm_state: (B,E,N).
    Returns (y (B,S,E), conv_state', ssm_state')."""
    b, s, _ = xz.shape
    x, z = torch.chunk(xz, 2, dim=-1)
    e = x.shape[-1]

    # depthwise causal conv over time with the carried inputs
    kconv = p["conv"].shape[0]
    xin = torch.cat([conv_state.to(x.dtype), x], dim=1)        # (B,K-1+S,E)
    new_conv_state = xin[:, -(kconv - 1):] if kconv > 1 else conv_state
    w = p["conv"].to(x.dtype)
    xc = xin[:, 0:s] * w[0]
    for i in range(1, kconv):
        xc = xc + xin[:, i:i + s] * w[i]
    xc = F.silu(xc)

    bc = xc @ p["w_bc"].to(x.dtype)                            # (B,S,2N)
    b_t, c_t = torch.chunk(bc.float(), 2, dim=-1)
    dt = F.softplus((xc @ p["w_dt1"].to(x.dtype)) @ p["w_dt2"].to(x.dtype)
                    + p["dt_bias"].to(x.dtype)).float()        # (B,S,E)
    a = -torch.exp(p["a_log"].float())                         # (E,N)
    xf = xc.float()

    c = _chunk_len(s, chunk)
    h = ssm_state.float()
    ys = []
    for c0 in range(0, s, c):
        sl = slice(c0, min(c0 + c, s))
        dtb = dt[:, sl]
        decay = torch.exp(dtb[..., None] * a)                  # (B,C,E,N)
        inp = (dtb * xf[:, sl])[..., None] * b_t[:, sl, None, :]
        a_sc, b_sc = _linear_scan(decay, inp)
        if _tracked(a_sc, b_sc, h):
            hs = a_sc * h[:, None] + b_sc
        else:
            hs = a_sc.mul_(h[:, None]).add_(b_sc)              # (B,C,E,N)
        ys.append(torch.einsum("bcen,bcn->bce", hs, c_t[:, sl]))
        h = hs[:, -1]
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    y = y + xf * p["d_skip"]
    y = y * F.silu(z.float())
    return y.to(x.dtype), new_conv_state, h


def mamba_forward(p: Params, x: torch.Tensor,
                  state: Optional[Dict[str, torch.Tensor]] = None,
                  chunk: int = 256):
    """x: (B,S,D) -> (y (B,S,D), new state ``{"conv", "ssm"}``)."""
    if state is None:
        state = mamba_init_state(p, x.shape[0], x.dtype, x.device)
    xz = x @ p["in_proj"].to(x.dtype)
    y, cs, ss = _mamba_inner(p, xz, state["conv"], state["ssm"],
                             chunk=chunk)
    return y @ p["out_proj"].to(x.dtype), {"conv": cs, "ssm": ss}


def mamba_step(p: Params, x: torch.Tensor, state):
    """Single-token decode. x: (B,1,D)."""
    return mamba_forward(p, x, state, chunk=1)


# ===========================================================================
# RWKV-6 (Finch): data-dependent decay linear recurrence
# ===========================================================================


def _heads(cfg: ArchConfig) -> Tuple[int, int]:
    hd = cfg.ssm.rwkv_head_dim if cfg.ssm else 64
    return cfg.d_model // hd, hd


def init_rwkv6(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """One RWKV-6 layer's time- and channel-mix parameters, drawn from
    ``gen`` on its device (the reference's keys and shapes)."""
    d = cfg.d_model
    h, hd = _heads(cfg)
    dev = gen.device
    uniform = lambda shape: torch.rand(shape, generator=gen, device=dev)
    return {
        # time-mix
        "mu": uniform((5, d)),                                 # r,k,v,g,w
        "w_r": dense_init(gen, d, d),
        "w_k": dense_init(gen, d, d),
        "w_v": dense_init(gen, d, d),
        "w_g": dense_init(gen, d, d),
        "w_o": dense_init(gen, d, d),
        "w0": torch.full((d,), -6.0, device=dev),              # decay base
        "w_lora1": dense_init(gen, d, LORA_RANK),
        "w_lora2": dense_init(gen, LORA_RANK, d) * 0.1,
        "u": torch.randn((h, hd), generator=gen, device=dev) * 0.1,  # bonus
        "ln_x": torch.ones((d,), device=dev),                  # head norm
        # channel-mix
        "mu_c": uniform((2, d)),
        "c_k": dense_init(gen, d, cfg.d_ff),
        "c_v": dense_init(gen, cfg.d_ff, d),
        "c_r": dense_init(gen, d, d),
    }


def rwkv6_init_state(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    h, hd = _heads(cfg)
    return {
        "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                           device=device),
        "shift_t": torch.zeros((batch, d), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def rwkv6_time_mix(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
                   cfg: ArchConfig, chunk: int = 64, impl: str = "chunked"):
    """x: (B,S,D) -> (y, new state pieces ``wkv`` and ``shift_t``). Handles
    S == 1 (decode) too."""
    b, s, d = x.shape
    h, hd = _heads(cfg)
    x_prev = torch.cat([state["shift_t"][:, None].to(x.dtype), x[:, :-1]],
                       dim=1)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x * mu[i] + x_prev * (1 - mu[i]) for i in range(5))
    r = (xr @ p["w_r"].to(x.dtype)).reshape(b, s, h, hd).float()
    k = (xk @ p["w_k"].to(x.dtype)).reshape(b, s, h, hd).float()
    v = (xv @ p["w_v"].to(x.dtype)).reshape(b, s, h, hd).float()
    g = xg @ p["w_g"].to(x.dtype)
    logw = -torch.exp(
        p["w0"].float()
        + ((xw @ p["w_lora1"].to(x.dtype)) @ p["w_lora2"].to(x.dtype))
        .float()).reshape(b, s, h, hd)
    u = p["u"].float().contiguous()
    if impl == "cuda":
        y, s_out = scan_kernel.rwkv6_scan_fwd(r, k, v, logw, u,
                                              s0=state["wkv"])
    elif impl == "pallas":
        raise ValueError("attn_impl='pallas' is the TPU kernel; the port's "
                         "hand-written rwkv6_scan kernel is attn_impl='cuda'")
    else:
        # the reference's rule, s // chunk equal chunks (module note)
        y, s_out = rwkv6_chunked_ref(r, k, v, logw, u, state["wkv"],
                                     chunk=_chunk_len(s, chunk))
    # per-head group norm + gate + out proj
    y = y * torch.rsqrt(torch.mean(torch.square(y), -1, keepdim=True) + 1e-5)
    y = (y.reshape(b, s, d) * p["ln_x"]).to(x.dtype)
    y = y * F.silu(g)
    out = y @ p["w_o"].to(x.dtype)
    return out, {"wkv": s_out, "shift_t": x[:, -1]}


def rwkv6_channel_mix(p: Params, x: torch.Tensor,
                      state: Dict[str, torch.Tensor]):
    x_prev = torch.cat([state["shift_c"][:, None].to(x.dtype), x[:, :-1]],
                       dim=1)
    mu = p["mu_c"].to(x.dtype)
    xk = x * mu[0] + x_prev * (1 - mu[0])
    xr = x * mu[1] + x_prev * (1 - mu[1])
    k = torch.square(F.relu(xk @ p["c_k"].to(x.dtype)))
    v = k @ p["c_v"].to(x.dtype)
    r = torch.sigmoid(xr @ p["c_r"].to(x.dtype))
    return r * v, {"shift_c": x[:, -1]}
