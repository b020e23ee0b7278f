"""Linear-recurrence token mixers: RWKV-6 (Finch).

Port of the RWKV-6 half of ``repro/models/ssm.py`` (the Mamba half lands
with the hybrid slice of the port). The recurrence runs in the chunked
formulation: chunks of tokens with an O(1) carried fp32 state and
quadratic math within a chunk. Under ``impl="cuda"`` it goes through
``kernels/rwkv6_scan`` (the hand-written kernel on the card, its plain
chunked version on the CPU), starting from the carried state;
``impl="pallas"`` (the TPU kernel) raises, as the port's flash dispatch
does; any other ``impl`` runs the plain chunked version with the
reference's chunk rule, so CPU parity with the reference compares like
with like. Where that rule
leaves a remainder (the reference's reshape then fails, e.g. 513 tokens at
chunk 256), the port takes a ragged last chunk.

The functions are pure, as the reference's are: each returns the new
state pieces, and ``blocks.apply_block`` copies them into the cache.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rwkv6_scan import kernel as scan_kernel
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_chunked_ref
from repro_torch.models.layers import Params, dense_init

LORA_RANK = 32


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
                                     chunk=s // max(1, s // chunk))
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
