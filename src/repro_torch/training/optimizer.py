"""Optimizers (no external deps): AdamW and Adafactor, schedules, clipping.

Port of ``repro/training/optimizer.py`` as plain functions on trees of
tensors (nested dicts, lists and tuples), not ``torch.optim``: the
reference adds weight decay to every leaf inside the step and keeps its
moments and arithmetic in fp32, in an order this module follows op for op.

The update functions work in place, the port's counterpart of the
reference's buffer donation: ``update(grads, state, params)`` scales
``grads`` by the clip factor, steps ``state`` and ``params`` and returns
``(params, state, grad_norm)`` — the same objects. Call it under
``torch.no_grad()`` (the train step does). The step count and every
scalar of the schedule stay on the device as 0-d tensors, so a step reads
nothing back. AdamW walks the leaves in groups of at most
``GROUP_BYTES`` with ``torch._foreach_*`` ops, which bounds its
temporaries to two groups' worth.

Adafactor (factored second moments) is the reference's default for
>60B-param configs: its state is ~1 byte/param instead of AdamW's 8.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch

from repro_torch.models.model import (leaves_up_to,
                                      tree_leaves, tree_map)

Params = Any
GROUP_BYTES = 1 << 30
NORM_PIECE = 1 << 25             # elements a piece of global_norm's sums


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    def fn(step):
        step = step.float()
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return fn


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32. Each leaf is
    summed in pieces of at most ``NORM_PIECE`` elements by ``torch.sum``
    (pairwise on the CPU, a tree on the card), which holds a 590M-element
    embedding's sum to fp32's accuracy on both; a plain running fp32
    norm on the CPU drifts by ~1e-4 there. A DTensor leaf is summed
    whole: each rank sums its own shard and DTensor reduces the partial
    sums (flattening a sharded leaf would make DTensor plan the pieces
    over an index of every element)."""
    sums = [torch.sum(torch.square(piece.float()))
            for x in tree_leaves(tree)
            for piece in ((x,) if hasattr(x, "placements")
                          else x.reshape(-1).split(NORM_PIECE))]
    return torch.stack(sums).sum().sqrt()


def _clip_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns the norm before."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def clip_by_global_norm(tree, max_norm: float):
    """(a copy of ``tree`` scaled to a global norm of at most ``max_norm``,
    the norm before)."""
    out = tree_map(torch.clone, tree)
    return out, _clip_(tree_leaves(out), max_norm)


def _groups(leaves: List[torch.Tensor]) -> Iterator[List[int]]:
    """Indices of consecutive leaves, at most ``GROUP_BYTES`` a group (a
    larger leaf alone)."""
    group: List[int] = []
    size = 0
    for i, x in enumerate(leaves):
        n = x.numel() * 4
        if group and size + n > GROUP_BYTES:
            yield group
            group, size = [], 0
        group.append(i)
        size += n
    if group:
        yield group


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0


def adamw_init(params: Params) -> Dict[str, Any]:
    def zeros(p):
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                        p)
    dev = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(cfg: AdamWConfig, grads, state, params):
    gs = leaves_up_to(params, grads)
    ms = leaves_up_to(params, state["m"])
    vs = leaves_up_to(params, state["v"])
    ps = tree_leaves(params)
    gnorm = _clip_(gs, cfg.max_grad_norm)
    count = state["count"]
    count.add_(1)
    lr = warmup_cosine(cfg.lr, cfg.warmup, cfg.total_steps)(count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    for idx in _groups(ps):
        g = [gs[i].float() for i in idx]
        m = [ms[i] for i in idx]
        v = [vs[i] for i in idx]
        p = [ps[i] for i in idx]
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, g, alpha=1 - cfg.b1)
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
        step = torch._foreach_div(m, b1c)
        den = torch._foreach_div(v, b2c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        torch._foreach_div_(step, den)
        del den
        p32 = [x.float() for x in p]
        torch._foreach_add_(step, p32, alpha=cfg.weight_decay)
        torch._foreach_mul_(step, lr)
        if all(x.dtype == torch.float32 for x in p):
            torch._foreach_sub_(p, step)
        else:
            for x, new in zip(p, torch._foreach_sub(p32, step)):
                x.copy_(new)
    return params, state, gnorm


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8          # t^-decay second-moment decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    warmup: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params: Params) -> Dict[str, Any]:
    def st(x):
        f32 = dict(dtype=torch.float32, device=x.device)
        if _factored(x.shape):
            return {"vr": torch.zeros(x.shape[:-1], **f32),
                    "vc": torch.zeros(x.shape[:-2] + x.shape[-1:], **f32)}
        return {"v": torch.zeros(x.shape, **f32)}
    dev = tree_leaves(params)[0].device
    return {"slots": tree_map(st, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adafactor_update(cfg: AdafactorConfig, grads, state, params):
    gs = leaves_up_to(params, grads)
    slots = leaves_up_to(params, state["slots"])
    ps = tree_leaves(params)
    gnorm = _clip_(gs, cfg.max_grad_norm)
    count = state["count"]
    count.add_(1)
    t = count.float()
    beta = 1.0 - t ** (-cfg.decay)
    lr = warmup_cosine(cfg.lr, cfg.warmup, cfg.total_steps)(count)
    for g, slot, p in zip(gs, slots, ps):
        g32 = g.float()
        g2 = torch.square(g32) + cfg.eps
        if "vr" in slot:
            vr = beta * slot["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
            vc = beta * slot["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                min=cfg.eps)
            vhat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            slot["vr"].copy_(vr)
            slot["vc"].copy_(vc)
        else:
            vhat = beta * slot["v"] + (1 - beta) * g2
            slot["v"].copy_(vhat)
        u = g32 * torch.rsqrt(vhat + cfg.eps)
        rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
        u = u / torch.clamp(rms_u / cfg.clip_threshold, min=1.0)
        p32 = p.float()
        if cfg.weight_decay:
            u = u + cfg.weight_decay * p32
        p.copy_(p32 - lr * u)
    return params, state, gnorm


# ---------------------------------------------------------------------------
# uniform facade
# ---------------------------------------------------------------------------
def make_optimizer(name: str, **overrides) -> Tuple[Callable, Callable]:
    """Returns (init_fn, update_fn(grads, state, params)); the update works
    in place (module note)."""
    if name == "adamw":
        return adamw_init, partial(adamw_update, AdamWConfig(**overrides))
    if name == "adafactor":
        return adafactor_init, partial(adafactor_update,
                                       AdafactorConfig(**overrides))
    raise ValueError(f"unknown optimizer {name!r}")
