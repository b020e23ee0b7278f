"""Config registry: ``get_config("<arch>")`` and reduced smoke variants.

Port of ``repro/configs/__init__.py``: the same registry and the same
``smoke_config`` reductions, so both packages build equal configs."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    ArchConfig, ExecutionPlan, MLAConfig, MoEConfig, SSMConfig, ShapeSpec,
    SHAPES, ATTN_GLOBAL, ATTN_LOCAL, ATTN_MLA, ATTN_HYBRID, ATTN_RWKV,
    MLP_DENSE, MLP_MOE, default_plan, model_flops, shape_applicable,
)

from repro_torch.configs import (
    gemma2_2b, gemma3_27b, granite_3_8b, starcoder2_15b, chameleon_34b,
    hymba_1_5b, granite_moe_3b, deepseek_v3_671b, musicgen_large, rwkv6_3b,
)

_REGISTRY: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        gemma2_2b, gemma3_27b, granite_3_8b, starcoder2_15b, chameleon_34b,
        hymba_1_5b, granite_moe_3b, deepseek_v3_671b, musicgen_large, rwkv6_3b,
    )
}

ALL_ARCHS: List[str] = sorted(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {ALL_ARCHS}") from None


def register(cfg: ArchConfig) -> None:
    _REGISTRY[cfg.name] = cfg


def smoke_config(name: str, *, n_layers: int = None, d_model: int = None,
                 vocab: int = 512) -> ArchConfig:
    """A reduced same-family config for CPU smoke tests.

    Keeps the structural features (layer pattern, GQA ratio, MoE/MLA/SSM,
    softcaps, codebooks) while shrinking width/depth/vocab/experts.
    """
    cfg = get_config(name)
    hd = 16
    heads = max(2, cfg.n_heads // 8)
    kv = max(1, round(heads * cfg.n_kv_heads / cfg.n_heads))
    while heads % kv:
        kv -= 1
    d = d_model or hd * heads
    changes = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers or max(2, 2 * len(cfg.layer_pattern) if len(cfg.layer_pattern) <= 3 else len(cfg.layer_pattern)),
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=hd,
        d_ff=4 * d,
        vocab_size=vocab,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        page_blocks=8,
    )
    nl = changes["n_layers"]
    if cfg.global_layer_indices:
        changes["global_layer_indices"] = tuple(
            i for i in cfg.global_layer_indices if i < nl) or (0,)
    if cfg.moe is not None:
        changes["moe"] = MoEConfig(
            n_experts=4, top_k=2, d_ff_expert=2 * d,
            n_shared=min(cfg.moe.n_shared, 1),
            d_ff_shared=2 * d if cfg.moe.n_shared else 0,
            router_aux_free=cfg.moe.router_aux_free)
        changes["n_dense_layers"] = 1 if cfg.n_dense_layers else 0
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                   rope_head_dim=8, nope_head_dim=16,
                                   v_head_dim=16)
        changes["head_dim"] = 16
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, state_dim=4, expand=2,
                                             rwkv_head_dim=hd)
        if cfg.name.startswith("rwkv"):
            changes["n_heads"] = changes["n_kv_heads"] = d // hd
    if cfg.mtp_depth:
        changes["mtp_depth"] = 1
    return dataclasses.replace(cfg, **changes)
