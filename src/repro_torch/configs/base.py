"""Architecture/config system.

Port of ``repro/configs/base.py``, copied as data. Every architecture is
described by an :class:`ArchConfig` — a frozen dataclass consumed by the
model zoo (``repro_torch.models``) and the serving engine. Configs are
*data*: no torch imports here, so importing a config never touches device
state. The one difference from the reference: ``ExecutionPlan.attn_impl``
names the hand-written flash-attention kernel ``"cuda"`` where the
reference says ``"pallas"``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Layer kinds (the per-layer pattern lets us express alternating stacks such
# as gemma2 local/global, hymba's hybrid heads or deepseek's dense->MoE split).
# ---------------------------------------------------------------------------
ATTN_GLOBAL = "global"        # full causal attention
ATTN_LOCAL = "local"          # sliding-window causal attention
ATTN_MLA = "mla"              # DeepSeek multi-head latent attention
ATTN_HYBRID = "hybrid"        # parallel attention + mamba heads (hymba)
ATTN_RWKV = "rwkv6"           # attention-free RWKV-6 token mixer
MLP_DENSE = "dense"
MLP_MOE = "moe"


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    router_aux_free: bool = False   # deepseek-v3 aux-loss-free bias routing
    n_experts_padded: int = 0       # pad expert dim for even EP (§Perf B2)

    @property
    def e_total(self) -> int:
        return max(self.n_experts_padded, self.n_experts)


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style SSM branch (hymba) or RWKV-6 channel config."""
    state_dim: int = 16
    conv_kernel: int = 4
    expand: int = 2
    rwkv_head_dim: int = 64


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # attention details -----------------------------------------------------
    layer_pattern: Tuple[str, ...] = (ATTN_GLOBAL,)   # cycled over layers
    sliding_window: int = 0          # window for ATTN_LOCAL layers
    attn_logit_softcap: float = 0.0  # gemma2-style tanh soft capping
    final_logit_softcap: float = 0.0
    qk_norm: bool = False            # chameleon / gemma3
    post_norms: bool = False         # gemma2/3: extra post-attn / post-ffn norms
    rope_theta: float = 10_000.0
    # MLP / MoE --------------------------------------------------------------
    mlp_pattern: Tuple[str, ...] = (MLP_DENSE,)
    global_layer_indices: Tuple[int, ...] = ()  # hybrid archs: full-attn layers
    n_dense_layers: int = 0          # leading dense layers before MoE (deepseek: 3)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    activation: str = "silu"         # silu | gelu_tanh
    gated_mlp: bool = True
    # embeddings / output ----------------------------------------------------
    tie_embeddings: bool = True
    n_codebooks: int = 1             # musicgen: parallel EnCodec codebooks
    modality_stub: str = ""          # "audio_frames" | "vq_image" | ""
    mtp_depth: int = 0               # deepseek multi-token-prediction heads
    norm_eps: float = 1e-6
    # serving ----------------------------------------------------------------
    page_blocks: int = 32            # tokens per DBS extent (paper: 32 blocks/extent)

    # ------------------------------------------------------------------ utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def mlp_kind(self, i: int) -> str:
        if self.moe is not None and i >= self.n_dense_layers:
            return MLP_MOE
        return MLP_DENSE

    @property
    def attention_free(self) -> bool:
        return all(k == ATTN_RWKV for k in self.layer_pattern)

    @property
    def subquadratic(self) -> bool:
        """True if no layer keeps an unbounded full-attention KV cache."""
        return all(k in (ATTN_RWKV, ATTN_LOCAL) for k in self.layer_pattern)

    @property
    def long_context_capable(self) -> bool:
        """Eligible for the 524k decode shape: only a bounded-state or a small
        fraction of global layers (see DESIGN.md §Arch-applicability)."""
        if self.subquadratic:
            return True
        kinds = [self.layer_kind(i) for i in range(self.n_layers)]
        frac_global = sum(k in (ATTN_GLOBAL, ATTN_MLA) for k in kinds) / len(kinds)
        return frac_global <= 0.5 and self.sliding_window > 0

    # -------------------------------------------------------- parameter count
    def param_count(self) -> int:
        """Exact-ish parameter count (embeddings + per-layer weights)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_embed = self.vocab_size * d * self.n_codebooks
        if not self.tie_embeddings:
            n_embed += self.vocab_size * d * self.n_codebooks
        total = n_embed + d  # final norm
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == ATTN_RWKV:
                # rwkv6: r,k,v,g,o (d*d) + decay/low-rank mixers (small)
                attn = 5 * d * d + 6 * d * 32 * 2 + d * hd
            elif kind == ATTN_MLA:
                m = self.mla or MLAConfig()
                qh = self.n_heads * (m.nope_head_dim + m.rope_head_dim)
                attn = (d * m.q_lora_rank + m.q_lora_rank * qh
                        + d * (m.kv_lora_rank + m.rope_head_dim)
                        + m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim)
                        + self.n_heads * m.v_head_dim * d)
            else:
                attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                        + self.n_heads * hd * d)
                if kind == ATTN_HYBRID and self.ssm is not None:
                    e = self.ssm.expand * d
                    attn += d * 2 * e + e * self.ssm.conv_kernel + e * 2 * self.ssm.state_dim + e + e * d
            if self.mlp_kind(i) == MLP_MOE:
                mo = self.moe
                per = (3 if self.gated_mlp else 2) * d * mo.d_ff_expert
                mlp = mo.n_experts * per + d * mo.n_experts
                if mo.n_shared:
                    mlp += mo.n_shared * (3 if self.gated_mlp else 2) * d * mo.d_ff_shared
            else:
                mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
            total += attn + mlp + 2 * d  # two norms
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        mo = self.moe
        n_moe_layers = self.n_layers - self.n_dense_layers
        per = (3 if self.gated_mlp else 2) * self.d_model * mo.d_ff_expert
        inactive = n_moe_layers * (mo.n_experts - mo.top_k) * per
        return int(full - inactive)


# ---------------------------------------------------------------------------
# Input shapes (assigned): every arch is paired with all four.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.long_context_capable:
        return False, ("pure full-attention arch: 524k decode KV would be "
                       "unbounded-quadratic; skipped per assignment brief "
                       "(see DESIGN.md §Arch-applicability)")
    return True, ""


# ---------------------------------------------------------------------------
# Execution plan: how a given (arch, shape) runs on a mesh. The planner uses
# it to pick microbatching, remat, optimizer and sharding strategy.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ExecutionPlan:
    microbatches: int = 1            # gradient-accumulation steps (scan)
    remat: str = "none"              # none | block | full
    optimizer: str = "adamw"         # adamw | adafactor
    fsdp: bool = False               # shard params/opt state over "data" too
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    logits_chunk: int = 0            # chunked cross-entropy chunk (0 = auto)
    scan_layers: bool = True
    attn_impl: str = "chunked"       # chunked | dense | cuda
    kv_cache_kind: str = "paged"     # paged | dense (serve path)
    attn_chunk: int = 1024           # flash KV/Q chunk size
    ssm_chunk: int = 256             # mamba/rwkv chunk length
    unroll_scans: bool = False       # accounting variant: no while loops
    paged_stripe_slice: bool = True  # gather only owned page stripes (§Perf A2)
    constrain_activations: bool = False  # pin residual-stream sharding (§Perf C2)
    moe_pad_to: int = 0              # pad experts to a multiple (§Perf B2)
    unstack_params: bool = False     # per-layer weights for decode (§Perf A4)


def default_plan(cfg: ArchConfig, shape: ShapeSpec, n_chips: int = 256,
                 data_shards: int = 0) -> ExecutionPlan:
    params = cfg.param_count()
    big = params > 6e9            # needs FSDP + bf16 compute at scale
    huge = params > 60e9          # needs adafactor + bf16 params
    if shape.kind == "train":
        # microbatch down to per-data-shard batch 1 (activation fit for the
        # big configs); per-microbatch global batch stays shardable.
        ds = data_shards or max(1, n_chips // 16)
        micro = max(1, shape.global_batch // ds)
        return ExecutionPlan(
            microbatches=micro,
            remat="block",
            optimizer="adafactor" if huge else "adamw",
            fsdp=big,
            param_dtype="bfloat16" if huge else "float32",
            logits_chunk=1024 if cfg.vocab_size > 64_000 else 0,
        )
    # serve plans: bf16 weights; >25B params additionally shard over "data"
    # (pure TP leaves e.g. deepseek's experts at 84 GB/device — the memory
    # table in EXPERIMENTS.md §Dry-run is what catches this class of bug)
    return ExecutionPlan(
        microbatches=1, remat="none", optimizer="adamw", fsdp=params > 25e9,
        param_dtype="bfloat16",
        logits_chunk=0,
    )


def model_flops(cfg: ArchConfig, tokens: int) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) per the brief."""
    return 6.0 * cfg.active_param_count() * tokens
