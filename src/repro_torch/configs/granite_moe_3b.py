"""granite-moe-3b-a800m [moe] — 40 experts, top-8 routing.

32L d_model=1536 24H (GQA kv=8, head_dim=64) d_ff_expert=512 vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base scaled per assignment; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, ATTN_GLOBAL

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    layer_pattern=(ATTN_GLOBAL,),
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
    activation="silu",
    gated_mlp=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
