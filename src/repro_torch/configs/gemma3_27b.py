"""gemma3-27b [dense] — 5:1 local:global attention, 128k context, QK-norm.

62L d_model=5376 32H (GQA kv=16, head_dim=128) d_ff=21504 vocab=262144
[hf:google/gemma-3-1b-pt scaled per assignment; unverified]
"""
from repro_torch.configs.base import ArchConfig, ATTN_LOCAL, ATTN_GLOBAL

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    # gemma3: five local layers followed by one global layer
    layer_pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,),
    sliding_window=1024,
    qk_norm=True,
    post_norms=True,
    activation="gelu_tanh",
    gated_mlp=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
