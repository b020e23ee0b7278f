"""granite-3-8b [dense] — GQA decoder.

40L d_model=4096 32H (GQA kv=8, head_dim=128) d_ff=12800 vocab=49155
[hf:ibm-granite/granite-3.0-2b-base scaled per assignment; hf]
"""
from repro_torch.configs.base import ArchConfig, ATTN_GLOBAL

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49_155,
    layer_pattern=(ATTN_GLOBAL,),
    activation="silu",
    gated_mlp=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
