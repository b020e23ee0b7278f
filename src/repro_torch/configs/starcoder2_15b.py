"""starcoder2-15b [dense] — GQA, RoPE.

40L d_model=6144 48H (GQA kv=4, head_dim=128) d_ff=24576 vocab=49152
[arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ArchConfig, ATTN_GLOBAL

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49_152,
    layer_pattern=(ATTN_GLOBAL,),
    activation="gelu_tanh",
    gated_mlp=False,  # starcoder2 uses a plain (non-gated) MLP
    tie_embeddings=True,
    rope_theta=100_000.0,
)
