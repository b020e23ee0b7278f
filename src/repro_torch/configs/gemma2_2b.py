"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000
[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ArchConfig, ATTN_LOCAL, ATTN_GLOBAL

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    layer_pattern=(ATTN_LOCAL, ATTN_GLOBAL),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_norms=True,
    activation="gelu_tanh",
    gated_mlp=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
