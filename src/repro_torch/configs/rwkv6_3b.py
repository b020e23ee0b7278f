"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay.

32L d_model=2560 (40 heads x 64) d_ff=8960 vocab=65536 [arXiv:2404.05892; hf]

The paper's block-store technique targets KV caches; RWKV-6 is attention-free
(O(1) recurrent state), so the paged-KV path is inapplicable to its compute —
recorded in DESIGN.md §Arch-applicability. The arch still runs everywhere
(train/prefill/decode/long_500k) with its recurrent state, and its states are
checkpointed through DBS volumes.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, ATTN_RWKV

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65_536,
    layer_pattern=(ATTN_RWKV,),
    ssm=SSMConfig(rwkv_head_dim=64),
    activation="silu",     # rwkv channel-mix uses relu^2; set in layer code
    gated_mlp=False,
    tie_embeddings=False,
    rope_theta=0.0,
)
