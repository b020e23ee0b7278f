"""chameleon-34b [vlm] — early-fusion, VQ image tokens, QK-norm.

48L d_model=8192 64H (GQA kv=8, head_dim=128) d_ff=22016 vocab=65536
[arXiv:2405.09818; unverified]

The modality frontend is a STUB per the assignment: ``input_specs()`` provides
token ids over a unified text+VQ-image vocabulary (early fusion); the backbone
is a standard decoder with QK-norm (chameleon's training-stability fix).
"""
from repro_torch.configs.base import ArchConfig, ATTN_GLOBAL

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65_536,
    layer_pattern=(ATTN_GLOBAL,),
    qk_norm=True,
    activation="silu",
    gated_mlp=True,
    tie_embeddings=False,
    modality_stub="vq_image",
    rope_theta=10_000.0,
)
