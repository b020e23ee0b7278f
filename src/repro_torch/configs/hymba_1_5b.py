"""hymba-1.5b [hybrid] — parallel attention + mamba heads in every layer.

32L d_model=1600 25H (GQA kv=5, head_dim=64) d_ff=5504 vocab=32001 ssm_state=16
[arXiv:2411.13676; hf]

Hymba fuses a sliding-window attention branch and a Mamba (SSM) branch in the
same layer ("hybrid heads"); a few layers use global attention. We follow the
paper's 3-global-layer recipe (first/middle/last).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, ATTN_HYBRID

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    layer_pattern=(ATTN_HYBRID,),
    sliding_window=1024,
    global_layer_indices=(0, 15, 31),
    ssm=SSMConfig(state_dim=16, conv_kernel=4, expand=2),
    activation="silu",
    gated_mlp=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
)

# layer indices using global (full) attention instead of SWA, per Hymba.
GLOBAL_LAYERS = (0, 15, 31)
