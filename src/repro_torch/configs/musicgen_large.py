"""musicgen-large [audio] — decoder-only over EnCodec tokens (4 codebooks).

48L d_model=2048 32H (kv=32, head_dim=64) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf]

The EnCodec frontend is a STUB per the assignment: inputs are the 4 parallel
codebook token streams (delay pattern applied upstream); embeddings of the K
codebooks are summed, and the model has K parallel LM heads.
"""
from repro_torch.configs.base import ArchConfig, ATTN_GLOBAL

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    layer_pattern=(ATTN_GLOBAL,),
    activation="gelu_tanh",
    gated_mlp=False,
    tie_embeddings=False,
    n_codebooks=4,
    modality_stub="audio_frames",
    rope_theta=10_000.0,
)
