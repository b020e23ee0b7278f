"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed experts top-8, MTP.

61L d_model=7168 128H (MLA) d_ff_expert=2048 vocab=129280, 3 leading dense
layers with d_ff=18432. [arXiv:2412.19437; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, MLAConfig, ATTN_MLA

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,   # MLA: all heads share the latent cache
    head_dim=128,
    d_ff=18432,       # dense layers / shared expert width basis
    vocab_size=129_280,
    layer_pattern=(ATTN_MLA,),
    n_dense_layers=3,
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared=1, d_ff_shared=2048, router_aux_free=True),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    activation="silu",
    gated_mlp=True,
    tie_embeddings=False,
    mtp_depth=1,
    rope_theta=10_000.0,
)
