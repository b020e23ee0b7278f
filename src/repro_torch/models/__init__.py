"""The model zoo of the port: layers (dense MLPs and dropless MoE),
attention, the recurrent mixers (Mamba and RWKV-6, ``ssm``), blocks
(global, local, MLA, hybrid and RWKV layers) and the model (``forward``,
prefill, decode, deepseek-v3's MTP head ``mtp_hidden``; multi-codebook
embeddings and heads for musicgen)."""
from repro_torch.models.model import (decode_step,  # noqa: F401
                                      default_block_tables, forward,
                                      init_cache, init_params, mtp_hidden,
                                      param_count_actual, prefill,
                                      with_block_tables)
