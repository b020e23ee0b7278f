"""The model zoo of the port: layers (dense MLPs and dropless MoE),
attention, the recurrent mixers (Mamba and RWKV-6, ``ssm``), blocks
(global, local, hybrid and RWKV layers) and the model (``forward``,
prefill, decode). MLA, MTP and multi-codebook heads land with the next
models slice."""
from repro_torch.models.model import (decode_step,  # noqa: F401
                                      default_block_tables, forward,
                                      init_cache, init_params,
                                      param_count_actual, prefill,
                                      with_block_tables)
