"""The model zoo of the port: layers, attention, RWKV-6 (ssm), blocks and
the model (global and local attention with dense MLPs, and RWKV-6 layers;
the other layer kinds land with the models slice)."""
from repro_torch.models.model import (decode_step,  # noqa: F401
                                      default_block_tables, init_cache,
                                      init_params, param_count_actual,
                                      prefill, with_block_tables)
