"""Serving on the engine layers: ``ServeEngine`` with the KV cache in the
DBS extent pools (``kv_backend="fused"``) or in model-owned pools behind the
host backend's control plane (``kv_backend="host"``, the copy-based
baseline), and ``ServePool``, engines stepped together as shards."""
from repro_torch.serving.engine import (GenRequest, ServeEngine,  # noqa: F401
                                        ServePool)
