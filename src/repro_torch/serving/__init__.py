"""Serving on the engine layers: ``ServeEngine`` with the KV cache in the
DBS extent pools (``kv_backend="fused"``); ``ServePool`` lands with its
slice."""
from repro_torch.serving.engine import GenRequest, ServeEngine  # noqa: F401
