"""Token sources and the prefetcher (port of ``repro/data``)."""
from repro_torch.data.pipeline import (  # noqa: F401
    MemmapLM, Prefetcher, SyntheticLM)
