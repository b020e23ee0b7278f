"""Paged decode attention: the CUDA kernel (``csrc/paged_attention.cu``),
its wrappers and its plain version."""
from repro_torch.kernels.paged_attention.kernel import (  # noqa: F401
    LAUNCHES, PLAIN_CALLS, paged_attention_fwd, paged_attention_lse_fwd,
    paged_attention_pool_fwd)
from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    paged_attention, paged_attention_pool, paged_attention_pool_reference,
    paged_attention_reference)
from repro_torch.kernels.paged_attention.ref import (  # noqa: F401
    paged_attention_pool_ref, paged_attention_ref)
