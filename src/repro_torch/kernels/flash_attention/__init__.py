"""Flash attention forward: the CUDA kernel (``csrc/flash_attention.cu``),
its wrapper and its plain version."""
from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    LAUNCHES, PLAIN_CALLS, flash_attention_fwd)
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention, flash_attention_reference)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: F401
