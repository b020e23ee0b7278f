"""RWKV-6 chunked recurrence: the CUDA kernel (``csrc/rwkv6_scan.cu``), its
wrapper and its plain versions."""
from repro_torch.kernels.rwkv6_scan.kernel import (  # noqa: F401
    LAUNCHES, PLAIN_CALLS, rwkv6_scan_fwd)
from repro_torch.kernels.rwkv6_scan.ops import (  # noqa: F401
    rwkv6_scan, rwkv6_scan_reference)
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: F401
    rwkv6_chunked_ref, rwkv6_scan_ref)
