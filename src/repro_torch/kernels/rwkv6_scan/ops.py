"""Public entry of the RWKV-6 chunked-scan kernel.

Port of ``repro/kernels/rwkv6_scan/ops.py``, as re-exports: ``rwkv6_scan``
is the kernel wrapper (kernel.py), which launches the CUDA kernel on the
card and runs the plain chunked version on the CPU; ``rwkv6_scan_reference``
is the step-by-step oracle. The reference's ``rwkv6_scan`` starts from
zeros; here ``s0`` may carry a state in."""
from repro_torch.kernels.rwkv6_scan.kernel import (  # noqa: F401
    rwkv6_scan_fwd as rwkv6_scan)
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: F401
    rwkv6_scan_ref as rwkv6_scan_reference)
