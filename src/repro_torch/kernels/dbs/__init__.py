"""The DBS kernel package: the ``dbs_rw`` write and read kernels
(``csrc/dbs_rw.cu``) and the ``dbs_copy`` CoW extent-copy kernel
(``csrc/dbs_copy.cu``), CUDA C++, with their plain versions, the pool
wrappers and the kernel registry."""
from repro_torch.kernels.dbs.ops import (dbs_copy,  # noqa: F401
                                         dbs_copy_bytes, dbs_copy_pool,
                                         dbs_read_bytes, dbs_rw_read_pool,
                                         dbs_rw_write_pool, dbs_write_bytes)
from repro_torch.kernels.dbs.ref import (dbs_copy_ref,  # noqa: F401
                                         dbs_rw_read_ref, dbs_rw_write_ref)
from repro_torch.kernels.dbs.registry import (DBSKernel,  # noqa: F401
                                              available_kernels, make_kernel,
                                              register_kernel,
                                              resolve_kernel_name)
from repro_torch.kernels.dbs.rw_kernel import (LAUNCHES,  # noqa: F401
                                               PLAIN_CALLS, dbs_rw_read,
                                               dbs_rw_write)
