"""Public entries of the paged decode attention kernel.

Port of ``repro/kernels/paged_attention/ops.py``. PyTorch runs eagerly, so
the ``jit`` wrappers of the reference become plain calls of the kernel
wrappers (kernel.py), which launch the CUDA kernel on the card and run the
plain version on the CPU."""
from __future__ import annotations

from repro_torch.kernels.paged_attention.kernel import (
    paged_attention_fwd, paged_attention_pool_fwd)
from repro_torch.kernels.paged_attention.ref import (paged_attention_pool_ref,
                                                     paged_attention_ref)


def paged_attention(q, pool_k, pool_v, block_table, lengths, *, window=0,
                    logit_cap=0.0, scale=None):
    """q: (B,H,hd) one decode token per sequence; pools (E,page,KV,hd);
    block_table (B,P) extent ids (holes -1); lengths (B,).
    Returns (B,H,hd_v)."""
    return paged_attention_fwd(q, pool_k, pool_v, block_table, lengths,
                               window=window, logit_cap=logit_cap,
                               scale=scale)


def paged_attention_pool(q, pool, block_table, lengths, *, k_plane, v_plane,
                         window=0, logit_cap=0.0, scale=None):
    """Zero-copy serving entry: attend over two planes of ONE engine extent
    pool (E, page, n_planes, KV, hd) through the volume extent map."""
    return paged_attention_pool_fwd(q, pool, block_table, lengths,
                                    k_plane=k_plane, v_plane=v_plane,
                                    window=window, logit_cap=logit_cap,
                                    scale=scale)


paged_attention_reference = paged_attention_ref
paged_attention_pool_reference = paged_attention_pool_ref
