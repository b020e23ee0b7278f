"""Public model-layout entry of the flash-attention kernel.

Port of ``repro/kernels/flash_attention/ops.py``: layout adaptation around
the kernel wrapper (kernel.py), which launches the CUDA kernel on the card
and runs the plain version on the CPU."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, window=0,
                    logit_cap=0.0, scale=None):
    """Model-layout entry: q (B,S,H,hd); k,v (B,S,KV,hd) -> (B,S,H,hd).

    Positions are suffix-aligned (standard causal LM); q_pos/k_pos are
    accepted for API parity with the plain paths and ignored (they are
    always arange in prefill). The transposes are views: the kernel reads
    and writes the model layout through strides."""
    out = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, window=window,
                              logit_cap=logit_cap, scale=scale)
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_reference(q, k, v, *, window=0, logit_cap=0.0,
                              scale=None):
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True, window=window,
                        logit_cap=logit_cap, scale=scale)
    return out.transpose(1, 2).to(q.dtype)
