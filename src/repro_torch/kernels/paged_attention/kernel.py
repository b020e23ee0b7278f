"""``paged_attention``: wrappers of the hand-written CUDA decode kernel.

Port of ``repro/kernels/paged_attention/kernel.py``; the kernel lives in
``csrc/paged_attention.cu`` (the source note there gives its bound and
design), built at first use by ``kernels/_build.py``. Both entries of the
reference launch the one kernel:

- ``paged_attention_fwd``: split K/V pools ``(E, page, KV, hd)``;
- ``paged_attention_pool_fwd``: planes ``k_plane``/``v_plane`` of ONE
  engine extent pool ``(E, page, n_planes, KV, hd)`` — the zero-copy
  serving path, which reads the KV cache straight out of the block
  device's pool through the volume's extent map.

Each wrapper checks dtype, shape, device and contiguity, then launches the
kernel for tensors on a CUDA device or calls the plain version (ref.py)
for tensors on the CPU; a CUDA tensor gets the kernel or an error, never
the plain version. ``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS``
the wrappers' calls of the plain version. Both compute in fp32.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.kernels._build import check_tensor, library, raise_on
from repro_torch.kernels.paged_attention.ref import (paged_attention_pool_ref,
                                                     paged_attention_ref)

LAUNCHES: Dict[str, int] = {"paged_attention": 0}
PLAIN_CALLS: Dict[str, int] = {"paged_attention": 0}
F32, I32 = torch.float32, torch.int32


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


def _check_common(q, block_table, lengths, kv: int, dev) -> None:
    b, h, _d = q.shape
    check_tensor("q", q, F32, q.shape, dev)
    check_tensor("block_table", block_table, I32, (b, block_table.shape[1]),
                 dev)
    check_tensor("lengths", lengths, I32, (b,), dev)
    if kv <= 0 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")


def _launch(q, k_ptr: int, v_ptr: int, block_table, lengths, *, kv, dv,
            page, n_rows, k_row, k_tok, v_row, v_tok, window, logit_cap,
            scale):
    b, h, d = q.shape
    out = torch.empty((b, h, dv), dtype=F32, device=q.device)
    lib = library("paged_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention(
            q.data_ptr(), k_ptr, v_ptr, block_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), b, h, kv, d, dv,
            block_table.shape[1], page, n_rows, k_row, k_tok, v_row, v_tok,
            int(window or 0), float(scale), float(logit_cap or 0.0), stream)
    raise_on(err, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out


def paged_attention_fwd(q, pool_k, pool_v, block_table, lengths, *,
                        window=0, logit_cap=0.0, scale=None):
    """q: (B,H,hd); pools: (E,page,KV,hd_{k,v}); block_table: (B,P) int32;
    lengths: (B,) int32. Hole pages (extent -1) are skipped. Returns
    (B,H,hd_v) fp32."""
    e, page, kv, dk = pool_k.shape
    dv = pool_v.shape[-1]
    dev = q.device
    _check_common(q, block_table, lengths, kv, dev)
    if q.shape[-1] != dk:
        raise ValueError(f"q head dim {q.shape[-1]} != pool_k's {dk}")
    check_tensor("pool_k", pool_k, F32, (e, page, kv, dk), dev)
    check_tensor("pool_v", pool_v, F32, (e, page, kv, dv), dev)
    if dev.type == "cpu":
        PLAIN_CALLS["paged_attention"] += 1
        return paged_attention_ref(q, pool_k, pool_v, block_table, lengths,
                                   window=window, logit_cap=logit_cap,
                                   scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {dev}")
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    return _launch(q, pool_k.data_ptr(), pool_v.data_ptr(), block_table,
                   lengths, kv=kv, dv=dv, page=page, n_rows=e,
                   k_row=page * kv * dk, k_tok=kv * dk, v_row=page * kv * dv,
                   v_tok=kv * dv, window=window, logit_cap=logit_cap,
                   scale=scale)


def paged_attention_pool_fwd(q, pool, block_table, lengths, *, k_plane,
                             v_plane, window=0, logit_cap=0.0, scale=None):
    """Zero-copy variant: attend straight out of ONE engine extent pool.

    q: (B,H,hd); pool: (E, page, n_planes, KV, hd) — the fused engine's
    payload pool, where plane ``2*l`` holds paged layer l's keys and
    ``2*l+1`` its values (serving/engine.py); block_table: (B,P) rows of
    the volume extent map (holes -1); lengths: (B,). The kernel reads the
    two planes in place through strides: no staging copy of the KV cache."""
    e, page, n_planes, kv, d = pool.shape
    dev = q.device
    _check_common(q, block_table, lengths, kv, dev)
    if q.shape[-1] != d:
        raise ValueError(f"q head dim {q.shape[-1]} != the pool's {d}")
    check_tensor("pool", pool, F32, (e, page, n_planes, kv, d), dev)
    if not (0 <= k_plane < n_planes and 0 <= v_plane < n_planes):
        raise ValueError(f"planes ({k_plane}, {v_plane}) outside "
                         f"[0, {n_planes})")
    if dev.type == "cpu":
        PLAIN_CALLS["paged_attention"] += 1
        return paged_attention_pool_ref(q, pool, block_table, lengths,
                                        k_plane=k_plane, v_plane=v_plane,
                                        window=window, logit_cap=logit_cap,
                                        scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {dev}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    plane = kv * d                       # elements per plane of one token
    item = pool.element_size()
    tok = n_planes * plane
    return _launch(q, pool.data_ptr() + k_plane * plane * item,
                   pool.data_ptr() + v_plane * plane * item, block_table,
                   lengths, kv=kv, dv=d, page=page, n_rows=e,
                   k_row=page * tok, k_tok=tok, v_row=page * tok, v_tok=tok,
                   window=window, logit_cap=logit_cap, scale=scale)
