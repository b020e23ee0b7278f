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
the plain version. ``LAUNCHES`` counts wrapper calls that launched the
kernel (its main grid and, with more than one split, the merge grid),
``LAUNCHES_BY_DTYPE`` splits them by form (``float32``; ``bfloat16``: q
and pools bf16; ``bfloat16_q``: bf16 q over fp32 pools; ``float16`` and
``float16_q`` the same in fp16) and ``PLAIN_CALLS`` counts the wrappers'
calls of the plain version.

Dtypes, as the TPU kernel takes them: q fp32, bf16 or fp16, the split
pools in q's dtype, the engine pool of the pool form fp32 (or q's dtype);
any other dtype or mix raises. Both versions compute in fp32 and return
the output in q's dtype (the log-sum-exp in fp32); no input is cast to
reach a form. The 16-bit forms are one template over bf16 and fp16, a
library each (``paged_attention_bf16``, ``paged_attention_f16``).

The kernel splits each (sequence, KV head) over ``n_split`` blocks. The
wrapper's choices are plain functions of shapes and the card's SM count
(``paged_form``, ``paged_block_rows``, ``paged_splits``), so a call reads
nothing back from the card; ``paged_split_range`` is the kernel's own cut
of a sequence's live pages into shares. Two instantiations, chosen by
``paged_form`` as the C side does: ``lanes`` (a block takes up to
``MAX_ROWS`` query rows, the values of a row spread over a warp's lanes;
``paged_row_groups`` of them a KV head) and ``packed`` (a wide head dim
with a GQA group of at least ``PACKED_MIN_G`` rows, MLA's: a block takes
``PACKED_ROWS`` of the group's rows, its products on the tensor
cores). ``LAUNCHES_BY_INSTANCE`` counts the launches of each.

``paged_attention_lse_fwd`` is the split-pool entry that also returns each
row's log-sum-exp, the stripe's share of a distributed read
(``distributed/collectives.py``): the launch is the same kernel with at
least two shares, and the log-sum-exp is read from the shares' (m, l) in
the partials scratch after the merge (the kernel source is unchanged).

Each entry is a custom op (``repro_torch::paged_attention``,
``paged_attention_pool``, ``paged_attention_lse``; ``_build.py entry``)
whose FLOP and bytes formulas count the live pages' positions: this run's
when the table and lengths can be read, every page of the table when they
are fake (the dry run's step at the end of a full context).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels._build import (check_tensor, entry, kernel_info,
                                        known, library, raise_on,
                                        refuse_grad)
from repro_torch.kernels.paged_attention.ref import (paged_attention_pool_ref,
                                                     paged_attention_ref)

LAUNCHES: Dict[str, int] = {"paged_attention": 0}
PLAIN_CALLS: Dict[str, int] = {"paged_attention": 0}
LAUNCHES_BY_DTYPE: Dict[str, int] = {"float32": 0, "bfloat16": 0,
                                     "bfloat16_q": 0, "float16": 0,
                                     "float16_q": 0}
LAUNCHES_BY_INSTANCE: Dict[str, int] = {"lanes": 0, "packed": 0}
F32, BF16, F16, I32 = (torch.float32, torch.bfloat16, torch.float16,
                       torch.int32)
DTYPES = (F32, BF16, F16)            # q's (and the split pools') forms
TAG16 = {BF16: "bf16", F16: "f16"}   # a 16-bit q's library and entry tag
NEG_INF = -1e30
NARROW_HEAD_DIM = 256                # 8 floats of hd a lane (csrc kMaxD)
MAX_HEAD_DIM = 576                   # the wide instantiation (kMaxDWide)
MAX_ROWS = 4                         # query rows a block (csrc kMaxG)
BLOCKS_PER_SM = 3                    # resident blocks an SM (csrc)
BLOCKS_PER_SM_WIDE = 1               # at a head dim past 256 (csrc)
MAX_SPLITS = 65535                   # the grid's y dimension
MERGE_FLOATS = 12 * 1024             # the merge's coefficients (csrc)
PACKED_MIN_G = 16                    # the packed instantiation (csrc
                                     # kPackedMinG): a group this large
PACKED_ROWS = 32                     # its query rows a block, every
                                     # dtype (csrc kPackedRows; the note
                                     # there says why not 64 over bf16)
INFO_KEYS = ("registers", "static_smem", "dynamic_smem", "blocks_per_sm",
             "threads", "merge_registers", "tile_positions", "rows_per_block")
_sms: Dict[int, int] = {}


def paged_row_groups(h: int, kv: int) -> int:
    """Row groups of a KV head's GQA group: a block takes at most
    ``MAX_ROWS`` query rows."""
    return -(-(h // kv) // MAX_ROWS)


def paged_form(g: int, d: int, dv: int) -> str:
    """The instantiation a call launches (the C side's is_packed):
    "packed" where the head dims pass 256 and the GQA group has at least
    ``PACKED_MIN_G`` rows, else "lanes"."""
    wide = max(d, dv) > NARROW_HEAD_DIM
    return "packed" if wide and g >= PACKED_MIN_G else "lanes"


def paged_block_rows(h: int, kv: int, d: int, dv: int) -> int:
    """Blocks a sequence's query rows take (``paged_splits``' ``rows`` per
    sequence): kv x the packed row tiles, or kv x ``paged_row_groups``."""
    g = h // kv
    if paged_form(g, d, dv) == "packed":
        return kv * -(-g // PACKED_ROWS)
    return kv * paged_row_groups(h, kv)


def paged_partial_floats(b: int, h: int, kv: int, dv: int, n_split: int,
                         form: str) -> int:
    """fp32 values of the partials scratch a launch takes: lanes, (b, kv,
    n_split, g, dv + 2) when n_split > 1; packed, the KV heads' b *
    n_split + b segment slots of (g, dv + 2), then (b, h) log-sum-exps."""
    g = h // kv
    if form == "packed":
        return kv * (b * n_split + b) * g * (dv + 2) + b * h
    return b * kv * n_split * g * (dv + 2) if n_split > 1 else 0


def paged_splits(p_max: int, rows: int, sms: int, g: int = 1,
                 d: int = NARROW_HEAD_DIM) -> int:
    """Blocks per (sequence, KV head, row group), from shapes alone:
    enough to put the resident blocks (``BLOCKS_PER_SM``, or
    ``BLOCKS_PER_SM_WIDE`` where the wider head dim ``d`` passes 256) on
    every SM, at most one per page of the table, and few enough that the
    merge's coefficients of the ``g`` query rows of a KV head fit its
    shared memory (``rows`` = b * kv * row groups; at g = 128 the cap is
    95)."""
    per_sm = BLOCKS_PER_SM if d <= NARROW_HEAD_DIM else BLOCKS_PER_SM_WIDE
    fill = (per_sm * sms) // max(rows, 1)
    return max(1, min(fill, max(p_max, 1), MAX_SPLITS,
                      MERGE_FLOATS // max(g, 1) - 1))


def paged_split_range(split: int, n_split: int, first: int,
                      last: int) -> Tuple[int, int]:
    """The pages [lo, hi) that block ``split`` takes of the pages
    [first, last) that can run (the kernel's cut: equal shares, the
    larger ones last)."""
    n = max(0, last - first)
    return (first + split * n // n_split, first + (split + 1) * n // n_split)


def paged_live_range(length: int, p_max: int, page: int,
                     window: int = 0) -> Tuple[int, int]:
    """The pages [first, last) of a sequence of ``length`` positions that
    can run: below the length and, with a window, reaching into it."""
    last = min(p_max, -(-length // page)) if length > 0 else 0
    first = 0
    if window and window > 0:
        x = length - window - page
        first = 0 if x < 0 else x // page + 1
    return first, last


def sm_count(dev: torch.device) -> int:
    """The card's SM count, read once per device."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _sms:
        _sms[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sms[i]


def paged_info(g: int, d: int, dv: int, vec_k: bool = True,
               vec_v: bool = True, p_max: int = 64, n_split: int = 1,
               dtype=F32, kv_dtype=None) -> Dict[str, int]:
    """The main kernel's registers, shared memory and resident blocks per
    SM for ``g`` query rows a KV head, and the merge kernel's registers,
    of the form of q's ``dtype`` and the pools' ``kv_dtype`` (default
    ``dtype``; needs the card)."""
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    args = (g, d, dv, int(vec_k), int(vec_v), p_max, n_split)
    if dtype in TAG16:
        tag = TAG16[dtype]
        return kernel_info(f"paged_attention_{tag}",
                           f"paged_attention_{tag}_info",
                           args + (int(kv_dtype == dtype),), INFO_KEYS)
    return kernel_info("paged_attention", "paged_attention_info", args,
                       INFO_KEYS)


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS, LAUNCHES_BY_DTYPE,
                   LAUNCHES_BY_INSTANCE):
        for k in counts:
            counts[k] = 0


def _check_common(q, block_table, lengths, kv: int, dev) -> None:
    b, h, _d = q.shape
    if q.dtype not in DTYPES:
        raise TypeError(f"q: expected torch.float32, torch.bfloat16 or "
                        f"torch.float16, got {q.dtype}")
    check_tensor("q", q, q.dtype, q.shape, dev)
    check_tensor("block_table", block_table, I32, (b, block_table.shape[1]),
                 dev)
    check_tensor("lengths", lengths, I32, (b,), dev)
    if kv <= 0 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")


def _form(dtype, kv_dtype) -> str:
    """The ``LAUNCHES_BY_DTYPE`` key of a call."""
    name = str(dtype).split(".")[1]
    return name if dtype == F32 or kv_dtype == dtype else f"{name}_q"


def _launch(q, k_ptr: int, v_ptr: int, block_table, lengths, *, kv, dv,
            page, n_rows, k_row, k_tok, v_row, v_tok, window, logit_cap,
            scale, kv_dtype, lse=False):
    b, h, d = q.shape
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims ({d}, {dv}) > {MAX_HEAD_DIM}, the "
                         "kernel's limit")
    if lse and block_table.shape[1] < 2:      # room for two shares: a hole
        block_table = torch.nn.functional.pad(block_table, (0, 1), value=-1)
    p_max = block_table.shape[1]
    rows = b * paged_block_rows(h, kv, d, dv)
    n_split = paged_splits(p_max, rows, sm_count(q.device), h // kv,
                           max(d, dv))
    form = paged_form(h // kv, d, dv)
    if lse and form == "lanes":
        n_split = max(n_split, 2)
    out = torch.empty((b, h, dv), dtype=q.dtype, device=q.device)
    n_part = paged_partial_floats(b, h, kv, dv, n_split, form)
    part = (torch.empty(n_part, dtype=F32, device=q.device) if n_part
            else None)
    args = (q.data_ptr(), k_ptr, v_ptr, block_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), b, h, kv, d, dv,
            p_max, page, n_rows, k_row, k_tok, v_row, v_tok,
            int(window or 0), float(scale), float(logit_cap or 0.0), n_split)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q.dtype in TAG16:
            tag = TAG16[q.dtype]
            err = getattr(library(f"paged_attention_{tag}"),
                          f"paged_attention_{tag}")(
                *args, int(kv_dtype == q.dtype), stream)
        else:
            err = library("paged_attention").paged_attention(*args, stream)
    raise_on(err, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    LAUNCHES_BY_DTYPE[_form(q.dtype, kv_dtype)] += 1
    LAUNCHES_BY_INSTANCE[form] += 1
    if not lse:
        return out
    if form == "packed":                 # the merge wrote them
        return out, part[n_part - b * h:].view(b, h)
    part = part.view(b, kv, n_split, h // kv, dv + 2)
    return out, _shares_lse(part[..., dv], part[..., dv + 1], b, h)


def _shares_lse(m, l, b: int, h: int):
    """(b, kv, n_split, g) shares' running max and sum -> (b, h) log-sum-
    exp, NEG_INF where no share saw a live position."""
    live = l > 0
    m_star = torch.where(live, m, NEG_INF).amax(dim=2, keepdim=True)
    total = torch.where(live, l * torch.exp(m - m_star), 0.0).sum(dim=2)
    m_star = m_star[:, :, 0]
    out = torch.where(total > 0, m_star + torch.log(total), NEG_INF)
    return out.reshape(b, h)


def paged_attention_fwd(q, pool_k, pool_v, block_table, lengths, *,
                        window=0, logit_cap=0.0, scale=None):
    """q: (B,H,hd) fp32, bf16 or fp16; pools: (E,page,KV,hd_{k,v}) in q's
    dtype;
    block_table: (B,P) int32; lengths: (B,) int32. Hole pages (extent -1)
    are skipped. Returns (B,H,hd_v) in q's dtype."""
    refuse_grad("paged_attention", q, pool_k, pool_v)
    scale = _check_split(q, pool_k, pool_v, block_table, lengths, scale)
    return entry(torch.ops.repro_torch.paged_attention.default, _split,
                 q, pool_k, pool_v, block_table, lengths, int(window or 0),
                 float(logit_cap or 0.0), scale)


def paged_attention_lse_fwd(q, pool_k, pool_v, block_table, lengths, *,
                            window=0, logit_cap=0.0, scale=None):
    """``paged_attention_fwd`` that also returns each row's log-sum-exp of
    its live logits: (out (B,H,hd_v) in q's dtype, lse (B,H) fp32), lse
    NEG_INF on a row with no live position (its out is zeros)."""
    refuse_grad("paged_attention", q, pool_k, pool_v)
    scale = _check_split(q, pool_k, pool_v, block_table, lengths, scale)
    return entry(torch.ops.repro_torch.paged_attention_lse.default,
                 _split_lse, q, pool_k, pool_v, block_table, lengths,
                 int(window or 0), float(logit_cap or 0.0), scale)


def _check_split(q, pool_k, pool_v, block_table, lengths, scale) -> float:
    e, page, kv, dk = pool_k.shape
    dv = pool_v.shape[-1]
    dev = q.device
    _check_common(q, block_table, lengths, kv, dev)
    if q.shape[-1] != dk:
        raise ValueError(f"q head dim {q.shape[-1]} != pool_k's {dk}")
    check_tensor("pool_k", pool_k, q.dtype, (e, page, kv, dk), dev)
    check_tensor("pool_v", pool_v, q.dtype, (e, page, kv, dv), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"paged_attention: no kernel for device {dev}")
    return float(scale) if scale is not None else 1.0 / math.sqrt(dk)


def _split_args(pool_k, pool_v):
    e, page, kv, dk = pool_k.shape
    dv = pool_v.shape[-1]
    return dict(kv=kv, dv=dv, page=page, n_rows=e, k_row=page * kv * dk,
                k_tok=kv * dk, v_row=page * kv * dv, v_tok=kv * dv,
                kv_dtype=pool_k.dtype)


def _split(q, pool_k, pool_v, block_table, lengths, window: int,
           logit_cap: float, scale: float):
    """The split-pool launch (the CPU's plain version)."""
    if q.device.type == "cpu":
        PLAIN_CALLS["paged_attention"] += 1
        return paged_attention_ref(q, pool_k, pool_v, block_table, lengths,
                                   window=window, logit_cap=logit_cap,
                                   scale=scale).to(q.dtype)
    return _launch(q, pool_k.data_ptr(), pool_v.data_ptr(), block_table,
                   lengths, window=window, logit_cap=logit_cap, scale=scale,
                   **_split_args(pool_k, pool_v))


def _split_lse(q, pool_k, pool_v, block_table, lengths, window: int,
               logit_cap: float, scale: float):
    if q.device.type == "cpu":
        PLAIN_CALLS["paged_attention"] += 1
        out, lse = paged_attention_ref(q, pool_k, pool_v, block_table,
                                       lengths, window=window,
                                       logit_cap=logit_cap, scale=scale,
                                       return_lse=True)
        return out.to(q.dtype), lse
    return _launch(q, pool_k.data_ptr(), pool_v.data_ptr(), block_table,
                   lengths, window=window, logit_cap=logit_cap, scale=scale,
                   lse=True, **_split_args(pool_k, pool_v))


def paged_attention_pool_fwd(q, pool, block_table, lengths, *, k_plane,
                             v_plane, window=0, logit_cap=0.0, scale=None):
    """Zero-copy variant: attend straight out of ONE engine extent pool.

    q: (B,H,hd) fp32, bf16 or fp16; pool: (E, page, n_planes, KV, hd)
    fp32 or q's dtype — the fused engine's payload pool (fp32), where plane
    ``2*l`` holds paged layer l's keys and ``2*l+1`` its values
    (serving/engine.py); block_table: (B,P) rows of the volume extent map
    (holes -1); lengths: (B,). Returns (B,H,hd) in q's dtype. The kernel
    reads the two planes in place through strides: no staging copy of the
    KV cache."""
    refuse_grad("paged_attention", q, pool)
    e, page, n_planes, kv, d = pool.shape
    dev = q.device
    _check_common(q, block_table, lengths, kv, dev)
    if q.shape[-1] != d:
        raise ValueError(f"q head dim {q.shape[-1]} != the pool's {d}")
    check_tensor("pool", pool, F32 if pool.dtype == F32 else q.dtype,
                 (e, page, n_planes, kv, d), dev)
    if not (0 <= k_plane < n_planes and 0 <= v_plane < n_planes):
        raise ValueError(f"planes ({k_plane}, {v_plane}) outside "
                         f"[0, {n_planes})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"paged_attention: no kernel for device {dev}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    return entry(torch.ops.repro_torch.paged_attention_pool.default, _pool,
                 q, pool, block_table, lengths, int(k_plane), int(v_plane),
                 int(window or 0), float(logit_cap or 0.0), scale)


def _pool(q, pool, block_table, lengths, k_plane: int, v_plane: int,
          window: int, logit_cap: float, scale: float):
    """The zero-copy launch (the CPU's plain version)."""
    if q.device.type == "cpu":
        PLAIN_CALLS["paged_attention"] += 1
        return paged_attention_pool_ref(q, pool, block_table, lengths,
                                        k_plane=k_plane, v_plane=v_plane,
                                        window=window, logit_cap=logit_cap,
                                        scale=scale).to(q.dtype)
    e, page, n_planes, kv, d = pool.shape
    plane = kv * d                       # elements per plane of one token
    item = pool.element_size()
    tok = n_planes * plane
    return _launch(q, pool.data_ptr() + k_plane * plane * item,
                   pool.data_ptr() + v_plane * plane * item, block_table,
                   lengths, kv=kv, dv=d, page=page, n_rows=e,
                   k_row=page * tok, k_tok=tok, v_row=page * tok, v_tok=tok,
                   window=window, logit_cap=logit_cap, scale=scale,
                   kv_dtype=pool.dtype)


# ---------------------------------------------------------------------------
# the entries as custom ops: fake implementations, FLOP and bytes formulas
# ---------------------------------------------------------------------------
Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::paged_attention", mutates_args=())
def _paged_op(q: Tensor, pool_k: Tensor, pool_v: Tensor, block_table: Tensor,
              lengths: Tensor, window: int, logit_cap: float,
              scale: float) -> Tensor:
    return _split(q, pool_k, pool_v, block_table, lengths, window, logit_cap,
                  scale)


@torch.library.custom_op("repro_torch::paged_attention_lse", mutates_args=())
def _paged_lse_op(q: Tensor, pool_k: Tensor, pool_v: Tensor,
                  block_table: Tensor, lengths: Tensor, window: int,
                  logit_cap: float, scale: float) -> Tuple[Tensor, Tensor]:
    return _split_lse(q, pool_k, pool_v, block_table, lengths, window,
                      logit_cap, scale)


@torch.library.custom_op("repro_torch::paged_attention_pool",
                         mutates_args=())
def _paged_pool_op(q: Tensor, pool: Tensor, block_table: Tensor,
                   lengths: Tensor, k_plane: int, v_plane: int, window: int,
                   logit_cap: float, scale: float) -> Tensor:
    return _pool(q, pool, block_table, lengths, k_plane, v_plane, window,
                 logit_cap, scale)


@_paged_op.register_fake
def _(q, pool_k, pool_v, block_table, lengths, window, logit_cap, scale):
    return q.new_empty((*q.shape[:2], pool_v.shape[-1]))


@_paged_lse_op.register_fake
def _(q, pool_k, pool_v, block_table, lengths, window, logit_cap, scale):
    return (q.new_empty((*q.shape[:2], pool_v.shape[-1])),
            q.new_empty(q.shape[:2], dtype=F32))


@_paged_pool_op.register_fake
def _(q, pool, block_table, lengths, k_plane, v_plane, window, logit_cap,
      scale):
    return q.new_empty(q.shape)


def live_positions(block_table, lengths, page: int, window: int = 0) -> int:
    """Positions of the pages the kernel runs (``_paged_live_pages`` of
    ``chip_smoke.py``, times the page): this run's data when it can be
    read, else every page of the table."""
    if not known(block_table, lengths):
        return block_table.numel() * page
    base = torch.arange(block_table.shape[1],
                        device=block_table.device)[None, :] * page
    run = (base < lengths[:, None]) & (block_table >= 0)
    if window:
        run &= (base + page - 1) > (lengths[:, None] - 1 - window)
    return int(run.sum()) * page


def paged_work(q, block_table, lengths, page: int, kv: int, d: int, dv: int,
               window: int, itemsize: int = 4):
    """(flops, bytes) of one call: QK^T (d wide) and PV (dv wide) at every
    live position for each query head, 2 flops a multiply-add; each live
    position's K and V rows of its KV heads read once (``itemsize`` bytes
    a value), q, the table and the lengths read and the output (q's dtype)
    written once."""
    n = live_positions(block_table, lengths, page, window)
    b, h, _ = q.shape
    flops = 2 * h * (d + dv) * n
    n_bytes = (n * kv * (d + dv) * itemsize
               + (q.numel() + b * h * dv) * q.element_size()
               + (block_table.numel() + lengths.numel()) * 4)
    return flops, n_bytes


def _split_work(q, pool_k, pool_v, block_table, lengths, window, *_a, **_k):
    _e, page, kv, d = pool_k.shape
    return paged_work(q, block_table, lengths, page, kv, d,
                      pool_v.shape[-1], window, pool_k.element_size())


def _pool_work(q, pool, block_table, lengths, k_plane, v_plane, window, *_a,
               **_k):
    _e, page, _n, kv, d = pool.shape
    return paged_work(q, block_table, lengths, page, kv, d, d, window,
                      pool.element_size())


def _register_formulas():
    from torch.utils.flop_counter import register_flop_formula
    from repro_torch.utils.op_stats import register_bytes_formula
    for packet, work in ((torch.ops.repro_torch.paged_attention, _split_work),
                         (torch.ops.repro_torch.paged_attention_lse,
                          _split_work),
                         (torch.ops.repro_torch.paged_attention_pool,
                          _pool_work)):
        register_flop_formula(packet, get_raw=True)(
            lambda *a, _w=work, out_val=None, **k: _w(*a, **k)[0])
        register_bytes_formula(packet)(
            lambda *a, _w=work, out_val=None, **k: _w(*a, **k)[1])


_register_formulas()
