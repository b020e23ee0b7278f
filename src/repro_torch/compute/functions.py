"""The five built-in storage functions.

Port of ``repro/compute/functions.py``. Every function exists three times
(device ``apply``, sequential ``host_ref``, pure-Python ``mirror``) over one
byte-level spec, so bit-identity across backends is a property of the spec:

- a *byte* is ``int(lane) & 0xFF`` of a float32 payload lane (the blockdev
  byte API stores one byte per lane);
- the page checksum is a position-sensitive xor-fold
  ``XOR_j rotl32(byte_j + 1, j % 31)``;
- a range checksum folds page sums the same way:
  ``XOR_p rotl32(pagesum_p, p % 31)`` over the addressed pages;
- a block checksum is the page fold applied to one block's bytes;
- the completion's ``value`` lane carries the uint32 result bit-cast to
  int32.

torch has no uint32 shifts and no xor reduction: the uint32 math runs in
int64 masked with ``0xFFFFFFFF``, the bit-cast to int32 is
``x - (x >= 2**31) * 2**32``, and the device folds halve pairwise (XOR is
associative, so any order gives the same bits as ``host_ref``'s strictly
sequential fold). The device functions walk a ``phase.VolumeView`` chunk
by chunk and read nothing back; ``host_ref`` fetches the addressed lanes
and folds byte by byte in Python ints.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.compute.registry import ST_MISMATCH, register_storage_fn

M32 = 0xFFFFFFFF
I64 = torch.int64

# ---------------------------------------------------------------------------
# device helpers (int64 holding uint32)
# ---------------------------------------------------------------------------


def _bytes(lanes: torch.Tensor) -> torch.Tensor:
    """float32 byte lanes (each holding 0..255) -> int64 byte values."""
    return lanes.to(torch.int32).to(I64) & 0xFF


def _rotl32(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """rotl32 of uint32 values held in int64; ``s`` broadcasts over ``x``.
    ``(32 - s) % 32`` keeps the right shift in [0, 31] at ``s == 0``."""
    s = s % 32
    return ((x << s) & M32) | (x >> ((32 - s) % 32))


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR-reduce the last axis by pairwise halving."""
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1])
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], -1)
        h = x.shape[-1] // 2
        x = x[..., :h] ^ x[..., h:]
    return x[..., 0]


def _fold_bytes(b: torch.Tensor) -> torch.Tensor:
    """Position-sensitive xor-fold of the last axis:
    XOR_j rotl32(b_j + 1, j % 31)."""
    j = torch.arange(b.shape[-1], dtype=I64, device=b.device) % 31
    return _xor_fold(_rotl32(b + 1, j))


def _i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 in int64 -> the int32 of the same bits."""
    return (x - (x >= 2 ** 31).to(I64) * 2 ** 32).to(torch.int32)


def _match(b: torch.Tensor, arg: int) -> torch.Tensor:
    """arg in 0..255: byte == arg; arg < 0: byte != 0."""
    return b != 0 if arg < 0 else b == (arg & 0xFF)


def _scalar(v, dtype, device) -> torch.Tensor:
    return torch.full((), v, dtype=dtype, device=device)


def _ok(view) -> torch.Tensor:
    return _scalar(0, torch.int32, view.device)


def _false(view) -> torch.Tensor:
    return _scalar(False, torch.bool, view.device)


# ---------------------------------------------------------------------------
# host_ref helpers: the addressed lanes as host bytes, folded in order
# ---------------------------------------------------------------------------


def _host_pages(view, page: int, count: int):
    """``(page index, bytes)`` of every addressed page, in order."""
    for p0, lanes in view.chunks(page, page + count):
        arr = lanes.reshape(lanes.shape[0], -1).to(torch.int32).cpu().numpy()
        for k, row in enumerate(arr & 0xFF):
            yield p0 + k, row.tolist()


def _host_block(view, page: int, block: int):
    lanes = view.block(page, block)
    return lanes, (lanes.reshape(-1).to(torch.int32).cpu().numpy()
                   & 0xFF).tolist()


def _result(view, value, status=0, out=None, do_write=False, payload=None):
    """A host_ref's results as tensors on the view's device."""
    dev = view.device
    return (torch.tensor(value, dtype=torch.int32, device=dev),
            torch.tensor(status, dtype=torch.int32, device=dev),
            torch.zeros_like(payload) if out is None else out,
            torch.tensor(do_write, dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# checksum — range fold (one request replaces reading every page back)
# ---------------------------------------------------------------------------


def _checksum_apply(view, page, block, arg, payload):
    total = torch.zeros((), dtype=I64, device=view.device)
    for p0, lanes in view.chunks(page, page + block):
        n = lanes.shape[0]
        psums = _fold_bytes(_bytes(lanes.reshape(n, -1)))         # (n,)
        p = torch.arange(p0, p0 + n, dtype=I64, device=view.device) % 31
        total = total ^ _xor_fold(_rotl32(psums, p))
    return _i32(total), _ok(view), torch.zeros_like(payload), _false(view)


def _checksum_ref(view, page, block, arg, payload):
    t = 0
    for p, bs in _host_pages(view, page, block):
        t ^= py_rotl32(py_fold(bs), p % 31)
    return _result(view, py_i32(t), payload=payload)

# ---------------------------------------------------------------------------
# scan_count — predicate match count (arg in 0..255: byte == arg;
# arg < 0: byte != 0)
# ---------------------------------------------------------------------------


def _scan_count_apply(view, page, block, arg, payload):
    n = torch.zeros((), dtype=I64, device=view.device)
    for _p0, lanes in view.chunks(page, page + block):
        b = lanes.to(torch.int32) & 0xFF
        n = n + _match(b, arg).sum()
    return (n.to(torch.int32), _ok(view), torch.zeros_like(payload),
            _false(view))


def _scan_count_ref(view, page, block, arg, payload):
    n = 0
    for _p, bs in _host_pages(view, page, block):
        n += sum(1 for v in bs if _py_match(v, arg))
    return _result(view, n, payload=payload)

# ---------------------------------------------------------------------------
# filter_pages — matching page indices through the payload lanes
# (value = total match count; payload = first D ascending indices, -1 pad)
# ---------------------------------------------------------------------------


def _filter_pages_apply(view, page, block, arg, payload):
    P, D = view.n_pages, payload.numel()
    hits = torch.zeros((P,), dtype=torch.bool, device=view.device)
    for p0, lanes in view.chunks(page, page + block):
        b = lanes.reshape(lanes.shape[0], -1).to(torch.int32) & 0xFF
        hits[p0:p0 + lanes.shape[0]] = _match(b, arg).any(1)
    count = hits.sum(dtype=torch.int32)
    idx = torch.sort(torch.where(
        hits, torch.arange(P, dtype=torch.int32, device=view.device),
        P)).values
    sel = (idx[:D] if D <= P else torch.cat(
        [idx, torch.full((D - P,), P, dtype=torch.int32,
                         device=view.device)]))
    out = torch.where(sel < P, sel, -1).to(torch.float32)
    return count, _ok(view), out.reshape(payload.shape), _false(view)


def _filter_pages_ref(view, page, block, arg, payload):
    D = payload.numel()
    out, n = [-1] * D, 0
    for p, bs in _host_pages(view, page, block):
        if any(_py_match(v, arg) for v in bs):
            if n < D:
                out[n] = p
            n += 1
    lanes = torch.tensor(out, dtype=torch.float32, device=view.device)
    return _result(view, n, out=lanes.reshape(payload.shape))

# ---------------------------------------------------------------------------
# compare_and_write — checksum-compare CAS riding the CoW write path:
# arg is the expected *blocksum* of the current block; on match the
# request's payload is committed to the block (value always = actual
# blocksum)
# ---------------------------------------------------------------------------


def _cas_status(match) -> torch.Tensor:
    return torch.where(match, 0, ST_MISMATCH).to(torch.int32)


def _cas_apply(view, page, block, arg, payload):
    bb = _bytes(view.block(page, block).reshape(-1))
    bsum = _i32(_fold_bytes(bb))
    match = bsum == arg
    return bsum, _cas_status(match), torch.zeros_like(payload), match


def _cas_ref(view, page, block, arg, payload):
    _lanes, bs = _host_block(view, page, block)
    bsum = py_i32(py_fold(bs))
    return _result(view, bsum, 0 if bsum == arg else ST_MISMATCH,
                   do_write=bsum == arg, payload=payload)

# ---------------------------------------------------------------------------
# verify_on_read — read one block AND return its checksum-match status
# (arg = expected blocksum; arg == 0 skips the check and just checksums)
# ---------------------------------------------------------------------------


def _verify_apply(view, page, block, arg, payload):
    blk = view.block(page, block)
    bsum = _i32(_fold_bytes(_bytes(blk.reshape(-1))))
    status = torch.where((bsum == arg) | (arg == 0), 0,
                         ST_MISMATCH).to(torch.int32)
    return bsum, status, blk.reshape(payload.shape), _false(view)


def _verify_ref(view, page, block, arg, payload):
    lanes, bs = _host_block(view, page, block)
    bsum = py_i32(py_fold(bs))
    status = 0 if (arg == 0 or bsum == arg) else ST_MISMATCH
    return _result(view, bsum, status, out=lanes.reshape(payload.shape))

# ---------------------------------------------------------------------------
# pure-Python mirrors over the byte-oracle shadow
# ---------------------------------------------------------------------------


def py_rotl32(x: int, s: int) -> int:
    s %= 32
    return ((x << s) | (x >> ((32 - s) % 32))) & M32


def py_fold(bs) -> int:
    t = 0
    for j, v in enumerate(bs):
        t ^= py_rotl32((v + 1) & M32, j % 31)
    return t


def py_i32(x: int) -> int:
    x &= M32
    return x - (1 << 32) if x >= (1 << 31) else x


def py_blocksum(data) -> int:
    """int32 blocksum of a bytes-like block: ``compare_and_write`` /
    ``verify_on_read`` expectations from host-side bytes."""
    return py_i32(py_fold(data))


_FOLD_CHUNK = 31 << 20           # bytes a pass of np_blocksum (31 | it)


def np_blocksum(data) -> int:
    """Vectorized twin of ``py_blocksum``. The fold XORs
    ``rotl32(byte + 1, pos % 31)`` over the bytes; a rotation distributes
    over XOR, so it equals the XOR over residues k of ``rotl32(X_k, k)``,
    X_k the XOR of ``byte + 1`` over the positions congruent to k mod 31:
    one uint16 pass over the bytes, a chunk at a time, so a blob of
    gigabytes (an export section) folds in bounded memory."""
    a = np.frombuffer(memoryview(data), np.uint8)
    acc = np.zeros(31, np.uint16)
    for lo in range(0, a.size, _FOLD_CHUNK):
        part = a[lo:lo + _FOLD_CHUNK].astype(np.uint16)
        part += 1
        full = part.size - part.size % 31
        acc ^= np.bitwise_xor.reduce(part[:full].reshape(-1, 31), axis=0)
        acc[:part.size - full] ^= part[full:]
    t = 0
    for k in range(31):
        t ^= py_rotl32(int(acc[k]), k)
    return py_i32(t)


def np_blocksum_many(blobs) -> list:
    """``np_blocksum`` of each blob (the journal's records of one group
    commit)."""
    return [np_blocksum(b) for b in blobs]


def _pages(shadow, page_bytes: int, page: int, count: int):
    n_pages = len(shadow) // page_bytes
    return range(max(page, 0), min(page + count, n_pages))


def _page_bytes_of(shadow, page_bytes: int, page: int, count: int):
    """(page, its bytes as a uint8 view) over the range's pages."""
    a = np.frombuffer(memoryview(shadow), np.uint8)
    for p in _pages(shadow, page_bytes, page, count):
        yield p, a[p * page_bytes:(p + 1) * page_bytes]


def _py_match(v: int, arg: int) -> bool:
    return v != 0 if arg < 0 else v == (arg & 0xFF)


def _np_match(seg: np.ndarray, arg: int) -> np.ndarray:
    """The bytes ``_match`` selects: nonzero for a negative ``arg``, else
    equal to its low byte."""
    return seg != 0 if arg < 0 else seg == (arg & 0xFF)


# The range mirrors fold and match a page at a time with numpy (the same
# values as the reference's per-byte loops; ``np_blocksum`` is the fold):
# a harness run at the block device's widths mirrors megabyte ranges.
def _checksum_mirror(shadow, page_bytes, block_bytes, page, block, arg, data):
    t = 0
    for p, seg in _page_bytes_of(shadow, page_bytes, page, block):
        t ^= py_rotl32(np_blocksum(seg) & M32, p % 31)
    return py_i32(t), 0, None


def _scan_count_mirror(shadow, page_bytes, block_bytes, page, block, arg,
                       data):
    n = sum(int(np.count_nonzero(_np_match(seg, arg)))
            for _p, seg in _page_bytes_of(shadow, page_bytes, page, block))
    return n, 0, None


def _filter_pages_mirror(shadow, page_bytes, block_bytes, page, block, arg,
                         data):
    hits = [p for p, seg in _page_bytes_of(shadow, page_bytes, page, block)
            if _np_match(seg, arg).any()]
    # the payload carries block_bytes lanes -> the first block_bytes indices
    return len(hits), 0, hits[:block_bytes]


def _cas_mirror(shadow, page_bytes, block_bytes, page, block, arg, data):
    off = page * page_bytes + block * block_bytes
    bsum = py_i32(py_fold(shadow[off:off + block_bytes]))
    if bsum == arg:
        shadow[off:off + block_bytes] = data
        return bsum, 0, None
    return bsum, ST_MISMATCH, None


def _verify_mirror(shadow, page_bytes, block_bytes, page, block, arg, data):
    off = page * page_bytes + block * block_bytes
    cur = bytes(shadow[off:off + block_bytes])
    bsum = py_i32(py_fold(cur))
    status = 0 if (arg == 0 or bsum == arg) else ST_MISMATCH
    return bsum, status, cur

# ---------------------------------------------------------------------------
# registration (order defines the fn-lane ids: checksum=0 .. verify=4)
# ---------------------------------------------------------------------------


register_storage_fn("checksum", apply=_checksum_apply,
                    host_ref=_checksum_ref, mirror=_checksum_mirror)
register_storage_fn("scan_count", apply=_scan_count_apply,
                    host_ref=_scan_count_ref, mirror=_scan_count_mirror)
register_storage_fn("filter_pages", apply=_filter_pages_apply,
                    host_ref=_filter_pages_ref, mirror=_filter_pages_mirror)
register_storage_fn("compare_and_write", apply=_cas_apply,
                    host_ref=_cas_ref, mirror=_cas_mirror,
                    writes=True, scope="block")
register_storage_fn("verify_on_read", apply=_verify_apply,
                    host_ref=_verify_ref, mirror=_verify_mirror,
                    scope="block")
