"""``dbs_rw``: wrappers of the hand-written CUDA write and read kernels.

Port of ``repro/kernels/dbs/rw_kernel.py``; the kernels live in
``csrc/dbs_rw.cu`` (the source note there gives their bound and design),
built at first use by ``kernels/_build.py``.
Each wrapper checks device, dtype, shape and contiguity, then launches the
kernel for a tensor on a CUDA device or calls the plain version
(kernels/dbs/ref.py) for a tensor on the CPU. A CUDA tensor gets the kernel
or an error, never the plain version. The pool may be of any dtype of 1, 2,
4 or 8 bytes, as the TPU kernels': the kernels move a block's bytes in the
widest word that divides them and the base pointers' alignment
(``word_bytes``); a write's payload is of the pool's dtype.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` the wrappers' calls
of the plain version, so a run can show which path it went through.

Both entries are custom ops (``repro_torch::dbs_rw_write``, which mutates
the pool, and ``repro_torch::dbs_rw_read``; ``_build.py entry``): no
FLOPs, and the bytes the batch semantically moves (ops.py).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels._build import check_pool_dtype
from repro_torch.kernels._build import check_tensor as _check
from repro_torch.kernels._build import (entry, kernel_info, library,
                                        raise_on, word_bytes)
from repro_torch.kernels.dbs.ref import dbs_rw_read_ref, dbs_rw_write_ref

LAUNCHES: Dict[str, int] = {"dbs_rw_write": 0, "dbs_rw_read": 0}
PLAIN_CALLS: Dict[str, int] = {"dbs_rw_write": 0, "dbs_rw_read": 0}


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


INFO_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
             "blocks_per_sm", "threads")


def write_info(word: int = 16) -> Dict[str, int]:
    """The CUDA write kernel's registers, shared memory, resident blocks
    per SM and threads per block in ``word``-byte accesses (needs the
    card)."""
    return kernel_info("dbs_rw", "dbs_rw_write_info", (word,), INFO_KEYS)


def read_info(n_lanes: int, block_bytes: int,
              word: int = 16) -> Dict[str, int]:
    """The CUDA read kernel's registers, shared memory, resident blocks per
    SM, and the threads per block and grid blocks it takes for ``n_lanes``
    lanes of ``block_bytes``-byte blocks in ``word``-byte accesses (the
    block size is chosen per call; needs the card)."""
    return kernel_info("dbs_rw", "dbs_rw_read_info",
                       (n_lanes, block_bytes, word),
                       INFO_KEYS + ("grid_blocks",))


def check_write_routing(src, dst, lane_of, n_rows: int) -> None:
    """Raise unless a routed write batch is race-free on the GPU: every lane
    not parked on the dump row (``n_rows - 1``) names a distinct in-range
    ``dst``, no lane's ``src`` is another lane's ``dst``, dump lanes have
    ``src == dst`` and no payload, and ``lane_of`` names real lanes. Reads
    the batch back to the host: a debug check, off on the hot path."""
    dump = n_rows - 1
    s, t, lo = (x.cpu() for x in (src, dst, lane_of))
    b = t.shape[0]
    live = t != dump
    parked = ~live
    if bool(((t < 0) | (t >= n_rows) | (s < 0) | (s >= n_rows)).any()):
        raise ValueError("dbs_rw_write routing: extent id out of range")
    if bool((parked & ((s != dump) | (lo >= 0).any(1))).any()):
        raise ValueError("dbs_rw_write routing: a dump-row lane must have "
                         "src == dst and no payload")
    if bool(((lo < -1) | (lo >= b)).any()):
        raise ValueError("dbs_rw_write routing: lane_of out of range")
    tl = t[live]
    if tl.unique().numel() != tl.numel():
        raise ValueError("dbs_rw_write routing: two lanes write one row")
    other = live[None, :] & (s[:, None] == t[None, :]) & ~torch.eye(
        b, dtype=torch.bool)
    if bool((live[:, None] & other).any()):
        raise ValueError("dbs_rw_write routing: a lane reads a row that "
                         "another lane writes")


def dbs_rw_write(pool, src, dst, lane_of, payload, *,
                 check_routing: bool = False):
    """pool: (E, page, D) of a 1-, 2-, 4- or 8-byte dtype, updated in
    place and returned; src/dst: (B,) int32 extent ids; lane_of: (B, page)
    int32 block -> payload lane (-1 keeps the source block); payload: (B, D)
    of the pool's dtype.

    src/dst must be pre-routed (ops.py ``_route_writes``): every live row is
    named by exactly one lane, no lane reads a row another lane writes, and
    inert lanes point src == dst at the dump row (the last row).
    ``check_routing=True`` verifies that contract first (host sync)."""
    e, page, d = pool.shape
    b = src.shape[0]
    dev = pool.device
    check_pool_dtype("pool", pool)
    _check("pool", pool, pool.dtype, (e, page, d), dev)
    _check("src", src, torch.int32, (b,), dev)
    _check("dst", dst, torch.int32, (b,), dev)
    _check("lane_of", lane_of, torch.int32, (b, page), dev)
    _check("payload", payload, pool.dtype, (b, d), dev)
    if check_routing:
        check_write_routing(src, dst, lane_of, e)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"dbs_rw_write: no kernel for device {dev}")
    entry(torch.ops.repro_torch.dbs_rw_write.default, _write, pool, src, dst,
          lane_of, payload)
    return pool


def _write(pool, src, dst, lane_of, payload) -> None:
    """The write launch (the CPU's plain version), in place."""
    e, page, d = pool.shape
    b = src.shape[0]
    dev = pool.device
    if dev.type == "cpu":
        PLAIN_CALLS["dbs_rw_write"] += 1
        dbs_rw_write_ref(pool, src, dst, lane_of, payload)     # in place
        return
    lib = library("dbs_rw")
    nbytes = d * pool.element_size()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dbs_rw_write(pool.data_ptr(), src.data_ptr(),
                               dst.data_ptr(), lane_of.data_ptr(),
                               payload.data_ptr(), b, e, page, nbytes,
                               word_bytes(nbytes, pool, payload), stream)
    raise_on(err, "dbs_rw_write")
    LAUNCHES["dbs_rw_write"] += 1


def dbs_rw_read(pool, ext, block):
    """pool: (E, page, D) of a 1-, 2-, 4- or 8-byte dtype; ext: (B,) int32,
    -1 = hole (reads as zeros); block: (B,) int32 block offset within the
    page. Returns (B, D) of the pool's dtype."""
    e, page, d = pool.shape
    b = ext.shape[0]
    dev = pool.device
    check_pool_dtype("pool", pool)
    _check("pool", pool, pool.dtype, (e, page, d), dev)
    _check("ext", ext, torch.int32, (b,), dev)
    _check("block", block, torch.int32, (b,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"dbs_rw_read: no kernel for device {dev}")
    return entry(torch.ops.repro_torch.dbs_rw_read.default, _read, pool, ext,
                 block)


def _read(pool, ext, block):
    """The read launch (the CPU's plain version)."""
    e, page, d = pool.shape
    b = ext.shape[0]
    dev = pool.device
    if dev.type == "cpu":
        PLAIN_CALLS["dbs_rw_read"] += 1
        return dbs_rw_read_ref(pool, ext, block)
    lib = library("dbs_rw")
    out = torch.empty((b, d), dtype=pool.dtype, device=dev)
    nbytes = d * pool.element_size()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dbs_rw_read(pool.data_ptr(), ext.data_ptr(),
                              block.data_ptr(), out.data_ptr(), b, e, page,
                              nbytes, word_bytes(nbytes, pool, out), stream)
    raise_on(err, "dbs_rw_read")
    LAUNCHES["dbs_rw_read"] += 1
    return out


# ---------------------------------------------------------------------------
# the entries as custom ops: fake implementations and bytes formulas
# ---------------------------------------------------------------------------
Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::dbs_rw_write", mutates_args=("pool",))
def _write_op(pool: Tensor, src: Tensor, dst: Tensor, lane_of: Tensor,
              payload: Tensor) -> None:
    _write(pool, src, dst, lane_of, payload)


@_write_op.register_fake
def _(pool, src, dst, lane_of, payload):
    return None


@torch.library.custom_op("repro_torch::dbs_rw_read", mutates_args=())
def _read_op(pool: Tensor, ext: Tensor, block: Tensor) -> Tensor:
    return _read(pool, ext, block)


@_read_op.register_fake
def _(pool, ext, block):
    return pool.new_empty((ext.shape[0], pool.shape[2]))


def _register_formulas():
    from repro_torch.utils.op_stats import register_bytes_formula

    @register_bytes_formula(torch.ops.repro_torch.dbs_rw_write)
    def _write_bytes(pool, src, dst, lane_of, payload, out_val=None):
        # every lane's row read and written (a CoW or a no-op dump lane at
        # most), its payload read and its ids and block map read
        row = pool.shape[1] * pool.shape[2] * pool.element_size()
        return (2 * src.shape[0] * row + payload.numel()
                * payload.element_size() + 4 * (2 * src.numel()
                                                + lane_of.numel()))

    @register_bytes_formula(torch.ops.repro_torch.dbs_rw_read)
    def _read_bytes(pool, ext, block, out_val=None):
        return 2 * ext.shape[0] * pool.shape[2] * pool.element_size() \
            + 4 * (ext.numel() + block.numel())


_register_formulas()
