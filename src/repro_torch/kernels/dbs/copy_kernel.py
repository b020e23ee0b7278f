"""``dbs_copy``: wrapper of the hand-written CUDA CoW extent-copy kernel.

Port of ``repro/kernels/dbs/copy_kernel.py``; the kernel lives in
``csrc/dbs_copy.cu`` (the source note there gives its bound and design),
built at first use by ``kernels/_build.py``. The wrapper checks device,
dtype, shape and contiguity, then launches the kernel for a tensor on a
CUDA device or calls the plain version (kernels/dbs/ref.py
``dbs_copy_ref``) for a tensor on the CPU. A CUDA tensor gets the kernel or
an error, never the plain version. The pool may be of any dtype of 1, 2, 4
or 8 bytes, as the TPU kernel's: the kernel copies a row's bytes in the
widest word that divides them and the pool's alignment (``word_bytes``).

``LAUNCHES`` counts kernel launches, ``LAUNCHES_BY_DTYPE`` splits them by
the pool's dtype, and ``PLAIN_CALLS`` counts the wrapper's calls of the
plain version, so a run can show which path it went through.

The entry is a custom op (``repro_torch::dbs_copy``, which mutates the
pool; ``_build.py entry``): no FLOPs, and each lane's row read and written.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels._build import check_pool_dtype
from repro_torch.kernels._build import check_tensor as _check
from repro_torch.kernels._build import (entry, kernel_info, library,
                                        raise_on, word_bytes)
from repro_torch.kernels.dbs.ref import dbs_copy_ref

LAUNCHES: Dict[str, int] = {"dbs_copy": 0}
LAUNCHES_BY_DTYPE: Dict[str, int] = {"float32": 0, "bfloat16": 0,
                                     "float16": 0, "uint8": 0}
PLAIN_CALLS: Dict[str, int] = {"dbs_copy": 0}
MAX_LANES = 65535            # lanes a call may carry


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS, LAUNCHES_BY_DTYPE):
        for k in counts:
            counts[k] = 0


def copy_info(n_lanes: int, row_bytes: int, word: int = 16
              ) -> Dict[str, int]:
    """The CUDA copy kernel's registers, shared memory, resident blocks per
    SM, threads per block, and the grid blocks it takes for ``n_lanes``
    lanes of ``row_bytes``-byte rows in ``word``-byte accesses (needs the
    card)."""
    return kernel_info("dbs_copy", "dbs_copy_info",
                       (n_lanes, row_bytes, word),
                       ("registers", "static_smem_bytes",
                        "dynamic_smem_bytes", "blocks_per_sm", "threads",
                        "grid_blocks"))


def check_copy_routing(src, dst, mask, n_rows: int) -> None:
    """Raise unless a copy batch is race-free on the GPU: every live lane
    names an in-range ``src`` and ``dst``, live lanes have distinct ``dst``,
    and no live lane's ``src`` is another live lane's ``dst``. Reads the
    batch back to the host: a debug check, off on the hot path."""
    s, t, m = src.cpu(), dst.cpu(), mask.cpu().bool()
    if bool((m & ((s < 0) | (s >= n_rows) | (t < 0) | (t >= n_rows)))
            .any()):
        raise ValueError("dbs_copy routing: a live lane's extent id is out "
                         "of range")
    tl = t[m]
    if tl.unique().numel() != tl.numel():
        raise ValueError("dbs_copy routing: two live lanes write one row")
    other = (m[:, None] & m[None, :] & (s[:, None] == t[None, :])
             & ~torch.eye(s.shape[0], dtype=torch.bool))
    if bool(other.any()):
        raise ValueError("dbs_copy routing: a live lane reads a row that "
                         "another live lane writes")


def dbs_copy(pool, src, dst, mask, *, check_routing: bool = False):
    """pool: (E, page, D) of a 1-, 2-, 4- or 8-byte dtype, updated in
    place and returned; src/dst: (N,) int32 extent ids; mask: (N,) bool or
    int32, nonzero = copy.

    ``pool[dst[i]] = pool[src[i]]`` for every live lane (``mask[i]`` and
    both ids in ``[0, E)``); every other lane touches nothing. Live lanes
    must have distinct ``dst`` and read no row another live lane writes
    (``dbs.write_pages`` guarantees both). ``check_routing=True`` verifies
    that contract first (host sync)."""
    e, page, d = pool.shape
    n = src.shape[0]
    dev = pool.device
    check_pool_dtype("pool", pool)
    _check("pool", pool, pool.dtype, (e, page, d), dev)
    _check("src", src, torch.int32, (n,), dev)
    _check("dst", dst, torch.int32, (n,), dev)
    if mask.dtype not in (torch.bool, torch.int32):
        raise TypeError(f"mask: expected bool or int32, got {mask.dtype}")
    _check("mask", mask, mask.dtype, (n,), dev)
    if check_routing:
        check_copy_routing(src, dst, mask, e)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"dbs_copy: no kernel for device {dev}")
    if dev.type == "cuda" and n > MAX_LANES:
        raise ValueError(f"dbs_copy: {n} lanes, at most {MAX_LANES}")
    entry(torch.ops.repro_torch.dbs_copy.default, _copy, pool, src, dst, mask)
    return pool


def _copy(pool, src, dst, mask) -> None:
    """The launch (the CPU's plain version), in place."""
    e, page, d = pool.shape
    n = src.shape[0]
    dev = pool.device
    if dev.type == "cpu":
        PLAIN_CALLS["dbs_copy"] += 1
        dbs_copy_ref(pool, src, dst, mask)                     # in place
        return
    if n == 0:
        return
    lib = library("dbs_copy")
    row_bytes = page * d * pool.element_size()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dbs_copy(pool.data_ptr(), src.data_ptr(), dst.data_ptr(),
                           mask.data_ptr(), int(mask.dtype == torch.int32),
                           n, e, row_bytes, word_bytes(row_bytes, pool),
                           stream)
    raise_on(err, "dbs_copy")
    LAUNCHES["dbs_copy"] += 1
    key = str(pool.dtype).split(".")[1]
    LAUNCHES_BY_DTYPE[key] = LAUNCHES_BY_DTYPE.get(key, 0) + 1


# ---------------------------------------------------------------------------
# the entry as a custom op: fake implementation and bytes formula
# ---------------------------------------------------------------------------
Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::dbs_copy", mutates_args=("pool",))
def _copy_op(pool: Tensor, src: Tensor, dst: Tensor, mask: Tensor) -> None:
    _copy(pool, src, dst, mask)


@_copy_op.register_fake
def _(pool, src, dst, mask):
    return None


def _register_formulas():
    from repro_torch.utils.op_stats import register_bytes_formula

    @register_bytes_formula(torch.ops.repro_torch.dbs_copy)
    def _copy_bytes(pool, src, dst, mask, out_val=None):
        # every lane's row read and written (masked lanes at most), its ids
        # and mask read
        row = pool.shape[1] * pool.shape[2] * pool.element_size()
        return 2 * src.shape[0] * row + 4 * 2 * src.numel() \
            + mask.numel() * mask.element_size()


_register_formulas()
