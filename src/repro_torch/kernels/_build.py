"""Build and load the port's CUDA sources, one shared library per source.

Every ``.cu`` file of the port has a plain C interface; this module
compiles each at first use with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/lib<name>.so`` under the repository root, from the
sources in this package only, and loads it with ``ctypes``. A library is
rebuilt when its source is newer than it. ``build_all`` starts one ``nvcc``
per source together, so a cold start waits for the slowest source, not
their sum. ``nvcc`` failures raise. Nothing here runs at import time.

Register a source in ``SOURCES`` and its C entry points in ``SIGNATURES``.
``check_tensor``, ``refuse_grad`` and ``raise_on`` are the wrappers'
shared launch checks.

Every wrapper is also a ``torch.library`` custom op (``repro_torch::<name>``)
with a fake implementation, a FLOP formula in ``torch.utils.flop_counter``
and a bytes formula in ``utils/op_stats.py``. ``entry`` routes a call
through the op while a dispatch mode is on the stack (the counting mode of
``utils/op_stats.py``, ``FakeTensorMode``, ``FlopCounterMode``), which then
sees the launch as one op, counted as itself, and when an argument is a
tensor subclass (a DTensor: the op's sharding rule, ``launch/specs.py``,
runs the launch on the local shards); on plain tensors with no mode on the
stack it calls the launch directly, so the serving paths pay no dispatch.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

KERNELS = Path(__file__).resolve().parent
BUILD_DIR = KERNELS.parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SOURCES: Dict[str, Path] = {
    "dbs_rw": KERNELS / "dbs" / "csrc" / "dbs_rw.cu",
    "dbs_copy": KERNELS / "dbs" / "csrc" / "dbs_copy.cu",
    "paged_attention": KERNELS / "paged_attention" / "csrc"
    / "paged_attention.cu",
    # the bf16 and fp16 forms: paged_attention.cu again, a library each
    "paged_attention_bf16": KERNELS / "paged_attention" / "csrc"
    / "paged_attention_bf16.cu",
    "paged_attention_f16": KERNELS / "paged_attention" / "csrc"
    / "paged_attention_f16.cu",
    "flash_attention": KERNELS / "flash_attention" / "csrc"
    / "flash_attention.cu",
    # flash's bf16 form at d = dv in {64, 128, 256} on wgmma and TMA, and
    # its fp16 form (the same source, a library of its own)
    "flash_attention_wgmma": KERNELS / "flash_attention" / "csrc"
    / "flash_attention_wgmma.cu",
    "flash_attention_wgmma_f16": KERNELS / "flash_attention" / "csrc"
    / "flash_attention_wgmma_f16.cu",
    # flash's fp32 form at d = dv in {64, 128, 256}: 3xTF32 on wgmma, TMA
    "flash_attention_wgmma_f32": KERNELS / "flash_attention" / "csrc"
    / "flash_attention_wgmma_f32.cu",
    "rwkv6_scan": KERNELS / "rwkv6_scan" / "csrc" / "rwkv6_scan.cu",
}

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes (every entry returns its cudaError_t as an int);
# pointers and the stream are c_void_p, or ctypes would cut them to 32 bits
SIGNATURES: Dict[str, Dict[str, list]] = {
    "dbs_rw": {
        # pool, src, dst, lane_of, payload; n_lanes, n_rows, page, block
        # bytes, word (bytes an access); stream
        "dbs_rw_write": [_vp] * 5 + [_ci] * 5 + [_vp],
        # pool, ext, block, out; n_lanes, n_rows, page, block bytes, word;
        # stream
        "dbs_rw_read": [_vp] * 4 + [_ci] * 5 + [_vp],
        # word; int[5] out (registers, static and dynamic shared memory,
        # blocks per SM, threads)
        "dbs_rw_write_info": [_ci, _vp],
        # n_lanes, block bytes, word; int[6] out (as dbs_rw_write_info,
        # then blocks in the grid)
        "dbs_rw_read_info": [_ci] * 3 + [_vp],
    },
    "dbs_copy": {
        # pool, src, dst, mask; mask_i32, n_lanes, n_rows; row bytes
        # (64-bit); word; stream
        "dbs_copy": [_vp] * 4 + [_ci] * 3 + [ctypes.c_int64, _ci, _vp],
        # n_lanes, row bytes (64-bit), word; int[6] out (as
        # dbs_rw_read_info)
        "dbs_copy_info": [_ci, ctypes.c_int64, _ci, _vp],
    },
    "paged_attention": {
        # q, k, v, table, lengths, out, partials (or null); b, h, kv, d,
        # dv, p_max, page, n_rows; K row, K token, V row, V token strides
        # (elements, 64-bit); window; scale, logit_cap; n_split; stream
        "paged_attention": [_vp] * 7 + [_ci] * 8 + [ctypes.c_int64] * 4
        + [_ci, _cf, _cf, _ci, _vp],
        # g, d, dv, vec_k, vec_v, p_max, n_split; int[8] out (registers,
        # static and dynamic shared memory, blocks per SM, threads, the
        # merge kernel's registers, positions a tile, query rows a block)
        "paged_attention_info": [_ci] * 7 + [_vp],
    },
    "paged_attention_bf16": {
        # paged_attention's arguments with q and out bf16, then kv_bf16
        # (the pools bf16, else fp32) before the stream
        "paged_attention_bf16": [_vp] * 7 + [_ci] * 8
        + [ctypes.c_int64] * 4 + [_ci, _cf, _cf, _ci, _ci, _vp],
        # paged_attention_info's, kv_bf16 before the out array
        "paged_attention_bf16_info": [_ci] * 8 + [_vp],
    },
    "paged_attention_f16": {
        # paged_attention_bf16's, q and out fp16 (kv_f16: the pools fp16)
        "paged_attention_f16": [_vp] * 7 + [_ci] * 8
        + [ctypes.c_int64] * 4 + [_ci, _cf, _cf, _ci, _ci, _vp],
        "paged_attention_f16_info": [_ci] * 8 + [_vp],
    },
    "flash_attention": {
        # q, k, v, out; b, h, kv, sq, sk, d, dv; q/k/v/o strides (batch,
        # head, seq; elements, 64-bit); causal, window; scale, logit_cap;
        # stream
        "flash_attention": [_vp] * 4 + [_ci] * 7 + [ctypes.c_int64] * 12
        + [_ci, _ci, _cf, _cf, _vp],
        # the same, q, k, v and out bf16; and fp16
        "flash_attention_bf16": [_vp] * 4 + [_ci] * 7
        + [ctypes.c_int64] * 12 + [_ci, _ci, _cf, _cf, _vp],
        "flash_attention_f16": [_vp] * 4 + [_ci] * 7
        + [ctypes.c_int64] * 12 + [_ci, _ci, _cf, _cf, _vp],
        # d, dv; int[6] out (registers, static and dynamic shared memory,
        # blocks per SM, threads, query rows per block); of each form
        "flash_attention_info": [_ci, _ci, _vp],
        "flash_attention_bf16_info": [_ci, _ci, _vp],
        "flash_attention_f16_info": [_ci, _ci, _vp],
    },
    "flash_attention_wgmma": {
        # q, k, v, out; b, h, kv, sq, sk, d; q/k/v/o strides (batch, head,
        # seq; elements, 64-bit); causal, window; scale, logit_cap; stream
        "flash_attention_bf16_wgmma": [_vp] * 4 + [_ci] * 6
        + [ctypes.c_int64] * 12 + [_ci, _ci, _cf, _cf, _vp],
        # d; int[7] out (flash_attention_info's, then K/V stages)
        "flash_attention_bf16_wgmma_info": [_ci, _vp],
    },
    "flash_attention_wgmma_f16": {
        # the same, q, k, v and out fp16
        "flash_attention_f16_wgmma": [_vp] * 4 + [_ci] * 6
        + [ctypes.c_int64] * 12 + [_ci, _ci, _cf, _cf, _vp],
        "flash_attention_f16_wgmma_info": [_ci, _vp],
    },
    "flash_attention_wgmma_f32": {
        # the bf16 wgmma entry's arguments, q, k, v and out fp32, then the
        # parts' scratch and counters (or null) and the parts a 64-row tile
        # takes before the stream
        "flash_attention_f32_wgmma": [_vp] * 4 + [_ci] * 6
        + [ctypes.c_int64] * 12 + [_ci, _ci, _cf, _cf, _vp, _vp, _ci, _vp],
        # d; int[8] out (the bf16 wgmma info's, then keys a K/V tile)
        "flash_attention_f32_wgmma_info": [_ci, _vp],
    },
    "rwkv6_scan": {
        # r, k, v, logw, u, s0 (or null), y, s_out; b, seq, h, d, chunk;
        # r/k/v/logw/y strides (batch, seq, head; elements, 64-bit); in_type
        # (r, k, v, logw and y: 0 fp32, 1 bf16, 2 fp16), u_type; stream
        "rwkv6_scan": [_vp] * 8 + [_ci] * 5 + [ctypes.c_int64] * 15
        + [_ci, _ci, _vp],
        # b, seq, h, d, chunk, in_type; int[8] out (schedule, column blocks,
        # grid blocks, threads, registers, static and dynamic shared memory,
        # blocks per SM)
        "rwkv6_scan_info": [_ci] * 6 + [_vp],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def _fresh(name: str) -> bool:
    """The library is newer than its source, every ``.cu``/``.cuh`` beside
    it (a source may include its neighbours) and the shared headers of
    ``kernels/csrc``."""
    lib = library_path(name)
    src = SOURCES[name]
    newest = max(p.stat().st_mtime for p in [
        src, *src.parent.glob("*.cu"), *src.parent.glob("*.cuh"),
        *(KERNELS / "csrc").glob("*.cuh")])
    return lib.is_file() and lib.stat().st_mtime >= newest


def build_all(names: Optional[Iterable[str]] = None,
              force: bool = False) -> Dict[str, Path]:
    """Compile every named library (all of ``SOURCES`` by default) that is
    missing, stale, or ``force``: one ``nvcc`` per source, all started
    together. Records each compile's wall time in ``build_seconds`` and
    ``nvcc``'s output (registers, shared memory, spills per kernel) in
    ``build_log``. Raises if any compile fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if force or not _fresh(n)]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs: List = []
        for n in todo:
            tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
            procs.append((n, tmp, time.perf_counter(), subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for n, tmp, t0, proc in procs:
            out, _ = proc.communicate()
            build_seconds[n] = time.perf_counter() - t0
            build_log[n] = out
            if proc.returncode != 0:
                failed.append(f"{n}: nvcc failed ({proc.returncode}):\n{out}")
            else:
                os.replace(tmp, library_path(n))
        if failed:
            raise RuntimeError("\n".join(failed))
    return {n: library_path(n) for n in names}


def build(name: str, force: bool = False) -> Path:
    """Compile one library if needed (see ``build_all``)."""
    return build_all([name], force=force)[name]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed, with
    its entry points' argtypes set."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _ci
        _libs[name] = lib
    return lib


def build_variant(name: str, tag: str, source: Path) -> ctypes.CDLL:
    """Build a second library of source ``name`` from ``source`` (another
    checkout's copy of ``SOURCES[name]``) into ``BUILD_DIR/<tag>/`` and
    load it with the entry points of ``name`` that it has: a build to time
    beside the first. Raises if nvcc fails."""
    out = BUILD_DIR / tag
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / f"lib{name}.so"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(lib_path), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tag}/{name}: nvcc failed ({proc.returncode}):"
                           f"\n{proc.stdout}")
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in SIGNATURES[name].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _ci
    return lib


def kernel_info(name: str, fn: str, args, keys) -> Dict[str, int]:
    """Call a source's ``<kernel>_info(*args, int* out)`` entry, which fills
    ``len(keys)`` ints from ``cudaFuncGetAttributes`` and the occupancy
    calculator, and name them."""
    out = (ctypes.c_int * len(keys))()
    raise_on(getattr(library(name), fn)(*args, ctypes.addressof(out)), fn)
    return dict(zip(keys, out))


def raise_on(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronise does not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def check_tensor(name: str, t, dtype, shape, device,
                 contiguous: bool = True) -> None:
    """Raise unless ``t`` has the dtype, shape and device a kernel takes
    (and is contiguous, unless the kernel takes explicit strides)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


WORDS = (16, 8, 4, 2, 1)            # the DBS kernels' access widths


def word_bytes(nbytes: int, *tensors) -> int:
    """The widest access, in bytes, that divides ``nbytes`` (a row's or a
    block's) and every tensor's base address: the word the DBS kernels move
    a dtype's bytes in (16 for fp32 rows of 4k floats, 2 for an odd count
    of bf16)."""
    for w in WORDS:
        if nbytes % w == 0 and all(t.data_ptr() % w == 0 for t in tensors):
            return w
    return 1


def check_pool_dtype(name: str, t) -> None:
    """Raise unless ``t``'s elements are 1, 2, 4 or 8 bytes: the DBS
    kernels copy any such dtype bit for bit, as the TPU kernels do."""
    if t.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"{name}: {t.dtype} has {t.element_size()}-byte "
                        "elements; the DBS kernels take 1, 2, 4 or 8")


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and an input requires grad: the kernels
    have no backward (nor has the reference's Pallas kernel), and an output
    without a ``grad_fn`` would drop those inputs' gradients silently. On
    the CPU as on the card: the check comes before any launch."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise ValueError(f"{name}: the kernel has no backward; train on a "
                         "plain attn_impl ('chunked' or 'dense')")


def dispatching() -> bool:
    """True while a dispatch mode is on the stack."""
    import torch
    return torch._C._len_torch_dispatch_stack() > 0


def subclassed(args) -> bool:
    """True when a tensor among ``args`` is a tensor subclass (a DTensor, a
    fake tensor), which only the op can take apart."""
    import torch
    return any(isinstance(a, torch.Tensor)
               and type(a) not in (torch.Tensor, torch.nn.Parameter)
               for a in args)


def entry(op, impl, *args):
    """``op(*args)`` while a dispatch mode is on the stack or an argument
    is a tensor subclass, else ``impl(*args)``: the same launch either way
    (see the module note)."""
    return op(*args) if dispatching() or subclassed(args) else impl(*args)


def known(*tensors) -> bool:
    """True when every tensor's values can be read: none is a fake or a
    meta tensor (a data-dependent formula then counts this run's data)."""
    from torch._subclasses.fake_tensor import is_fake
    return all(t is None or not (is_fake(t) or t.device.type == "meta")
               for t in tensors)
