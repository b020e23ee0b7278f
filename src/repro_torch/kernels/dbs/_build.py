"""Build and load ``csrc/dbs_rw.cu`` as a shared library with a C interface.

The library is compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/libdbs_rw.so`` under the repository root, from the
sources in this package only, and loaded with ``ctypes``. It is rebuilt when
the source is newer than the library. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "csrc" / "dbs_rw.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "libdbs_rw.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the dbs_rw CUDA "
                       "kernels are built from source at first use")


def build(force: bool = False) -> Path:
    """Compile the library if it is missing, stale, or ``force``. Records
    the compile time in ``build_seconds`` and ``nvcc``'s output (register
    and shared-memory use per kernel) in ``build_log``."""
    global build_seconds, build_log
    if (not force and LIBRARY.is_file()
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dbs_rw_write.argtypes = [vp] * 5 + [ci] * 5 + [vp]
        lib.dbs_rw_write.restype = ci
        lib.dbs_rw_read.argtypes = [vp] * 4 + [ci] * 5 + [vp]
        lib.dbs_rw_read.restype = ci
        _lib = lib
    return _lib
