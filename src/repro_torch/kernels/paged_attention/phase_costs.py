"""Where the paged-attention kernel's time goes (needs the card).

    PYTHONPATH=src python -m repro_torch.kernels.paged_attention.phase_costs

Builds ``csrc/paged_attention.cu`` as it is and in variants that each drop
one part of the call, then times every build at the zero-copy serving
path's decode shapes (gemma2-2b's 13 global layers of one step: 8 x 8 x 256
queries over planes of a (1033, 32, 26, 4, 256) pool, 64-page tables,
lengths drawn in 100-1032, cap 50) with CUDA graphs (``timing.graph_ms``),
the median of 20 replays per call, at the split count the wrapper picks
and at others. A variant's outputs are wrong by design; only its time
counts:

- ``no_merge``: the merge kernel not launched;
- ``no_loads``: no K/V tile copied (the softmax runs on what shared memory
  holds);
- ``no_math``: the logits, softmax and accumulation of every tile dropped
  (the copies are still waited for).

Prints one JSON line per split count and the card's name and power limit.
The variants are built under ``build/torch_kernels/phase_costs/``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.kernel import (paged_row_groups,
                                                        paged_splits, sm_count)
from repro_torch.kernels.timing import graph_ms

SOURCE = _build.SOURCES["paged_attention"]
OUT_DIR = _build.BUILD_DIR / "phase_costs"
MERGE = ["  cudaLaunchKernelEx(&cfg, merge_kernel<TO>, partials, out, h, kv, "
         "dv,"]
LOADS = ["    cp_commit();\n  };"]
MATH = ["    const int base = list_ip[li] * page;"]
SPLITS = (1, 4, 8, 16, 24, 32)


def variants(src: str) -> Dict[str, str]:
    """The kernel's source and its part-dropping variants."""
    for text in MERGE + LOADS + MATH:
        if src.count(text) != 1:
            raise RuntimeError(f"the kernel no longer has the text {text!r}:"
                               " update phase_costs.py with it")
    loads = src.index("  auto issue = [&](int j) {")
    body = src.index("    const int li = j / tpp;", loads)
    return {
        "full": src,
        "no_merge": src.replace(MERGE[0], "  if (0) " + MERGE[0].lstrip()),
        "no_loads": src[:body] + "    (void)j;\n" + src[
            src.index(LOADS[0]):],
        "no_math": src.replace(MATH[0], MATH[0] + "\n    continue;")}


def build(texts: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """One nvcc per variant, all started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = []
    for name, text in texts.items():
        cu = OUT_DIR / f"paged_{name}.cu"
        cu.write_text(text)
        lib = OUT_DIR / f"libpaged_{name}.so"
        procs.append((name, lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        cdll = ctypes.CDLL(str(lib))
        cdll.paged_attention.argtypes = _build.SIGNATURES[
            "paged_attention"]["paged_attention"]
        cdll.paged_attention.restype = ctypes.c_int
        libs[name] = cdll
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("phase_costs: needs a CUDA device")
    libs = build(variants(SOURCE.read_text()))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    e, page, n_planes, kv, d, b, h, p_max = 1033, 32, 26, 4, 256, 8, 8, 64
    pool = torch.randn((e, page, n_planes, kv, d), generator=gen,
                       device=dev)
    calls = []
    for layer in range(13):
        lengths = torch.randint(100, 1033, (b,), generator=gen, device=dev,
                                dtype=torch.int32)
        perm = torch.randperm(e - 1, generator=gen, device=dev)[:b * p_max]
        cols = torch.arange(p_max, device=dev)[None, :]
        table = torch.where(cols < ((lengths + page - 1) // page)[:, None],
                            perm.view(b, p_max), -1).to(torch.int32)
        q = torch.randn((b, h, d), generator=gen, device=dev)
        calls.append((q, table, lengths, 2 * layer, 2 * layer + 1))
    live = sum(int(((c[1] >= 0).sum())) for c in calls) / len(calls)
    n_bytes = 2 * live * page * kv * d * 4
    tok = n_planes * kv * d
    out = torch.empty((b, h, d), device=dev)
    picked = paged_splits(p_max, b * kv * paged_row_groups(h, kv),
                          sm_count(dev), h // kv)
    for n_split in sorted(set(SPLITS + (picked,))):
        part = torch.empty((b, kv, n_split, h // kv, d + 2), device=dev)
        ms = {}
        for name, lib in libs.items():
            def run(lib=lib):
                st = torch.cuda.current_stream().cuda_stream
                for q, table, lengths, kp, vp in calls:
                    err = lib.paged_attention(
                        q.data_ptr(), pool.data_ptr() + kp * kv * d * 4,
                        pool.data_ptr() + vp * kv * d * 4, table.data_ptr(),
                        lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
                        b, h, kv, d, d, p_max, page, e, page * tok, tok,
                        page * tok, tok, 0, d ** -0.5, 50.0, n_split, st)
                    _build.raise_on(err, "paged_attention")
            ms[name] = graph_ms(run, len(calls))
        print(json.dumps({"splits": n_split, "picked": n_split == picked,
                          "bytes_per_call": n_bytes, "ms": ms,
                          "part_ms": {n: ms["full"] - t for n, t in ms.items()
                                      if n != "full"}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
