"""Where the RWKV-6 prefill kernel's time goes, by phase (needs the card).

    PYTHONPATH=src python -m repro_torch.kernels.rwkv6_scan.phase_costs

Builds ``csrc/rwkv6_scan.cu`` as it is and in variants that each drop one
phase of the prefill schedule's chunk loop, then times every build at the
serving path's prefill shape (rwkv6-3b: B 1, H 40, hd 64, chunk 64, the
traffic's mean of 497 tokens and a 1000-token prompt) with CUDA graphs
(``timing.graph_ms``), the median of 20 replays. A variant's outputs are
wrong by design; only its time counts, and the difference to the full
kernel is the phase's cost:

- ``no_diagonal``: the diagonal sub-blocks' pairwise-decay sums and the
  quadrant product dropped;
- ``no_factors``: rt and kh not written (their exps and stores);
- ``no_products``: every tensor-core product dropped (the compiler drops
  their operand loads and splits with them);
- ``one_product``: one TF32 product where the kernel takes three (the
  price of 3xTF32);
- ``no_staging``: chunks after the first not loaded.

Prints one JSON line per sequence length and the card's name and power
limit. The variants are built under ``build/torch_kernels/phase_costs/``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.timing import graph_ms

SOURCE = _build.SOURCES["rwkv6_scan"]
OUT_DIR = _build.BUILD_DIR / "phase_costs"
DIAGONAL = ["    if (wa < nsub) {\n      const int r0 = wa * kSub;"]
FACTORS = ["        RT[i] = R[i] * __expf(q ? lc[q - 1] : 0.f);",
           "        KH[i] = K[i] * __expf(lc[kSub - 1] - lc[q]);"]
PRODUCTS = ["  mma(lo, al, bh);\n  mma(hi, ah, bh);\n  mma(lo, ah, bl);"]
STAGING = ["    if (ci + 1 < n_chunks) {             // stage the next chunk"]
SEQ_LENS = (497, 1000)


def variants(src: str) -> Dict[str, str]:
    """The kernel's source and its phase-dropping variants."""
    for line in DIAGONAL + FACTORS + PRODUCTS + STAGING:
        if src.count(line) != 1:
            raise RuntimeError(f"the kernel no longer has the text {line!r}:"
                               " update phase_costs.py with it")
    return {
        "full": src,
        "no_diagonal": src.replace(DIAGONAL[0], DIAGONAL[0].replace(
            "wa < nsub", "false")),
        "no_factors": src.replace(FACTORS[0], "        ;").replace(
            FACTORS[1], "        ;"),
        "no_products": src.replace(PRODUCTS[0], ""),
        "one_product": src.replace(PRODUCTS[0], "  mma(hi, ah, bh);"),
        "no_staging": src.replace(STAGING[0], STAGING[0].replace(
            "ci + 1 < n_chunks", "false"))}


def build(texts: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """One nvcc per variant, all started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = []
    for name, text in texts.items():
        cu = OUT_DIR / f"rwkv6_{name}.cu"
        cu.write_text(text)
        lib = OUT_DIR / f"librwkv6_{name}.so"
        procs.append((name, lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        cdll = ctypes.CDLL(str(lib))
        cdll.rwkv6_scan.argtypes = _build.SIGNATURES["rwkv6_scan"][
            "rwkv6_scan"]
        cdll.rwkv6_scan.restype = ctypes.c_int
        libs[name] = cdll
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("phase_costs: needs a CUDA device")
    libs = build(variants(SOURCE.read_text()))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h, d = 40, 64
    for s in SEQ_LENS:
        r, k, v = (torch.randn((1, s, h, d), generator=gen, device=dev)
                   for _ in range(3))
        logw = -torch.exp(torch.randn((1, s, h, d), generator=gen,
                                      device=dev) * 0.5 - 1.0)
        u = torch.randn((h, d), generator=gen, device=dev) * 0.1
        y = torch.empty_like(r)
        s_out = torch.empty((1, h, d, d), device=dev)
        ms = {}
        for name, lib in libs.items():
            def run(lib=lib):
                strides = [x for t in (r, k, v, logw, y)
                           for x in t.stride()[:3]]
                err = lib.rwkv6_scan(
                    r.data_ptr(), k.data_ptr(), v.data_ptr(),
                    logw.data_ptr(), u.data_ptr(), None, y.data_ptr(),
                    s_out.data_ptr(), 1, s, h, d, 64, *strides, 0, 0,
                    torch.cuda.current_stream().cuda_stream)
                _build.raise_on(err, "rwkv6_scan")
            ms[name] = graph_ms(run, 1)
        print(json.dumps({"seq": s, "heads": h, "head_dim": d, "ms": ms,
                          "phase_ms": {n: ms["full"] - t for n, t in ms.items()
                                       if n != "full"}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
