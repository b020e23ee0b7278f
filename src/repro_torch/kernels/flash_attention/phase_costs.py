"""Where the flash-attention kernel's time goes, by phase (needs the card).

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.phase_costs

Builds ``csrc/flash_attention.cu`` (the fp32 form) and
``csrc/flash_attention_wgmma.cu`` (the bf16 form at d = dv 256) as they
are and in variants that each drop one phase of the key loop, then times
every build at the serving path's prefill shapes (gemma2-2b: 8 heads, 4 KV
heads, hd 256, the model layout, cap 50, causal; fp32 and bf16 inputs)
with CUDA graphs (``timing.graph_ms``), the median of 20 replays. A
variant's outputs are wrong by design; only its time counts, and the
difference to the full kernel is the phase's cost. The fp32 form's:

- ``no_qk_products`` / ``no_pv_products``: the tensor-core products of
  S = Q.K^T or O = P.V dropped (the compiler drops their operand loads and
  splits with them);
- ``no_products``: both dropped;
- ``one_product``: one TF32 product where the kernel takes three (the
  price of 3xTF32);
- ``no_kv_staging``: K/V tiles after the first not loaded.

The wgmma form's (``wgmma_*``):

- ``wgmma_no_loads``: the producer loads the first ring of K/V tiles only
  and then completes each stage's barriers with no copy;
- ``wgmma_no_qk`` / ``wgmma_no_pv``: the warpgroup products of S = Q.K^T
  or of O += P.V (both of P's parts) dropped;
- ``wgmma_no_softmax``: scale, cap, masks, the running max and sum and
  the exponentials dropped (S is split into P's parts as it is).

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

SOURCE = _build.SOURCES["flash_attention"]
WGMMA_SOURCE = _build.SOURCES["flash_attention_wgmma"]
W_LOADS = [("      mbar_expect_tx(bk, kTileBytes);\n",
            "      if (it >= n_stages) { mbar_arrive(bk); mbar_arrive(bv); "
            "continue; }\n      mbar_expect_tx(bk, kTileBytes);\n")]
W_QK = [("        wgmma_ss_n64(s, sw128(q_s + at, 16, 1024),",
         "        if (0) wgmma_ss_n64(s, sw128(q_s + at, 16, 1024),"),
        ("      float s[32];\n", "      float s[32] = {};\n")]
W_PV = [("        wgmma_pv<kD>(o, pl[u], sw128(",
         "        if (0) wgmma_pv<kD>(o, pl[u], sw128("),
        ("        wgmma_pv<kD>(o, ph[u], sw128(",
         "        if (0) wgmma_pv<kD>(o, ph[u], sw128(")]
W_SOFTMAX = ("      // scale, cap, mask; s[4i + e]",
             "      uint32_t ph[4][4], pl[4][4];")
OUT_DIR = _build.BUILD_DIR / "phase_costs"
QK = ["        for (int n = 0; n < kNT; ++n) mma(s_lo[n], qlc, bh[n]);",
      "        for (int n = 0; n < kNT; ++n) mma(s[n], qhc, bh[n]);",
      "        for (int n = 0; n < kNT; ++n) mma(s_lo[n], qhc, bl[n]);"]
PV = ["          if (grp + kGroups * (cb + c) < nkv) mma(acc[cb + c], al, bh[c]);",
      "          if (grp + kGroups * (cb + c) < nkv) mma(acc[cb + c], ah, bl[c]);",
      "          if (grp + kGroups * (cb + c) < nkv) mma(acc[cb + c], ah, bh[c]);"]
KV_STAGING = [
    "        stage<kBK, kWide>(ks + (cur ^ 1) * kBK * ss, ss, kb, kss, k1, sk, d, vec_k);",
    "        stage<kBK, kWide>(vs + (cur ^ 1) * kBK * ssv, ssv, vb, vss, k1, sk, dv, vec_v);"]
SEQ_LENS = (550, 854)       # the median prompt and the kept serving calls'


def variants(src: str) -> Dict[str, str]:
    """The kernel's source and its phase-dropping variants."""
    for line in QK + PV + KV_STAGING:
        if src.count(line) != 1:
            raise RuntimeError(f"the kernel no longer has the line {line!r}:"
                               " update phase_costs.py with it")

    def drop(lines):
        out = src
        for line in lines:
            out = out.replace(line, "        ;")
        return out

    return {"full": src, "no_qk_products": drop(QK),
            "no_pv_products": drop(PV), "no_products": drop(QK + PV),
            "one_product": drop([QK[0], QK[2], PV[0], PV[1]]),
            "no_kv_staging": drop(KV_STAGING)}


def wgmma_variants(src: str) -> Dict[str, str]:
    """The wgmma kernel's source and its phase-dropping variants."""
    for old, _new in W_LOADS + W_QK + W_PV:
        if src.count(old) != 1:
            raise RuntimeError(f"the wgmma kernel no longer has {old!r}:"
                               " update phase_costs.py with it")
    a, b = src.index(W_SOFTMAX[0]), src.index(W_SOFTMAX[1])

    def swap(pairs):
        out = src
        for old, new in pairs:
            out = out.replace(old, new)
        return out

    return {"wgmma_full": src, "wgmma_no_loads": swap(W_LOADS),
            "wgmma_no_qk": swap(W_QK), "wgmma_no_pv": swap(W_PV),
            "wgmma_no_softmax": src[:a] + "      float corr[2] = {1.f, 1.f};\n"
            + src[b:].replace("          s[i] = exp2f(s[i] - m[r]);", "")}


def build(texts: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """One nvcc per variant, all started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = []
    for name, text in texts.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        lib = OUT_DIR / f"lib{name}.so"
        procs.append((name, lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        cdll = ctypes.CDLL(str(lib))
        fn, sig = (("flash_attention_bf16_wgmma", "flash_attention_wgmma")
                   if name.startswith("wgmma") else
                   ("flash_attention", "flash_attention"))
        getattr(cdll, fn).argtypes = _build.SIGNATURES[sig][fn]
        getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = cdll
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("phase_costs: needs a CUDA device")
    libs = build({**variants(SOURCE.read_text()),
                  **wgmma_variants(WGMMA_SOURCE.read_text())})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h, kv, d, cap = 8, 4, 256, 50.0
    for s in SEQ_LENS:
        x = torch.randn((1, s, h + 2 * kv, d), generator=gen, device=dev)
        xb = x.to(torch.bfloat16)
        ms = {}
        for name, lib in libs.items():
            wg = name.startswith("wgmma")
            q, k, v = (t.transpose(1, 2) for t in (xb if wg else x).split(
                [h, kv, kv], dim=2))
            out = torch.empty((1, s, h, d), device=dev,
                              dtype=q.dtype).transpose(1, 2)
            head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    1, h, kv, s, s, d)
            strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       *out.stride()[:3])
            def run(lib=lib, wg=wg):
                st = torch.cuda.current_stream().cuda_stream
                if wg:
                    err = lib.flash_attention_bf16_wgmma(
                        *head, *strides, 1, 0, d ** -0.5, cap, st)
                else:
                    err = lib.flash_attention(*head, d, *strides, 1, 0,
                                              d ** -0.5, cap, st)
                _build.raise_on(err, name)
            ms[name] = graph_ms(run, 1)
        full_w = ms["wgmma_full"]
        print(json.dumps({
            "seq": s, "heads": h, "kv_heads": kv, "head_dim": d,
            "logit_cap": cap, "ms": ms,
            "phase_ms": {n: ms["full"] - t for n, t in ms.items()
                         if not n.startswith("wgmma") and n != "full"},
            "wgmma_phase_ms": {n: full_w - ms[n] for n in ms
                               if n.startswith("wgmma_no")}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
