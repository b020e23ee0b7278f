"""Where the flash-attention kernel's time goes, by phase (needs the card).

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.phase_costs

Builds ``csrc/flash_attention.cu`` (the fp32 mma.sync form),
``csrc/flash_attention_wgmma.cu`` (the bf16 form at d = dv 256) and
``csrc/flash_attention_wgmma_f32.cu`` (the fp32 wgmma form) as they are
and in variants that each drop one phase of the key loop, then times every
build at the serving path's prefill shapes (gemma2-2b: 8 heads, 4 KV
heads, hd 256, the model layout, cap 50, causal; fp32 and bf16 inputs;
the fp32 wgmma form and the fp32 mma.sync one also at musicgen-large's:
32 heads on 32 KV heads of 64, no cap) with CUDA graphs
(``timing.graph_ms``), the median of 20 replays. A variant's outputs are wrong by design; only its time counts,
and the difference to the full kernel is the phase's cost. The mma.sync
fp32 form's:

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

The fp32 wgmma form's (``f32_*``):

- ``f32_no_loads``: as ``wgmma_no_loads`` (the TMA waits all but gone);
- ``f32_no_qk`` / ``f32_no_pv``: the three products of S = Q.K^T, or of
  O += P.V, dropped;
- ``f32_no_softmax``: scale, cap, masks, the running max and sum and the
  exponentials dropped (S is split into P's parts as it is);
- ``f32_no_split``: the producer's split warps make no K_lo, V^T or
  V^T_lo (they still signal each stage);
- ``f32_one_consumer``: not a phase but another schedule, at d 64: one
  consumer warpgroup takes every key tile of the 64 rows (the second
  merges an empty state); and at gemma2-2b's shapes the full build with
  each q-tile's key tiles over 1 to 4 blocks (``f32_ms_by_parts``; the
  wrapper's ``flash_parts`` picks 2 there).

Prints one JSON line per shape and the card's name and power limit.
The variants are built under ``build/torch_kernels/phase_costs/``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (data_ptr,
                                                        flash_parts,
                                                        flash_scratch)
from repro_torch.kernels.paged_attention.kernel import sm_count
from repro_torch.kernels.timing import graph_ms

SOURCE = _build.SOURCES["flash_attention"]
WGMMA_SOURCE = _build.SOURCES["flash_attention_wgmma"]
F32_SOURCE = _build.SOURCES["flash_attention_wgmma_f32"]
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
F_LOADS = [("        mbar_expect_tx(bk, kTileBytes);\n",
            "        if (it >= n_stages) { mbar_arrive(bk); mbar_arrive(bv); "
            "continue; }\n        mbar_expect_tx(bk, kTileBytes);\n")]
F_LOADS_N = [(old, new, 1) for old, new in F_LOADS]
# (old, new, count): every S product (both Q_lo paths), every P.V product
F_QK = [("wgmma_tf32<kBN>(", "if (0) wgmma_tf32<kBN>(", 6)]
F_PV = [("wgmma_tf32<kN>(", "if (0) wgmma_tf32<kN>(", 3)]
# no softmax: corr 1 and P = S as it came, split into its A fragments
F_SOFTMAX = [("softmax_tile<kBN>(", "softmax_none<kBN>(", 1),
             ("// kD: the head dim (64, 128 or 256).", """template <int kBN>
__device__ __forceinline__ void softmax_none(
    float* s, float*, float*, float* corr, uint32_t (*ph)[4],
    uint32_t (*pl)[4], int, int, int, int, int, int, int, float, float,
    float, float, int) {
  corr[0] = corr[1] = 1.f;
#pragma unroll
  for (int u = 0; u < kBN / 8; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ph[u][e] = __float_as_uint(s[4 * u + e]);
      pl[u][e] = __float_as_uint(tf32_lo(s[4 * u + e]));
    }
}

// kD: the head dim (64, 128 or 256).""", 1)]
F_SPLIT = [("        for (int i = x; i < kF4; i += kSplitThreads)",
            "        if (0) for (int i = x; i < kF4; i += kSplitThreads)", 3)]
F_DEAL = [("  for (int it = kDeal ? wg : 0; it < n_tiles; "
           "it += kDeal ? 2 : 1) {",
           "  for (int it = kDeal && wg ? n_tiles : 0; it < n_tiles; ++it) {",
           1)]
SEQ_LENS = (550, 854)       # the median prompt and the kept serving calls'
AUDIO_LENS = (768, 923)     # musicgen-large's kept prefill calls


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


def f32_variants(src: str) -> Dict[str, str]:
    """The fp32 wgmma kernel's source and its variants."""
    for old, _new, n in (F_LOADS_N + F_QK + F_PV + F_SOFTMAX + F_SPLIT
                         + F_DEAL):
        if src.count(old) != n:
            raise RuntimeError(f"the fp32 wgmma kernel no longer has {old!r}"
                               f" {n} times: update phase_costs.py with it")

    def swap(triples):
        out = src
        for old, new, _n in triples:
            out = out.replace(old, new)
        return out

    return {"f32_full": src, "f32_no_loads": swap(F_LOADS_N),
            "f32_no_qk": swap(F_QK), "f32_no_pv": swap(F_PV),
            "f32_no_softmax": swap(F_SOFTMAX),
            "f32_no_split": swap(F_SPLIT),
            "f32_one_consumer": swap(F_DEAL)}


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
            # the sources' own includes resolve from their directory
            [nvcc, *_build.NVCC_FLAGS, "-I", str(SOURCE.parent), "-o",
             str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        cdll = ctypes.CDLL(str(lib))
        fn, sig = ENTRY.get(name.split("_")[0], MMA_ENTRY)
        getattr(cdll, fn).argtypes = _build.SIGNATURES[sig][fn]
        getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = cdll
    return libs


# a variant name's first word -> (C entry, SIGNATURES key); any other
# word: the mma.sync fp32 form's
ENTRY = {"wgmma": ("flash_attention_bf16_wgmma", "flash_attention_wgmma"),
         "f32": ("flash_attention_f32_wgmma", "flash_attention_wgmma_f32")}
MMA_ENTRY = ("flash_attention", "flash_attention")


def _time(libs, names, x, h, kv, d, cap, parts=None):
    """Each named build's ms on one call: q, k, v views of ``x`` (B, S,
    heads, d) in the model layout; the fp32 wgmma form's key tiles over
    ``parts`` blocks a q-tile (default ``flash_parts``'s)."""
    s = x.shape[1]
    q, k, v = (t.transpose(1, 2) for t in x.split([h, kv, kv], dim=2))
    out = torch.empty((1, s, h, d), device=x.device,
                      dtype=x.dtype).transpose(1, 2)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, h,
            kv, s, s, d)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:3])
    parts = parts or flash_parts(1, h, s, sm_count(x.device))
    part, count = flash_scratch(1, h, s, d, parts, x.device)
    ms = {}
    for name in names:
        kind = name.split("_")[0]
        fn = getattr(libs[name], ENTRY.get(kind, MMA_ENTRY)[0])
        dims = head if kind in ("wgmma", "f32") else (*head, d)
        tail = ((data_ptr(part), data_ptr(count), parts) if kind == "f32"
                else ())

        def run(fn=fn, dims=dims, tail=tail, name=name):
            st = torch.cuda.current_stream().cuda_stream
            _build.raise_on(fn(*dims, *strides, 1, 0, d ** -0.5, cap, *tail,
                               st), name)
        ms[name] = graph_ms(run, 1)
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("phase_costs: needs a CUDA device")
    libs = build({**variants(SOURCE.read_text()),
                  **wgmma_variants(WGMMA_SOURCE.read_text()),
                  **f32_variants(F32_SOURCE.read_text())})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def phases(ms, full, prefix):
        return {n: ms[full] - ms[n] for n in ms
                if n.startswith(prefix) and n != full}
    h, kv, d, cap = 8, 4, 256, 50.0
    for s in SEQ_LENS:
        x = torch.randn((1, s, h + 2 * kv, d), generator=gen, device=dev)
        ms = _time(libs, [n for n in libs if not n.startswith("wgmma")
                          and n != "f32_one_consumer"], x, h, kv, d, cap)
        ms.update(_time(libs, [n for n in libs if n.startswith("wgmma")],
                        x.to(torch.bfloat16), h, kv, d, cap))
        # the schedule's other choice at d 256: one to four parts a q-tile
        by_parts = {n: _time(libs, ["f32_full"], x, h, kv, d, cap,
                             n)["f32_full"] for n in (1, 2, 3, 4)}
        print(json.dumps({
            "seq": s, "heads": h, "kv_heads": kv, "head_dim": d,
            "logit_cap": cap, "ms": ms,
            "phase_ms": {n: ms["full"] - t for n, t in ms.items()
                         if n.split("_")[0] in ("no", "one")},
            "wgmma_phase_ms": phases(ms, "wgmma_full", "wgmma_"),
            "f32_phase_ms": phases(ms, "f32_full", "f32_"),
            "f32_ms_by_parts": by_parts}), flush=True)
    for s in AUDIO_LENS:
        x = torch.randn((1, s, 3 * 32, 64), generator=gen, device=dev)
        # "full": the mma.sync form these shapes launched before the wgmma
        # form took them
        ms = _time(libs, ["full"] + [n for n in libs if n.startswith("f32")],
                   x, 32, 32, 64, 0.0)
        print(json.dumps({
            "seq": s, "heads": 32, "kv_heads": 32, "head_dim": 64,
            "logit_cap": 0.0, "ms": ms,
            "f32_phase_ms": phases(ms, "f32_full", "f32_")}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
