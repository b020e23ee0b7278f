// flash_attention: causal attention forward with a sliding window, a tanh
// logit cap and GQA, written for Hopper (sm_90a), with a plain C interface
// loaded by ctypes (kernels/_build.py, wrapper in
// kernels/flash_attention/kernel.py).
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd (body _kernel). q (B, H, Sq, hd), k (B, KV, Sk, hd)
// and v (B, KV, Sk, hd_v) -> out (B, H, Sq, hd_v); query head hh reads KV
// head
// hh / (H / KV). Positions are suffix-aligned: query row i sits at
// i + Sk - Sq. Key j is visible to query position p when j <= p (causal)
// and j > p - window (window > 0). Logits are q.k * scale, then tanh-capped,
// then masked; the softmax is online in fp32; out = acc / max(l, 1e-30).
// Every tensor is addressed through (batch, head, sequence) strides with
// the head dimension contiguous, so the model layout (B, S, H, hd) is read
// and written in place, without a transposing copy. fp32 in and out, or
// bf16 or fp16 in and out (the 16-bit forms, below); the Pallas kernel
// takes any, upcasts to fp32 inside and writes the output in q's dtype.
//
// The TPU wrapper halves its block until it divides the sequence, down to
// one row for an odd length. Here the tiles are fixed and the ragged last
// query and key tiles are masked instead: the same function for any length.
// The TPU kernel takes one head width; this one gives V a width of its own,
// so MLA's absorbed latent (deepseek-v3: K 576 = latent 512 + rope 64, V
// the latent's 512) runs without padding V to 576 on the way in (12% more
// V bytes and a padded copy of V every layer) and slicing the output back.
//
// Bound on an H100 SXM. At the serving path's prefill (B 1, Sq = Sk = 100
// to 1000, H 8, KV 4, hd 256) the causal work is about 4 * hd * H * Sq^2 / 2
// flops against (2 Sq H + 2 Sk KV) * hd * 4 bytes, hundreds of flops per
// byte, so operations bound it; at MLA's (H 128 on one KV head, hd 576,
// hd_v 512) 2 (hd + hd_v) H Sq^2 / 2 flops, far more so. Both products
// run on the tensor cores in 3xTF32 (below): three TF32 products per fp32
// multiply-add at 495 TFLOP/s, i.e. the fp32 work over 165 TFLOP/s (67
// TFLOP/s outside the tensor cores).
//
// Precision. One TF32 product keeps 10 mantissa bits of each operand: at
// the serving width its error (about 1e-3) misses the port's fp32 tolerance
// of 1e-4. The split product does not: x = hi + lo with hi = x rounded to
// TF32 and lo = x - hi (exact; the tensor core reads its TF32 bits), and
// a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (a_lo.b_lo is below fp32's
// rounding) is accurate to fp32's level: about 2e-6 at the serving width,
// emulated on a CPU by tests/test_torch_flash_tf32x3.py. So the tensor
// cores need no looser tolerance.
//
// Design. mma.sync m16n8k8 (tf32 in, fp32 accumulate), not wgmma: wgmma
// takes TF32 operands from shared memory only K-major, and V in P.V has the
// reduction dimension (keys) as its rows; mma.sync fragments are loaded by
// hand from any layout.
// - Tiles: 32 query rows per block, 32-key K/V tiles. 8 warps: warp w owns
//   the 16-row group w & 1 and the column group grp = w >> 1 (of 4), i.e.
//   the 8-wide chunks c of the head dimension with c % 4 == grp. Each warp
//   keeps its Q fragments (hi and lo) in registers for the whole key loop
//   and computes the partial S = Q.K^T of its row group over its own
//   chunks (the big products and the small ones in two accumulators, so
//   dependent products stand apart).
// - Softmax, split over the row group's four warps: warp grp sums the four
//   partials of key step grp (its 8 keys) in a fixed order through shared
//   memory, scales, caps and masks them in fp32, and takes their row max
//   (across the 4 threads of a quad); the row maxima and then the row sums
//   go through shared memory, so all four warps hold the same running max,
//   correction and sum, and each logit is capped and exponentiated once.
//   The final divide is by max(l, 1e-30).
// - P.V: the S accumulator of key step grp, with the keys permuted (A
//   column t <-> key 2t, t + 4 <-> key 2t + 1), is already an A fragment;
//   warp grp splits it once and stores it, and every warp of the row group
//   reads the four steps' fragments and adds P.V for its own output
//   chunks, reading V's rows in the same permutation.
// - Shared memory: Q (32 rows), two stages each of K and V (32 rows), rows
//   padded from d to d8 = roundup(d, 8) with zeros (the k-padding of the
//   products) and strided d8 + 4 floats (V's: dv8 + 4), which makes every
//   fragment load free of bank conflicts; the S partials (16 KiB), P
//   fragments (8 KiB), row maxima and sums. 188 KiB at hd 256: one block
//   of 8 warps per SM.
// - Two instantiations (Shape): the narrow one above, for d = dv up to
//   256 (its code as before V had a width), and a wide one for any other
//   d up to 576 with dv up to 512, whose tiles at the narrow layout would
//   take 371 KiB. The wide one keeps the tiles
//   (32 query rows, 32-key tiles, the same warps, softmax and fragment
//   permutation) but stages no Q: each warp reads its 18 chunks of Q
//   fragments from device memory once and keeps them unsplit (72
//   registers), splitting them each tile; K and V have one stage each
//   (the next tile loads after this one is done, behind two barriers);
//   and P.V runs in batches of four output chunks. 162 KiB at 576 / 512,
//   one block an SM.
// - Staging: cp.async, 16-byte .cg where the tensor's base and strides are
//   16-byte aligned and d % 4 == 0, 4-byte .ca otherwise (decided here per
//   tensor); rows past the end are zero-filled. K/V tile j + 1 loads while
//   tile j computes. Q is staged once. Four barriers a tile: the stage, the
//   S partials, the row maxima, the P fragments and row sums.
// - Grid: (B * H, query tiles), with the heaviest (last) causal query tiles
//   launched first; at Sq 550 and H 8 that is 144 blocks on 132 SMs, the
//   second wave the 12 lightest. Key tiles wholly outside the causal band
//   or the window are never loaded.
// - What holds it back (measured on an H100 with variants that drop one
//   phase): each 32-row query tile reads every K/V tile it sees from L2
//   again (about 200 MB a call at Sq 855); the products take about 45% of
//   the time, the staging and the softmax with its barriers about a
//   quarter each. Larger query tiles or multicast K/V loads come next.
//
// The 16-bit forms (flash_kernel_16<T>, T bf16 or fp16, both
// instantiations' shapes; the text below says bf16, and fp16 is the same
// template over __half: elt16.cuh; where d =
// dv is 64, 128 or 256 on 16-byte aligned rows the wrapper launches the
// warpgroup kernel of flash_attention_wgmma.cu instead): the same
// block, warps, key tiles, softmax and masks on bf16 tiles, half the fp32
// form's bytes through shared memory (103 KiB at hd 256, 195 KiB at 576 /
// 512; K and V double-buffered in both). S = Q.K^T runs on
// mma.sync m16n8k16 bf16 with fp32 accumulation: a bf16 x bf16 product is
// exact in fp32, so this is the Pallas kernel's upcast product. P.V takes
// P split into bf16 hi and lo parts (two products, 16 mantissa bits of P
// kept; rounding P to bf16 alone would err by up to 2^-9 of each weight),
// V's B fragments from ldmatrix.trans. Against the plain version in fp32
// its error before the output's rounding is about 1e-5 of the output's
// scale, so the bf16 output differs from the plain version's rounded
// output by at most one bf16 step (2^-8 relative) where the two land on
// either side of a rounding boundary. Bound at gemma2-2b's prefill: the
// causal flops over the dense bf16 rate, 989 TFLOP/s (the P.V split counts
// twice on the card). The fp16 form: m16n8k16 f16 (an fp16 x fp16 product
// is exact in fp32 too), P split into fp16 hi and lo (elt16.cuh bounds its
// error), the output rounded to fp16 once; the scores, the running max and
// sum and the accumulators stay fp32, so only the output can overflow, as
// the reference's does. The dense fp16 rate is the bf16 one.
//
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/elt16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 32;                       // query rows per block
constexpr int kBK = 32;                       // keys per K/V tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroups = kWarps / 2;           // column groups per row group
constexpr int kNT = kBK / 8;                  // 8-key tiles of S
constexpr int kMaxD = 256;                    // the narrow instantiation
constexpr int kMaxDWide = 576;                // the wide one: dk
constexpr int kMaxDvWide = 512;               // and dv
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;
static_assert(kNT == kGroups, "warp grp owns the softmax of key step grp");

// The two instantiations' shapes. Narrow (dk = dv <= 256): Q staged once
// and its fragments split once into registers, K/V double-buffered, every
// P.V chunk's B fragments loaded before its products. Wide (any other dk
// <= 576 with dv <= 512; MLA's absorbed latent): Q's fragments kept
// unsplit in registers (read straight from device memory once) and split
// each tile, K and V single-buffered, P.V in batches of kCB chunks: a
// block's registers and its 166 KiB of shared memory fit one block an SM.
template <bool kWide>
struct Shape {
  static constexpr int kChunks = (kWide ? kMaxDWide : kMaxD) / 8 / kGroups;
  static constexpr int kChunksV = (kWide ? kMaxDvWide : kMaxD) / 8 / kGroups;
  static constexpr int kStages = kWide ? 1 : 2;
  static constexpr int kQRows = kWide ? 0 : kBQ;   // Q rows staged
  static constexpr int kCB = kWide ? 4 : kChunksV;  // P.V chunks a batch
  static_assert(kChunksV % kCB == 0, "P.V batches");
};

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits, to nearest, ties
// away: what cvt.rna.tf32.f32 gives, in two integer operations where sm_90
// has no single instruction for it); lo = x - hi is exact in fp32, and the
// tensor core reads only its TF32 bits (it truncates the 13 below)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + kRows) of an (n_rows, d) matrix (row stride rs elements)
// into shared rows of stride ss; rows >= n_rows are zero-filled. Narrow: a
// thread copies one column slot (16 or 4 bytes) of every step-th row (at
// most kThreads slots a row). Wide: the block walks the tile's slots in
// order, kThreads at a time (a 576-wide row has 144 or 576 slots).
template <int kRows, bool kWide>
__device__ __forceinline__ void stage(float* dst, int ss, const float* base,
                                      int64_t rs, int r0, int n_rows, int d,
                                      bool vec) {
  const int per = vec ? d >> 2 : d;     // copies per row
  if constexpr (kWide) {
    const int sh = vec ? 2 : 0;
    for (int i = threadIdx.x; i < kRows * per; i += kThreads) {
      const int r = i / per;
      const int c = (i - r * per) << sh;
      const bool in = r0 + r < n_rows;
      const float* src = in ? base + (int64_t)(r0 + r) * rs + c : base;
      if (vec)
        cp16(dst + r * ss + c, src, in);
      else
        cp4(dst + r * ss + c, src, in);
    }
    return;
  }
  const int step = kThreads / per;      // rows per pass
  const int first = threadIdx.x / per;
  if (first >= step) return;            // left over by a pass
  const int c = (threadIdx.x - first * per) << (vec ? 2 : 0);
  for (int r = first; r < kRows; r += step) {
    const bool in = r0 + r < n_rows;
    const float* src = in ? base + (int64_t)(r0 + r) * rs + c : base;
    if (vec)
      cp16(dst + r * ss + c, src, in);
    else
      cp4(dst + r * ss + c, src, in);
  }
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int h,
             int kv, int sq, int sk, int d, int dv_in, int64_t qsb, int64_t qsh,
             int64_t qss, int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
             int64_t vsh, int64_t vss, int64_t osb, int64_t osh, int64_t oss,
             int causal, int window, float scale, float cap, int vec_q,
             int vec_k, int vec_v) {
  using S = Shape<kWide>;
  constexpr int kChunks = S::kChunks;
  constexpr int kChunksV = S::kChunksV;
  constexpr int kCB = S::kCB;
  extern __shared__ __align__(16) float smem[];
  const int d8 = (d + 7) & ~7;          // head dimension padded to 8
  const int ss = d8 + 4;                // shared row stride (ss / 4 odd)
  const int nk = d8 >> 3;               // 8-wide chunks of the head dim
  const int dv = kWide ? dv_in : d;     // narrow: V as wide as K
  const int dv8 = (dv + 7) & ~7;        // the same for V
  const int ssv = dv8 + 4;
  const int nkv = dv8 >> 3;
  float* qs = smem;                     // (kQRows, ss)
  float* ks = qs + S::kQRows * ss;      // kStages x (BK, ss)
  float* vs = ks + S::kStages * kBK * ss;   // kStages x (BK, ssv)
  // (2, kGroups, kNT, 32)
  float4* part = (float4*)(vs + S::kStages * kBK * ssv);
  uint4* p_hi = (uint4*)(part + 2 * kGroups * kNT * 32);  // (2, kNT, 32)
  uint4* p_lo = p_hi + 2 * kNT * 32;                       // (2, kNT, 32)
  float* row_max = (float*)(p_lo + 2 * kNT * 32);          // (2, kGroups, 16)
  float* row_sum = row_max + 2 * kGroups * 16;             // (2, kGroups, 16)

  const int hh = blockIdx.x % h;
  const int b = blockIdx.x / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int kh = hh / (h / kv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp & 1;              // 16-row group
  const int grp = warp >> 1;            // column group: chunks grp + 4c
  const int g = lane >> 2;
  const int t = lane & 3;

  const float* qb = q + (int64_t)b * qsb + (int64_t)hh * qsh;
  const float* kb = k + (int64_t)b * ksb + (int64_t)kh * ksh;
  const float* vb = v + (int64_t)b * vsb + (int64_t)kh * vsh;

  // the padding columns [d, d8) of every staged Q and K row (narrow: and
  // V row) and [dv, dv8) of every V row: zero, once (cp.async never
  // writes them)
  if (d8 > d) {
    const int pad = d8 - d;
    const int rows = S::kQRows + S::kStages * kBK * (kWide ? 1 : 2);
    for (int i = tid; i < rows * pad; i += kThreads) {
      const int r = i / pad;
      smem[r * ss + d + (i - r * pad)] = 0.f;
    }
  }
  if (kWide && dv8 > dv) {
    const int pad = dv8 - dv;
    for (int i = tid; i < S::kStages * kBK * pad; i += kThreads) {
      const int r = i / pad;
      vs[r * ssv + dv + (i - r * pad)] = 0.f;
    }
  }

  const int off = sk - sq;              // suffix alignment
  const int last_row = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, last_row + off + 1) : sk;
  const int t_first = (window > 0 ? max(0, q0 + off - window + 1) : 0) / kBK;
  const int n_tiles =
      k_end > t_first * kBK ? (k_end - t_first * kBK + kBK - 1) / kBK : 0;

  if constexpr (!kWide) stage<kBQ, kWide>(qs, ss, qb, qss, q0, sq, d, vec_q);
  if (n_tiles > 0) {
    stage<kBK, kWide>(ks, ss, kb, kss, t_first * kBK, sk, d, vec_k);
    stage<kBK, kWide>(vs, ssv, vb, vss, t_first * kBK, sk, dv, vec_v);
  }
  cp_commit();
  cp_wait_all();
  __syncthreads();

  // this warp's Q fragments (rows rg * 16 + g and + 8): split once
  // (narrow), or kept as they are and split each tile (wide)
  uint32_t qh[kWide ? 1 : kChunks][4], ql[kWide ? 1 : kChunks][4];
  float qf[kWide ? kChunks : 1][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int kk = grp + kGroups * c;
    if constexpr (kWide) {
      const int ra = q0 + rg * 16 + g, col = kk * 8 + t;
      const float* qr = qb + (int64_t)ra * qss + col;
      const bool a = kk < nk && ra < sq, bb = kk < nk && ra + 8 < sq;
      qf[c][0] = a && col < d ? qr[0] : 0.f;
      qf[c][1] = bb && col < d ? qr[8 * qss] : 0.f;
      qf[c][2] = a && col + 4 < d ? qr[4] : 0.f;
      qf[c][3] = bb && col + 4 < d ? qr[8 * qss + 4] : 0.f;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) qh[c][i] = ql[c][i] = 0u;
      if (kk < nk) {
        const float* qr = qs + (rg * 16 + g) * ss + kk * 8 + t;
        split(qr[0], qh[c][0], ql[c][0]);
        split(qr[8 * ss], qh[c][1], ql[c][1]);
        split(qr[4], qh[c][2], ql[c][2]);
        split(qr[8 * ss + 4], qh[c][3], ql[c][3]);
      }
    }
  }

  float acc[kChunksV][4];
#pragma unroll
  for (int c = 0; c < kChunksV; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const int row0 = q0 + rg * 16 + g;    // rows of c0, c1; c2, c3 are + 8
  const int pos[2] = {row0 + off, row0 + 8 + off};

  for (int j = 0; j < n_tiles; ++j) {
    const int cur = S::kStages == 2 ? j & 1 : 0;
    if constexpr (S::kStages == 2) {
      if (j > 0) {
        cp_wait_all();                  // tile j has landed (this thread's)
        __syncthreads();                // ... everyone's; tile j - 1 is done
      }
      if (j + 1 < n_tiles) {            // tile j + 1 loads while j computes
        const int k1 = (t_first + j + 1) * kBK;
        stage<kBK, kWide>(ks + (cur ^ 1) * kBK * ss, ss, kb, kss, k1, sk, d, vec_k);
        stage<kBK, kWide>(vs + (cur ^ 1) * kBK * ssv, ssv, vb, vss, k1, sk, dv, vec_v);
        cp_commit();
      }
    } else if (j > 0) {                 // one buffer: tile j - 1 is done
      __syncthreads();
      const int k1 = (t_first + j) * kBK;
      stage<kBK, kWide>(ks, ss, kb, kss, k1, sk, d, vec_k);
      stage<kBK, kWide>(vs, ssv, vb, vss, k1, sk, dv, vec_v);
      cp_commit();
      cp_wait_all();
      __syncthreads();
    }
    const float* kt = ks + cur * kBK * ss;
    const float* vt = vs + cur * kBK * ssv;
    const int k0 = (t_first + j) * kBK;

    // partial S over this warp's chunks of the head dimension, in 3xTF32:
    // the big products into s, the small ones into s_lo, each product
    // kNT or 2 kNT issues away from the one it depends on
    float s[kNT][4], s_lo[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = s_lo[n][i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int kk = grp + kGroups * c;
      if (kk < nk) {
        uint32_t qhc[4], qlc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kWide) {
            split(qf[c][i], qhc[i], qlc[i]);
          } else {
            qhc[i] = qh[c][i];
            qlc[i] = ql[c][i];
          }
        }
        uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const float* kr = kt + (n * 8 + g) * ss + kk * 8 + t;
          split(kr[0], bh[n][0], bl[n][0]);
          split(kr[4], bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n) mma(s_lo[n], qlc, bh[n]);
#pragma unroll
        for (int n = 0; n < kNT; ++n) mma(s[n], qhc, bh[n]);
#pragma unroll
        for (int n = 0; n < kNT; ++n) mma(s_lo[n], qhc, bl[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] += s_lo[n][i];
    // the row group's four partials: warp grp sums those of key step grp
    // (its 8 keys), in a fixed order, and takes their softmax
    float4* mine = part + (rg * kGroups + grp) * kNT * 32 + lane;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      mine[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    __syncthreads();
    float x[4];
    {
      float4 a = part[((rg * kGroups) * kNT + grp) * 32 + lane];
#pragma unroll
      for (int o = 1; o < kGroups; ++o) {
        const float4 p = part[((rg * kGroups + o) * kNT + grp) * 32 + lane];
        a.x += p.x;
        a.y += p.y;
        a.z += p.z;
        a.w += p.w;
      }
      x[0] = a.x;
      x[1] = a.y;
      x[2] = a.z;
      x[3] = a.w;
    }

    // scale, cap, mask; rows row0 (i < 2) and row0 + 8 (i >= 2)
    uint32_t ok = 0u;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      const int kpos = k0 + grp * 8 + 2 * t + (i & 1);
      float sc = x[i] * scale;
      if (cap > 0.f) sc = tanhf(sc / cap) * cap;
      bool valid = kpos < sk;
      if (causal) valid = valid && kpos <= pos[r];
      if (window > 0) valid = valid && kpos > pos[r] - window;
      ok |= (uint32_t)valid << i;
      x[i] = valid ? sc : kNegInf;
      mx[r] = fmaxf(mx[r], x[i]);
    }
    float* my_max = row_max + (rg * kGroups + grp) * 16;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (t == 0) my_max[g + 8 * r] = mx[r];
    }
    __syncthreads();
    // the online softmax: every warp of the row group the same m, corr, l
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m_new = m[r];
#pragma unroll
      for (int o = 0; o < kGroups; ++o)
        m_new = fmaxf(m_new, row_max[(rg * kGroups + o) * 16 + g + 8 * r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = (ok >> i) & 1u ? expf(x[i] - m[i >> 1]) : 0.f;
      sum[i >> 1] += x[i];
    }
    float* my_sum = row_sum + (rg * kGroups + grp) * 16;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      if (t == 0) my_sum[g + 8 * r] = sum[r];
    }
    // P of key step grp as the A fragment of every warp of the row group,
    // split once: key 2t in column t, key 2t + 1 in column t + 4
    {
      uint4 hi, lo;
      split(x[0], hi.x, lo.x);
      split(x[2], hi.y, lo.y);
      split(x[1], hi.z, lo.z);
      split(x[3], hi.w, lo.w);
      p_hi[(rg * kNT + grp) * 32 + lane] = hi;
      p_lo[(rg * kNT + grp) * 32 + lane] = lo;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tot = 0.f;
#pragma unroll
      for (int o = 0; o < kGroups; ++o)
        tot += row_sum[(rg * kGroups + o) * 16 + g + 8 * r];
      l[r] = l[r] * corr[r] + tot;
    }
#pragma unroll
    for (int c = 0; c < kChunksV; ++c) {
      acc[c][0] *= corr[0];
      acc[c][1] *= corr[0];
      acc[c][2] *= corr[1];
      acc[c][3] *= corr[1];
    }

    // O += P.V over the tile's keys, 8 at a time, V's rows read in P's key
    // permutation; 3xTF32, small products first, each kCB issues from the
    // previous product into the same accumulator
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const uint4 hi = p_hi[(rg * kNT + n) * 32 + lane];
      const uint4 lo = p_lo[(rg * kNT + n) * 32 + lane];
      const uint32_t ah[4] = {hi.x, hi.y, hi.z, hi.w};
      const uint32_t al[4] = {lo.x, lo.y, lo.z, lo.w};
      const float* vr = vt + (n * 8 + 2 * t) * ssv + g;
#pragma unroll
      for (int cb = 0; cb < kChunksV; cb += kCB) {
        uint32_t bh[kCB][2], bl[kCB][2];
#pragma unroll
        for (int c = 0; c < kCB; ++c) {
          const int kk = grp + kGroups * (cb + c);
          if (kk < nkv) {
            split(vr[kk * 8], bh[c][0], bl[c][0]);
            split(vr[ssv + kk * 8], bh[c][1], bl[c][1]);
          }
        }
#pragma unroll
        for (int c = 0; c < kCB; ++c)
          if (grp + kGroups * (cb + c) < nkv) mma(acc[cb + c], al, bh[c]);
#pragma unroll
        for (int c = 0; c < kCB; ++c)
          if (grp + kGroups * (cb + c) < nkv) mma(acc[cb + c], ah, bl[c]);
#pragma unroll
        for (int c = 0; c < kCB; ++c)
          if (grp + kGroups * (cb + c) < nkv) mma(acc[cb + c], ah, bh[c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < sq) {
      float* orow = out + (int64_t)b * osb + (int64_t)hh * osh +
                    (int64_t)row * oss;
      const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < kChunksV; ++c) {
        const int col = (grp + kGroups * c) * 8 + 2 * t;
        if (col < dv) orow[col] = acc[c][2 * r] / den;
        if (col + 1 < dv) orow[col + 1] = acc[c][2 * r + 1] / den;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The 16-bit forms, bf16 and fp16 (T, elt16.cuh): q, k, v and the output in
// T, the products on T's tensor cores, the softmax and both accumulators in
// fp32.
// ---------------------------------------------------------------------------

// S = Q.K^T on m16n8k16 (T in, fp32 accumulate); narrow: d = dv <= 256,
// wide: d <= 576 with dv <= 512. Q's fragments are 16 head dims a chunk
// (kChunks a warp: chunks grp + 4c), the output's 8 (kChunksV a warp)
static_assert(kNT == 4, "P.V takes two 16-key steps a tile");

template <bool kWide>
struct ShapeH {
  static constexpr int kChunks = (kWide ? kMaxDWide : kMaxD) / 16 / kGroups;
  static constexpr int kChunksV = (kWide ? kMaxDvWide : kMaxD) / 8 / kGroups;
};

// four 8x8 tiles of 16-bit elements, transposed: lane i gives the address
// of row i % 8 of tile i / 8, and register j gets tile j's elements (2t, g)
// and (2t + 1, g): the B fragment of rows (keys) 2t, 2t + 1 at column g
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp16h(void* dst, const void* src, bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

// Rows [r0, r0 + kRows) of an (n_rows, d) matrix of T into shared rows of
// stride ss, rows >= n_rows zero-filled: 16-byte cp.async copies (8
// values) where the tensor allows them, else plain 2-byte loads and stores
// (cp.async has no 2-byte copy), which the barrier before the tile's use
// orders as it orders the copies
template <int kRows, typename T>
__device__ __forceinline__ void stage_h(T* dst, int ss, const T* base,
                                        int64_t rs, int r0, int n_rows, int d,
                                        bool vec) {
  if (vec) {
    const int per = d >> 3;
    for (int i = threadIdx.x; i < kRows * per; i += kThreads) {
      const int r = i / per;
      const int c = (i - r * per) << 3;
      const bool in = r0 + r < n_rows;
      cp16h(dst + r * ss + c, in ? base + (int64_t)(r0 + r) * rs + c : base,
            in);
    }
    return;
  }
  for (int i = threadIdx.x; i < kRows * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * ss + c] = r0 + r < n_rows ? base[(int64_t)(r0 + r) * rs + c]
                                      : Elt16<T>::from_f(0.f);
  }
}

// The fp32 kernel's block, warps, key tiles, softmax and masks, on tiles
// of T: Q (32 rows) staged once and its fragments kept in registers, K and
// V double-buffered, rows padded to d16 = roundup(d, 16) (V's to dv8) with
// zeros and strided d16 + 8 (dv8 + 8) values, which keeps the 32-bit
// fragment loads of Q and K and V's ldmatrix rows free of bank conflicts at
// head dims that are multiples of 64. P.V: the softmax warp of key step grp
// stores its 8 keys' P as hi and lo pairs of T, which are already the A
// fragments of m16n8k16 (keys 2t, 2t + 1 of the step in c0, c1); V's B
// fragments come from one ldmatrix.trans of the tile's 32 rows a chunk.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel_16(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out, int h,
                int kv, int sq, int sk, int d, int dv_in, int64_t qsb,
                int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,
                int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
                int64_t osb, int64_t osh, int64_t oss, int causal,
                int window, float scale, float cap, int vec_q, int vec_k,
                int vec_v) {
  using S = ShapeH<kWide>;
  constexpr int kChunks = S::kChunks;
  constexpr int kChunksV = S::kChunksV;
  extern __shared__ __align__(16) unsigned char smem_h[];
  const int d16 = (d + 15) & ~15;       // head dimension padded to 16
  const int ss = d16 + 8;               // shared row stride (values)
  const int nk = d16 >> 4;              // 16-wide chunks of the head dim
  const int dv = kWide ? dv_in : d;     // narrow: V as wide as K
  const int dv8 = (dv + 7) & ~7;
  const int ssv = dv8 + 8;
  const int nkv = dv8 >> 3;             // 8-wide chunks of the output
  T* qs = (T*)smem_h;             // (BQ, ss)
  T* ks = qs + kBQ * ss;             // 2 x (BK, ss)
  T* vs = ks + 2 * kBK * ss;         // 2 x (BK, ssv)
  // (2, kGroups, kNT, 32)
  float4* part = (float4*)(vs + 2 * kBK * ssv);
  uint2* p_hi = (uint2*)(part + 2 * kGroups * kNT * 32);  // (2, kNT, 32)
  uint2* p_lo = p_hi + 2 * kNT * 32;                       // (2, kNT, 32)
  float* row_max = (float*)(p_lo + 2 * kNT * 32);          // (2, kGroups, 16)
  float* row_sum = row_max + 2 * kGroups * 16;             // (2, kGroups, 16)

  const int hh = blockIdx.x % h;
  const int b = blockIdx.x / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int kh = hh / (h / kv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp & 1;
  const int grp = warp >> 1;
  const int g = lane >> 2;
  const int t = lane & 3;

  const T* qb = q + (int64_t)b * qsb + (int64_t)hh * qsh;
  const T* kb = k + (int64_t)b * ksb + (int64_t)kh * ksh;
  const T* vb = v + (int64_t)b * vsb + (int64_t)kh * vsh;

  // padding columns: [d, d16) of every Q and K row, [dv, dv8) of every V
  // row, zero once (the staging never writes them)
  const T zero = Elt16<T>::from_f(0.f);
  if (d16 > d) {
    const int pad = d16 - d;
    for (int i = tid; i < (kBQ + 2 * kBK) * pad; i += kThreads) {
      const int r = i / pad;
      qs[r * ss + d + (i - r * pad)] = zero;
    }
  }
  if (dv8 > dv) {
    const int pad = dv8 - dv;
    for (int i = tid; i < 2 * kBK * pad; i += kThreads) {
      const int r = i / pad;
      vs[r * ssv + dv + (i - r * pad)] = zero;
    }
  }

  const int off = sk - sq;
  const int last_row = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, last_row + off + 1) : sk;
  const int t_first = (window > 0 ? max(0, q0 + off - window + 1) : 0) / kBK;
  const int n_tiles =
      k_end > t_first * kBK ? (k_end - t_first * kBK + kBK - 1) / kBK : 0;

  stage_h<kBQ, T>(qs, ss, qb, qss, q0, sq, d, vec_q);
  if (n_tiles > 0) {
    stage_h<kBK, T>(ks, ss, kb, kss, t_first * kBK, sk, d, vec_k);
    stage_h<kBK, T>(vs, ssv, vb, vss, t_first * kBK, sk, dv, vec_v);
  }
  cp_commit();
  cp_wait_all();
  __syncthreads();

  // this warp's Q fragments: rows rg * 16 + g and + 8, head dims kk * 16 +
  // 2t, + 1 and + 8, + 9 of its chunks kk
  uint32_t qa[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int kk = grp + kGroups * c;
    if (kk < nk) {
      const T* qr = qs + (rg * 16 + g) * ss + kk * 16 + 2 * t;
      qa[c][0] = ld32(qr);
      qa[c][1] = ld32(qr + 8 * ss);
      qa[c][2] = ld32(qr + 8);
      qa[c][3] = ld32(qr + 8 * ss + 8);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[c][i] = 0u;
    }
  }

  float acc[kChunksV][4];
#pragma unroll
  for (int c = 0; c < kChunksV; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const int row0 = q0 + rg * 16 + g;
  const int pos[2] = {row0 + off, row0 + 8 + off};

  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1;
    if (j > 0) {
      cp_wait_all();
      __syncthreads();
    }
    if (j + 1 < n_tiles) {
      const int k1 = (t_first + j + 1) * kBK;
      stage_h<kBK, T>(ks + (cur ^ 1) * kBK * ss, ss, kb, kss, k1, sk, d, vec_k);
      stage_h<kBK, T>(vs + (cur ^ 1) * kBK * ssv, ssv, vb, vss, k1, sk, dv,
                   vec_v);
      cp_commit();
    }
    const T* kt = ks + cur * kBK * ss;
    const T* vt = vs + cur * kBK * ssv;
    const int k0 = (t_first + j) * kBK;

    // partial S over this warp's chunks: one product of T a chunk and key
    // step, exact products summed in fp32
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int kk = grp + kGroups * c;
      if (kk < nk) {
        uint32_t bk[kNT][2];
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const T* kr = kt + (n * 8 + g) * ss + kk * 16 + 2 * t;
          bk[n][0] = ld32(kr);
          bk[n][1] = ld32(kr + 8);
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n) mma16<T>(s[n], qa[c], bk[n]);
      }
    }
    float4* mine = part + (rg * kGroups + grp) * kNT * 32 + lane;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      mine[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    __syncthreads();
    float x[4];
    {
      float4 a = part[((rg * kGroups) * kNT + grp) * 32 + lane];
#pragma unroll
      for (int o = 1; o < kGroups; ++o) {
        const float4 p = part[((rg * kGroups + o) * kNT + grp) * 32 + lane];
        a.x += p.x;
        a.y += p.y;
        a.z += p.z;
        a.w += p.w;
      }
      x[0] = a.x;
      x[1] = a.y;
      x[2] = a.z;
      x[3] = a.w;
    }

    // scale, cap, mask: c0, c1 are keys 2t, 2t + 1 of row row0, c2, c3 of
    // row0 + 8
    uint32_t ok = 0u;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      const int kpos = k0 + grp * 8 + 2 * t + (i & 1);
      float sc = x[i] * scale;
      if (cap > 0.f) sc = tanhf(sc / cap) * cap;
      bool valid = kpos < sk;
      if (causal) valid = valid && kpos <= pos[r];
      if (window > 0) valid = valid && kpos > pos[r] - window;
      ok |= (uint32_t)valid << i;
      x[i] = valid ? sc : kNegInf;
      mx[r] = fmaxf(mx[r], x[i]);
    }
    float* my_max = row_max + (rg * kGroups + grp) * 16;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (t == 0) my_max[g + 8 * r] = mx[r];
    }
    __syncthreads();
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m_new = m[r];
#pragma unroll
      for (int o = 0; o < kGroups; ++o)
        m_new = fmaxf(m_new, row_max[(rg * kGroups + o) * 16 + g + 8 * r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = (ok >> i) & 1u ? expf(x[i] - m[i >> 1]) : 0.f;
      sum[i >> 1] += x[i];
    }
    float* my_sum = row_sum + (rg * kGroups + grp) * 16;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      if (t == 0) my_sum[g + 8 * r] = sum[r];
    }
    // P of key step grp, hi and lo: register 0 row row0's keys 2t, 2t + 1,
    // register 1 row0 + 8's
    {
      uint2 hi, lo;
      split2<T>(x[0], x[1], hi.x, lo.x);
      split2<T>(x[2], x[3], hi.y, lo.y);
      p_hi[(rg * kNT + grp) * 32 + lane] = hi;
      p_lo[(rg * kNT + grp) * 32 + lane] = lo;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tot = 0.f;
#pragma unroll
      for (int o = 0; o < kGroups; ++o)
        tot += row_sum[(rg * kGroups + o) * 16 + g + 8 * r];
      l[r] = l[r] * corr[r] + tot;
    }
#pragma unroll
    for (int c = 0; c < kChunksV; ++c) {
      acc[c][0] *= corr[0];
      acc[c][1] *= corr[0];
      acc[c][2] *= corr[1];
      acc[c][3] *= corr[1];
    }

    // O += P.V: the A fragment of 16-key step u is key steps 2u and 2u + 1
    // of the softmax; the small products (P's lo) first
    uint32_t ah[kNT / 2][4], al[kNT / 2][4];
#pragma unroll
    for (int u = 0; u < kNT / 2; ++u) {
      const uint2 h0 = p_hi[(rg * kNT + 2 * u) * 32 + lane];
      const uint2 h1 = p_hi[(rg * kNT + 2 * u + 1) * 32 + lane];
      const uint2 l0 = p_lo[(rg * kNT + 2 * u) * 32 + lane];
      const uint2 l1 = p_lo[(rg * kNT + 2 * u + 1) * 32 + lane];
      ah[u][0] = h0.x;
      ah[u][1] = h0.y;
      ah[u][2] = h1.x;
      ah[u][3] = h1.y;
      al[u][0] = l0.x;
      al[u][1] = l0.y;
      al[u][2] = l1.x;
      al[u][3] = l1.y;
    }
#pragma unroll
    for (int c = 0; c < kChunksV; ++c) {
      const int kk = grp + kGroups * c;
      if (kk < nkv) {
        uint32_t bv[4];                 // keys 0-7, 8-15, 16-23, 24-31
        ldsm_x4_t(bv, vt + lane * ssv + kk * 8);
        mma16<T>(acc[c], al[0], bv);
        mma16<T>(acc[c], al[1], bv + 2);
        mma16<T>(acc[c], ah[0], bv);
        mma16<T>(acc[c], ah[1], bv + 2);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < sq) {
      T* orow = out + (int64_t)b * osb + (int64_t)hh * osh +
                   (int64_t)row * oss;
      const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < kChunksV; ++c) {
        const int col = (grp + kGroups * c) * 8 + 2 * t;
        if (col < dv) orow[col] = Elt16<T>::from_f(acc[c][2 * r] / den);
        if (col + 1 < dv)
          orow[col + 1] = Elt16<T>::from_f(acc[c][2 * r + 1] / den);
      }
    }
  }
}

// whether every row start of a (n0, n1, n2, d) strided tensor is 16-byte
// aligned, with per elements to 16 bytes (4 fp32, 8 of 16 bits; a stride of a
// dimension of size 1 is never used)
bool rows_aligned16(const void* p, int n0, int64_t s0, int n1, int64_t s1,
                    int n2, int64_t s2, int d, int per) {
  return (uintptr_t)p % 16 == 0 && d % per == 0 &&
         (n0 == 1 || s0 % per == 0) && (n1 == 1 || s1 % per == 0) &&
         (n2 == 1 || s2 % per == 0);
}

template <bool kWide>
size_t smem_bytes(int d, int dv) {
  using S = Shape<kWide>;
  const int ss = ((d + 7) & ~7) + 4;
  const int ssv = ((dv + 7) & ~7) + 4;
  return sizeof(float) * (size_t)(S::kQRows + S::kStages * kBK) * ss +
         sizeof(float) * (size_t)S::kStages * kBK * ssv +
         sizeof(float4) * 2 * kGroups * kNT * 32 +   // S partials
         sizeof(uint4) * 2 * 2 * kNT * 32 +          // P fragments, hi, lo
         sizeof(float) * 2 * 2 * kGroups * 16;       // row maxima and sums
}

// the 16-bit forms' (narrow and wide alike): Q, two stages of K and V
size_t smem_bytes_h(int d, int dv) {
  const int ss = ((d + 15) & ~15) + 8;
  const int ssv = ((dv + 7) & ~7) + 8;
  return sizeof(bf16) * (size_t)(kBQ + 2 * kBK) * ss +   // 2 bytes a value
         sizeof(bf16) * (size_t)2 * kBK * ssv +
         sizeof(float4) * 2 * kGroups * kNT * 32 +   // S partials
         sizeof(uint2) * 2 * 2 * kNT * 32 +          // P fragments, hi, lo
         sizeof(float) * 2 * 2 * kGroups * 16;       // row maxima and sums
}

// the narrow instantiation takes V as wide as K, up to 256
int is_wide(int d, int dv) { return d > kMaxD || dv > kMaxD || d != dv; }

bool dims_ok(int d, int dv) {
  return d > 0 && dv > 0 &&
         (is_wide(d, dv) ? d <= kMaxDWide && dv <= kMaxDvWide : true);
}

// the forms (a call's element types): fp32, and the 16-bit forms bf16 and
// fp16, one instantiation of flash_kernel_16 each
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

size_t smem_of(int d, int dv, int type) {
  if (type != kF32) return smem_bytes_h(d, dv);
  return is_wide(d, dv) ? smem_bytes<true>(d, dv) : smem_bytes<false>(d, dv);
}

using Kernel = void (*)(const float*, const float*, const float*, float*, int,
                        int, int, int, int, int, int64_t, int64_t, int64_t,
                        int64_t, int64_t, int64_t, int64_t, int64_t, int64_t,
                        int64_t, int64_t, int64_t, int, int, float, float,
                        int, int, int);
template <typename T>
using KernelH = void (*)(const T*, const T*, const T*, T*, int, int, int, int,
                         int, int, int64_t, int64_t, int64_t, int64_t,
                         int64_t, int64_t, int64_t, int64_t, int64_t, int64_t,
                         int64_t, int64_t, int, int, float, float, int, int,
                         int);

Kernel pick(int wide) {
  return wide ? flash_kernel<true> : flash_kernel<false>;
}

template <typename T>
KernelH<T> pick_h(int wide) {
  return wide ? flash_kernel_16<T, true> : flash_kernel_16<T, false>;
}

const void* kernel_of(int wide, int type) {
  return type == kBF16  ? (const void*)pick_h<bf16>(wide)
         : type == kF16 ? (const void*)pick_h<__half>(wide)
                        : (const void*)pick(wide);
}

// Raise a kernel's dynamic shared-memory limit only when a larger size is
// first asked for on the current device (the attribute is kept per device
// and per kernel), so launches captured in a CUDA graph make no such call.
size_t configured[kMaxDevices][6] = {};

cudaError_t configure(int wide, int type, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  size_t& have = configured[dev][2 * type + wide];
  if (smem <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel_of(wide, type),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) have = smem;
  return err;
}

template <typename T>
void launch_h(dim3 grid, size_t smem, cudaStream_t st, int wide,
              const void* q, const void* k, const void* v, void* out, int h,
              int kv, int sq, int sk, int d, int dv, int64_t qsb,
              int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,
              int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
              int64_t osb, int64_t osh, int64_t oss, int causal, int window,
              float scale, float cap, int vq, int vk, int vv) {
  pick_h<T>(wide)<<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, h, kv, sq, sk, d, dv,
      qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, causal,
      window, scale, cap, vq, vk, vv);
}

// every form's launch: type selects it
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int h, int kv, int sq, int sk, int d, int dv, int64_t qsb,
           int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
           int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
           int64_t oss, int causal, int window, float scale, float cap,
           void* stream, int type) {
  if (!dims_ok(d, dv) || kv <= 0 || h % kv != 0)
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || sq <= 0) return (int)cudaGetLastError();
  const int n_qt = (sq + kBQ - 1) / kBQ;
  if (n_qt > 65535 || (int64_t)b * h > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int wide = is_wide(d, dv);
  const size_t smem = smem_of(d, dv, type);
  const cudaError_t err = configure(wide, type, smem);
  if (err != cudaSuccess) return (int)err;
  const int per = type != kF32 ? 8 : 4;
  const int vq = rows_aligned16(q, b, qsb, h, qsh, sq, qss, d, per);
  const int vk = rows_aligned16(k, b, ksb, kv, ksh, sk, kss, d, per);
  const int vv = rows_aligned16(v, b, vsb, kv, vsh, sk, vss, dv, per);
  dim3 grid((unsigned)(b * h), (unsigned)n_qt);
  cudaStream_t st = (cudaStream_t)stream;
  if (type == kBF16)
    launch_h<bf16>(grid, smem, st, wide, q, k, v, out, h, kv, sq, sk, d, dv,
                   qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                   causal, window, scale, cap, vq, vk, vv);
  else if (type == kF16)
    launch_h<__half>(grid, smem, st, wide, q, k, v, out, h, kv, sq, sk, d,
                     dv, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb,
                     osh, oss, causal, window, scale, cap, vq, vk, vv);
  else
    pick(wide)<<<grid, kThreads, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, h,
        kv, sq, sk, d, dv, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb,
        osh, oss, causal, window, scale, cap, vq, vk, vv);
  return (int)cudaGetLastError();
}

int info_of(int d, int dv, int* info, int type) {
  if (!dims_ok(d, dv)) return (int)cudaErrorInvalidValue;
  const int wide = is_wide(d, dv);
  const size_t smem = smem_of(d, dv, type);
  cudaError_t err = configure(wide, type, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel_of(wide, type));
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_of(wide, type), kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)smem;
  info[3] = per_sm;
  info[4] = kThreads;
  info[5] = kBQ;
  return 0;
}

}  // namespace

extern "C" {

// q (b, h, sq, d), k (b, kv, sk, d), v (b, kv, sk, dv), out (b, h, sq,
// dv), all f32 with the last dimension contiguous and the other three
// strided (elements). d = dv <= 256 (narrow), or d <= 576 and dv <= 512
// (wide).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int b, int h, int kv, int sq, int sk, int d, int dv,
                    int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                    int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                    int64_t vss, int64_t osb, int64_t osh, int64_t oss,
                    int causal, int window, float scale, float cap,
                    void* stream) {
  return launch(q, k, v, out, b, h, kv, sq, sk, d, dv, qsb, qsh, qss, ksb,
                ksh, kss, vsb, vsh, vss, osb, osh, oss, causal, window, scale,
                cap, stream, kF32);
}

// The same with q, k, v and out bf16.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int b, int h, int kv, int sq, int sk,
                         int d, int dv, int64_t qsb, int64_t qsh, int64_t qss,
                         int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
                         int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
                         int64_t oss, int causal, int window, float scale,
                         float cap, void* stream) {
  return launch(q, k, v, out, b, h, kv, sq, sk, d, dv, qsb, qsh, qss, ksb,
                ksh, kss, vsb, vsh, vss, osb, osh, oss, causal, window, scale,
                cap, stream, kBF16);
}

// The same with q, k, v and out fp16.
int flash_attention_f16(const void* q, const void* k, const void* v,
                        void* out, int b, int h, int kv, int sq, int sk,
                        int d, int dv, int64_t qsb, int64_t qsh, int64_t qss,
                        int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
                        int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
                        int64_t oss, int causal, int window, float scale,
                        float cap, void* stream) {
  return launch(q, k, v, out, b, h, kv, sq, sk, d, dv, qsb, qsh, qss, ksb,
                ksh, kss, vsb, vsh, vss, osb, osh, oss, causal, window, scale,
                cap, stream, kF16);
}

// The kernel's resources at head dims d, dv: info[0] registers per thread,
// [1] static and [2] dynamic shared memory per block (bytes), [3] blocks
// resident per SM, [4] threads per block, [5] query rows per block.
int flash_attention_info(int d, int dv, int* info) {
  return info_of(d, dv, info, kF32);
}

// The same for the bf16 form.
int flash_attention_bf16_info(int d, int dv, int* info) {
  return info_of(d, dv, info, kBF16);
}

// The same for the fp16 form.
int flash_attention_f16_info(int d, int dv, int* info) {
  return info_of(d, dv, info, kF16);
}

}  // extern "C"
