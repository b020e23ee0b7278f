// flash_attention_wgmma_f32: the fp32 form of causal flash attention at
// narrow head dims (d = dv in {64, 128, 256}) on Hopper's warpgroup products
// (wgmma) in 3xTF32, fed by the Tensor Memory Accelerator (TMA),
// warp-specialised; sm_90a, a plain C interface loaded by ctypes
// (kernels/_build.py, wrapper in kernels/flash_attention/kernel.py, which
// picks this instantiation by shape: flash_form, "f32_wgmma").
//
// Replaces, for these shapes, the Pallas kernel repro/kernels/
// flash_attention/kernel.py::flash_attention_fwd (body _kernel, call at
// :96) in fp32: q (B, H, Sq, d), k and v (B, KV, Sk, d) -> out (B, H, Sq, d),
// query head hh on KV head hh / (H / KV); suffix-aligned positions (query
// row i sits at i + Sk - Sq); key j visible to position p when j <= p
// (causal) and j > p - window (window > 0); logits q.k * scale,
// tanh-capped, masked; an online softmax in fp32; out = acc / max(l,
// 1e-30). The same function as flash_attention.cu's fp32 form (mma.sync
// m16n8k8, 3xTF32), which keeps the other fp32 shapes: other head dims,
// rows or bases off 16 bytes, and the wide 576 / 512 form.
//
// Bound on an H100 SXM: the causal products, 2 (d + dv) H Sq^2 / 2 flops,
// over the 3xTF32 rate (495 / 3 = 165 TFLOP/s) beside q, k, v and the
// output moved once over 3.35 TB/s. gemma2-2b's prefill (H 8, KV 4, d 256,
// 854 tokens) is 2.99 GFLOP, 0.0181 ms, against 21 MB, 0.0063 ms: bound
// by the products; musicgen-large's (32 heads, d 64, 768 tokens) 0.0147
// ms by the products too.
//
// Precision. Each product is three TF32 products, a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi, accumulated in fp32 (atol = rtol = 1e-4 against the plain
// version needs all three). The tensor core reads an fp32 register or
// shared-memory word as TF32 by dropping its low 13 bits, so the raw fp32
// value is its own "hi" part and only lo = x - trunc_tf32(x) is made:
// K_lo and V_lo in shared memory, Q_lo and P_lo in registers.
//
// Design (FlashAttention-3's shape, as flash_attention_wgmma.cu, in fp32).
// - A block is two consumer warpgroups on the same 64 query rows of one
//   head and two producer warpgroups. The producers' first thread issues
//   TMA loads of the K and V tiles of kBN keys (64, 32 or 16 at d 64, 128
//   or 256: a 16 KiB tile) into a ring of three stages, each on mbarriers
//   of its own. Tensor maps go over the tensors' own (batch, head,
//   sequence) strides (the model layout is read in place): boxes of 32 fp32
//   values (128 bytes) by the tile's rows, 128-byte swizzled; TMA's zero
//   fill pads the ragged last tiles. Key tiles outside the causal band or
//   the window are never loaded; the heaviest (last) query tiles are
//   launched first.
// - wgmma takes TF32 operands from shared memory only K-major (32-bit types
//   have no transpose bit). S = Q.K^T is K-major as TMA lands it; P.V is
//   not (V's reduction dimension, the keys, runs down its rows). Of the two
//   ways round, this kernel transposes each V tile in shared memory (the
//   route FlashAttention-3 takes for fp8) rather than computing O^T =
//   V^T.P^T, because then P stays in registers as the A operand: the S
//   accumulator of an 8-key step is P's A fragment once the keys inside
//   each 8-key step are taken in the order 0 2 4 6 1 3 5 7 (a thread holds
//   keys 2t and 2t + 1 of S, the fragment wants columns t and t + 4), and
//   the transposed V is written in that order. So the output accumulator
//   and the per-row softmax correction are the 16-bit form's; O^T would
//   have put P through shared memory and scaled the accumulator by column,
//   with a row's correction held by 16 threads.
// - Seven more warps of two producer warpgroups make the split operands,
//   off the consumers' path: K_lo beside each K tile; V^T (64-byte
//   swizzle, 16-key column blocks, conflict-free stores) from the landing
//   tile, then V^T_lo over the landing tile. A stage is four 16 KiB tiles
//   (K, K_lo, V^T, landing / V^T_lo); K-ready and V-ready barriers tell the
//   consumers, after a proxy fence, and S = Q.K^T starts while V is
//   transposed.
// - Q stays in registers as A fragments for the whole block, loaded once
//   from device memory (its hi part the raw value, Q_lo kept beside it, or
//   at d 256 made four k-steps at a time into two register sets in turn),
//   so shared memory holds only the ring.
// - S = Q.K^T: wgmma m64n{kBN}k8, B = K or K_lo in shared memory (128-byte
//   swizzle, SBO 1024, a k-step 32 bytes into the atom), three products a
//   k-step. Scale, cap (tanh as 1 - 2 / (exp(2x) + 1)), masks (only on
//   tiles that reach the diagonal, the window's edge or the end of the
//   keys) and the online max and sum run on the S accumulator in
//   registers; a row lives in the four threads of a quad.
// - O += P.V: wgmma m64n{64 or 128}k8 with A = P_hi (the raw P) or P_lo
//   from registers and B = V^T or V^T_lo (64-byte swizzle, SBO 512): three
//   products an 8-key step.
// - Two schedules, by d. At d 64 the two consumers take the key tiles
//   alternately, each over all of Q's 64 columns with its own running max,
//   sum and output, and merge through shared memory at the end. Only at d
//   64 do all of Q's and O's columns fit a consumer's registers, so at d
//   128 and 256 the two split d instead (the D-split): both take every
//   tile, each its half of S's k-steps and of O's columns; the two S
//   halves are summed through shared memory (one barrier a tile) and both
//   run the same softmax. Q stays out of shared memory either way, which
//   at d 256 buys a third stage (a 64 x 256 Q tile is 64 KiB: with it only
//   two stages of 16-key tiles fit and each consumer waited on every load,
//   slower than the mma.sync form). Timed against one consumer taking
//   every tile (kernels.flash_attention.phase_costs, "f32_one_consumer"):
//   PERF.md. Software-pipelining the D-split (tile it + 1's S products in
//   flight during tile it's softmax) made ptxas serialize every wgmma
//   (C7514) and was taken out.
// - Parts: where a call's 64-row tiles do not fill the card (gemma2-2b's
//   prefill: 8 heads x 14 tiles at 854 tokens, under 132 SMs), each tile's
//   key tiles are shared by n_parts blocks in turn (tiles p, p + n_parts,
//   ...; the wrapper's flash_parts picks n_parts), which halves the
//   longest chain of tiles. A part writes its unnormalised (o, m, l) to
//   scratch, fences and counts itself done; the tile's last part merges
//   all the parts' states in part order (so the output does not depend on
//   which finished last) and stores it, and zeroes the counter again.
// - Registers: setmaxnreg gives each consumer thread 224 and the
//   producers' 32.
// - What holds it back (phase_costs' variants, PERF.md): at d 256 a 16-key
//   tile's chain (S products, the exchange, the softmax, P.V, the splits)
//   runs in lockstep in both consumers, and dropping any one phase saves
//   about a third; at d 64 the split operands and the products.
//
// Offsets are 64-bit.

#include <cuda.h>            // CUtensorMap and its enums; the encoder is
                             // reached through the runtime (no -lcuda)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;              // query rows a consumer warpgroup
constexpr int kBox = 32;             // fp32 values a TMA box row (128 bytes)
constexpr int kTileBytes = 16384;    // a K, K_lo, V^T or landing tile
constexpr int kStageBytes = 4 * kTileBytes;
constexpr int kMaxStages = 3;
constexpr int kSplitThreads = 224;   // the producers' seven split warps
constexpr int kSmemCap = 232448;     // dynamic shared memory a block may use
constexpr int kMaxParts = 16;        // blocks a q-tile's key tiles may take
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a 4-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// order this thread's shared-memory stores before the async proxy's reads
// (the warpgroup products)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// keep the compiler from moving accesses of an accumulator across the
// asynchronous products' issue and wait
__device__ __forceinline__ void reg_fence(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// a shared-memory matrix descriptor: start address, stride byte offset
// (between 8-row groups) and swizzle mode (1: 128 bytes, 2: 64 bytes); the
// leading byte offset is unused by swizzled K-major operands
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo,
                                         uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
}

// x less its TF32 part (the 19 high bits the tensor core reads): exact
__device__ __forceinline__ float tf32_lo(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

__device__ __forceinline__ float4 tf32_lo4(float4 x) {
  return make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
}

// D (64 x 16, fp32) (+)= A (64 x 8, tf32, registers) . B (16 x 8, tf32,
// shared, K-major)^T; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_tf32_n16(float* d, const uint32_t* a,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D (64 x 32, fp32) (+)= A (64 x 8, tf32, registers) . B (32 x 8, tf32,
// shared, K-major)^T; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_tf32_n32(float* d, const uint32_t* a,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D (64 x 64, fp32) (+)= A (64 x 8, tf32, registers) . B (64 x 8, tf32,
// shared, K-major)^T; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D (64 x 128, fp32) (+)= A (64 x 8, tf32, registers) . B (128 x 8, tf32,
// shared, K-major)^T; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_tf32_n128(float* d, const uint32_t* a,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <int kN>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t db, int scale_d) {
  if constexpr (kN == 16)
    wgmma_tf32_n16(d, a, db, scale_d);
  else if constexpr (kN == 32)
    wgmma_tf32_n32(d, a, db, scale_d);
  else if constexpr (kN == 64)
    wgmma_tf32_n64(d, a, db, scale_d);
  else
    wgmma_tf32_n128(d, a, db, scale_d);
}

template <int kN>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kN) : "memory");
}

// tanh(x) = 1 - 2 / (exp(2x) + 1): within about 1e-7 of tanhf
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}

// a box's coordinates in a tensor map whose dims 1-3 hold (sequence, head,
// batch) in the order perm gives (two bits each: the sequence's slot, then
// the head's, then the batch's)
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int perm, int col,
                                        int row, int head, int batch) {
  const int ss = perm & 3, sh = (perm >> 2) & 3;
  int c[3];
#pragma unroll
  for (int i = 1; i <= 3; ++i)
    c[i - 1] = ss == i ? row : sh == i ? head : batch;
  tma_load(dst, map, bar, col, c[0], c[1], c[2]);
}

struct Barriers {
  uint64_t k_full[kMaxStages];     // TMA: the K tile landed
  uint64_t v_full[kMaxStages];     // TMA: the V tile landed
  uint64_t k_ready[kMaxStages];    // the split warps: K_lo written
  uint64_t v_ready[kMaxStages];    // the split warps: V^T, V^T_lo written
  uint64_t empty[kMaxStages];      // the consumers: the stage is free
  int last;                        // this part finished its q-tile last
};

// Bytes of the D-split schedule's exchange of S halves (two tile parities,
// two consumers, a 64 x kBN fp32 half each), after the stages.
__host__ __device__ constexpr int xchg_bytes(int d) {
  return d == 64 ? 0 : 2 * 2 * kBM * (kTileBytes / (4 * d)) * 4;
}

// S (or a consumer's half of it) = Q.K^T into s, three TF32 products a
// k-step (Q_lo.K, Q.K_lo, Q.K) over the kQS k-steps from k-step kg0, one
// commit group (four with Q_lo made from qh four k-steps at a time into
// two register sets in turn, a set rewritten once the products that read
// it have completed). kt, klt: the stage's K and K_lo tiles.
template <int kBN, int kQS, bool kLoResident>
__device__ __forceinline__ void s_products(float* s, const uint32_t (*qh)[4],
                                           const uint32_t (*ql)[4],
                                           uint32_t kt, uint32_t klt,
                                           int kg0) {
  if constexpr (kLoResident) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kQS; ++kk) {
      const int kg = kg0 + kk;
      const uint32_t at = (kg >> 2) * (kBN * 128) + (kg & 3) * 32;
      wgmma_tf32<kBN>(s, ql[kk], desc(kt + at, 1024, 1), kk > 0);
      wgmma_tf32<kBN>(s, qh[kk], desc(klt + at, 1024, 1), 1);
      wgmma_tf32<kBN>(s, qh[kk], desc(kt + at, 1024, 1), 1);
    }
    wg_commit();
  } else {
    constexpr int kG = 2;                        // k-steps a set
    uint32_t lo[2][kG][4];
#pragma unroll
    for (int g = 0; g < kQS / kG; ++g) {
      if (g >= 2) wg_wait<1>();
#pragma unroll
      for (int j = 0; j < kG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          lo[g & 1][j][e] =
              __float_as_uint(tf32_lo(__uint_as_float(qh[kG * g + j][e])));
      wg_fence();
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const int kk = kG * g + j, kg = kg0 + kk;
        const uint32_t at = (kg >> 2) * (kBN * 128) + (kg & 3) * 32;
        wgmma_tf32<kBN>(s, lo[g & 1][j], desc(kt + at, 1024, 1), kk > 0);
        wgmma_tf32<kBN>(s, qh[kk], desc(klt + at, 1024, 1), 1);
        wgmma_tf32<kBN>(s, qh[kk], desc(kt + at, 1024, 1), 1);
      }
      wg_commit();
    }
  }
}

// O (a consumer's kN columns from c0) += P.V: three TF32 products an 8-key
// step (the small ones first), one commit group. vtt, vlt: the stage's V^T
// and V^T_lo tiles (16-key blocks of kD 64-byte rows).
template <int kBN, int kD, int kN>
__device__ __forceinline__ void pv_products(float* o, const uint32_t (*ph)[4],
                                            const uint32_t (*pl)[4],
                                            uint32_t vtt, uint32_t vlt,
                                            int c0) {
  wg_fence();
#pragma unroll
  for (int u = 0; u < kBN / 8; ++u) {
    const uint32_t at = (u >> 1) * (kD * 64) + c0 * 64 + (u & 1) * 32;
    wgmma_tf32<kN>(o, pl[u], desc(vtt + at, 512, 2), 1);
    wgmma_tf32<kN>(o, ph[u], desc(vlt + at, 512, 2), 1);
    wgmma_tf32<kN>(o, ph[u], desc(vtt + at, 512, 2), 1);
  }
  wg_commit();
}

// The online softmax of one tile's S in registers: scale, cap, mask (only
// on a tile that reaches the diagonal, the window's edge or the end of the
// keys), the running max m and sum l (of this thread's pairs; the quad's
// sums are taken at the end), and P's TF32 A fragments; returns each row's
// correction of the accumulators in corr. s[4i + e]: row r_loc + 8 (e >> 1)
// (position pos0 + 8 (e >> 1)), key k0 + 8i + 2 (lane & 3) + (e & 1).
template <int kBN>
__device__ __forceinline__ void softmax_tile(
    float* s, float* m, float* l, float* corr, uint32_t (*ph)[4],
    uint32_t (*pl)[4], int k0, int sk, int pos0, int q_first_pos,
    int q_last_pos, int causal, int window, float cap, float sl, float cl,
    float sc, int tq4) {
  const bool edge = k0 + kBN > sk ||
                    (causal && k0 + kBN - 1 > q_first_pos) ||
                    (window > 0 && k0 <= q_last_pos - window);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    float x;
    if (cap > 0.f)
      x = cl * tanh_fast(s[i] * sc);
    else
      x = s[i] * sl;
    if (edge) {
      const int kpos = k0 + 8 * (i >> 2) + 2 * tq4 + (i & 1);
      const int p = pos0 + 8 * ((i >> 1) & 1);
      bool ok = kpos < sk;
      if (causal) ok = ok && kpos <= p;
      if (window > 0) ok = ok && kpos > p - window;
      x = ok ? x : -INFINITY;
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
  // P (masked logits are -inf: exp2 gives 0) and its A fragments: 8-key
  // step u's (rows r, r + 8; columns t, t + 4) are its keys 2t, 2t + 1:
  // s[4u], s[4u + 2], s[4u + 1], s[4u + 3]
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2f(s[i] - m[r]);
    l[r] += s[i];
  }
#pragma unroll
  for (int u = 0; u < kBN / 8; ++u) {
    const float f[4] = {s[4 * u], s[4 * u + 2], s[4 * u + 1], s[4 * u + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ph[u][e] = __float_as_uint(f[e]);
      pl[u][e] = __float_as_uint(tf32_lo(f[e]));
    }
  }
}

// kD: the head dim (64, 128 or 256). Shared memory (1024-byte aligned):
// n_stages stages of four 16 KiB tiles (K, K_lo, V^T, the V landing tile
// that becomes V^T_lo), the exchange of S halves (d 128 and 256), the
// barriers. Threads: two consumer warpgroups, then two producer warpgroups
// (the first thread issues the loads, the seven warps after the first make
// the split operands).
template <int kD>
__global__ void __launch_bounds__(4 * 128, 1)
flash_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const float* __restrict__ q, float* __restrict__ out,
                       int h, int kv, int sq, int sk, int64_t qsb,
                       int64_t qsh, int64_t qss, int64_t osb, int64_t osh,
                       int64_t oss, int causal, int window, float scale,
                       float cap, int n_stages, int perm_k, int perm_v,
                       float* __restrict__ part, int* __restrict__ count,
                       int n_parts) {
  constexpr int kBN = kTileBytes / (4 * kD);     // keys a tile: 64, 32, 16
  constexpr int kNB = kD / kBox;                 // boxes a row
  constexpr int kF4 = kTileBytes / 16;           // float4s a tile
  constexpr int kKB = kBN / 16;                  // 16-key blocks of V^T
  constexpr bool kDeal = kD == 64;               // else the D-split
  constexpr int kHalf = kDeal ? kD : kD / 2;     // Q's and O's columns a
                                                 // consumer holds
  constexpr int kQS = kHalf / 8;                 // its k-steps of S
  constexpr bool kLoResident = kD <= 128;        // Q_lo kept in registers
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  float4* xchg = (float4*)(base_ptr + n_stages * kStageBytes);
  Barriers* bars = (Barriers*)(base_ptr + n_stages * kStageBytes +
                               xchg_bytes(kD));

  // the block's work: a head's 64 rows, part p of the key tiles they see
  // (tiles p, p + n_parts, ...)
  const int head = blockIdx.x % h;
  const int b = blockIdx.x / h;
  const int n_qt = gridDim.y / n_parts;
  const int qi = blockIdx.y / n_parts, p = blockIdx.y % n_parts;
  const int q0 = (n_qt - 1 - qi) * kBM;          // heaviest first
  const int off = sk - sq;                       // suffix alignment
  const int q_last = min(q0 + kBM, sq) - 1;
  const int k_end = causal ? min(sk, q_last + off + 1) : sk;
  const int t_first =
      (window > 0 ? max(0, q0 + off - window + 1) : 0) / kBN;
  const int n_all =
      k_end > t_first * kBN ? (k_end - t_first * kBN + kBN - 1) / kBN : 0;
  const int n_tiles = n_all > p ? (n_all - p + n_parts - 1) / n_parts : 0;
  // the first key of the block's tile it
  auto key0 = [&](int it) { return (t_first + p + it * n_parts) * kBN; };
  const int kh = head / (h / kv);

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(smem_u32(&bars->k_full[s]), 1);
      mbar_init(smem_u32(&bars->v_full[s]), 1);
      mbar_init(smem_u32(&bars->k_ready[s]), kSplitThreads);
      mbar_init(smem_u32(&bars->v_ready[s]), kSplitThreads);
      // the threads of the consumers that read the stage arrive
      mbar_init(smem_u32(&bars->empty[s]), kDeal ? 128 : 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg >= 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
    const int pt = threadIdx.x - 2 * 128;
    if (pt == 0) {
      // ---- the loads: every K and V tile into the ring ----
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % n_stages;
        if (it >= n_stages)
          mbar_wait(smem_u32(&bars->empty[st]), ((it / n_stages) & 1) ^ 1);
        const int k0 = key0(it);
        const uint32_t stage = base + st * kStageBytes;
        const uint32_t bk = smem_u32(&bars->k_full[st]);
        const uint32_t bv = smem_u32(&bars->v_full[st]);
        mbar_expect_tx(bk, kTileBytes);
#pragma unroll
        for (int cb = 0; cb < kNB; ++cb)
          tma_box(stage + cb * (kBN * 128), &tk, bk, perm_k, cb * kBox, k0,
                  kh, b);
        mbar_expect_tx(bv, kTileBytes);
#pragma unroll
        for (int cb = 0; cb < kNB; ++cb)
          tma_box(stage + 3 * kTileBytes + cb * (kBN * 128), &tv, bv, perm_v,
                  cb * kBox, k0, kh, b);
      }
    } else if (pt >= 32) {
      // ---- the split operands of every tile ----
      const int x = pt - 32;
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % n_stages;
        const uint32_t par = (it / n_stages) & 1;
        unsigned char* stage = base_ptr + st * kStageBytes;
        const float4* kt = (const float4*)stage;
        float4* klt = (float4*)(stage + kTileBytes);
        unsigned char* vt = stage + 2 * kTileBytes;
        unsigned char* land = stage + 3 * kTileBytes;
        // K_lo: the K tile's bytes, elementwise (the same swizzled layout)
        mbar_wait(smem_u32(&bars->k_full[st]), par);
        for (int i = x; i < kF4; i += kSplitThreads) klt[i] = tf32_lo4(kt[i]);
        fence_async_smem();
        mbar_arrive(smem_u32(&bars->k_ready[st]));
        // V^T: element (key j, column n) of the landing tile (box n / 32,
        // row j, 128-byte swizzle) to row n of V^T's 16-key block j / 16
        // (64-byte rows, 64-byte swizzle) at slot 8 ((j >> 3) & 1) + w / 2
        // + 4 (w & 1), w = j & 7: each 8-key step in the key order 0 2 4 6
        // 1 3 5 7 that makes the S accumulator P's A fragment. A warp's
        // lanes take 16 keys of two 4-column groups; the upper half-warp
        // stores its columns in the order 1 0 3 2, so a store's 32 lanes hit
        // rows of both parities: 32 banks.
        mbar_wait(smem_u32(&bars->v_full[st]), par);
        for (int i = x; i < kF4; i += kSplitThreads) {
          const int half = (i >> 4) & 1, grp = i >> 5;
          const int j = (i & 15) + 16 * (grp % kKB);
          const int n0 = 4 * (half + 2 * (grp / kKB));
          const float4 v4 = *(const float4*)(
              land + (n0 >> 5) * (kBN * 128) + j * 128 +
              ((((n0 & 31) >> 2) ^ (j & 7)) << 4));
          const float vals[4] = {v4.x, v4.y, v4.z, v4.w};
          const int w = j & 7;
          const int slot = 8 * ((j >> 3) & 1) + (w >> 1) + 4 * (w & 1);
          unsigned char* blk = vt + (j >> 4) * (kD * 64);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = n0 + (e ^ half);
            *(float*)(blk + n * 64 +
                      (((slot >> 2) ^ ((n >> 1) & 3)) << 4) +
                      4 * (slot & 3)) = half ? vals[e ^ 1] : vals[e];
          }
        }
        asm volatile("bar.sync 2, %0;\n" ::"n"(kSplitThreads) : "memory");
        // V^T_lo over the landing tile, elementwise from V^T
        for (int i = x; i < kF4; i += kSplitThreads)
          ((float4*)land)[i] = tf32_lo4(((const float4*)vt)[i]);
        fence_async_smem();
        mbar_arrive(smem_u32(&bars->v_ready[st]));
      }
    }
    return;
  }

  // ---- a consumer warpgroup: the 64 rows; dealt every other key tile
  // over all of d, or (D-split) every tile over its half of d: S's
  // k-steps and O's columns ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int t = threadIdx.x % 128;
  const int w = t >> 5, lane = t & 31, tq4 = lane & 3;
  const int r_loc = 16 * w + (lane >> 2);        // rows r_loc, r_loc + 8
  const int pos0 = q0 + r_loc + off;             // their positions
  const int q_first_pos = q0 + off, q_last_pos = q0 + kBM - 1 + off;
  const int c0 = kDeal ? 0 : wg * kHalf;         // its first column
  const float sl = scale * kLog2e;               // logits in log2 units
  const float cl = cap * kLog2e;
  const float sc = cap > 0.f ? scale / cap : 0.f;

  // Q's A fragments of the consumer's k-steps (columns c0 + 8 kk + t, + 4
  // of rows r_loc, r_loc + 8), loaded once from device memory (rows past
  // sq zero); the raw value is the hi part
  uint32_t qh[kQS][4], ql[kLoResident ? kQS : 1][4];
#pragma unroll
  for (int kk = 0; kk < kQS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + r_loc + 8 * (e & 1);
      const int col = c0 + 8 * kk + tq4 + 4 * (e >> 1);
      const float x = row < sq ? q[(int64_t)b * qsb + (int64_t)head * qsh +
                                   (int64_t)row * qss + col]
                               : 0.f;
      qh[kk][e] = __float_as_uint(x);
      if constexpr (kLoResident) ql[kk][e] = __float_as_uint(tf32_lo(x));
    }

  float o[kHalf / 2];
#pragma unroll
  for (int i = 0; i < kHalf / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  float s[kBN / 2];
  uint32_t ph[kBN / 8][4], pl[kBN / 8][4];
  auto stage_of = [&](int it) { return base + (it % n_stages) * kStageBytes; };
  auto parity = [&](int it) { return (uint32_t)((it / n_stages) & 1); };
  auto wait_k = [&](int it) {
    mbar_wait(smem_u32(&bars->k_full[it % n_stages]), parity(it));
    mbar_wait(smem_u32(&bars->k_ready[it % n_stages]), parity(it));
  };

  // dealt: every other tile from wg; D-split: every tile
  for (int it = kDeal ? wg : 0; it < n_tiles; it += kDeal ? 2 : 1) {
    const uint32_t kt = stage_of(it);
    wait_k(it);
    s_products<kBN, kQS, kLoResident>(s, qh, ql, kt, kt + kTileBytes,
                                      c0 / 8);
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) reg_fence(s[i]);
    if constexpr (!kDeal) {
      // S = the two consumers' halves, summed in the same order by both
      // (each writes its half at the tile's parity, one barrier, each
      // reads the other's: a parity is rewritten two tiles on, after the
      // other consumer has passed the next tile's barrier)
      float4* mine = xchg + ((it & 1) * 2 + wg) * (kBN / 8) * 128;
      const float4* theirs =
          xchg + ((it & 1) * 2 + (wg ^ 1)) * (kBN / 8) * 128;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i)
        mine[i * 128 + t] =
            make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        const float4 y = theirs[i * 128 + t];
        const float a0 = wg ? y.x : s[4 * i], a1 = wg ? y.y : s[4 * i + 1];
        const float a2 = wg ? y.z : s[4 * i + 2], a3 = wg ? y.w : s[4 * i + 3];
        const float b0 = wg ? s[4 * i] : y.x, b1 = wg ? s[4 * i + 1] : y.y;
        const float b2 = wg ? s[4 * i + 2] : y.z, b3 = wg ? s[4 * i + 3] : y.w;
        s[4 * i] = a0 + b0;
        s[4 * i + 1] = a1 + b1;
        s[4 * i + 2] = a2 + b2;
        s[4 * i + 3] = a3 + b3;
      }
    }
    softmax_tile<kBN>(s, m, l, corr, ph, pl, key0(it), sk, pos0,
                      q_first_pos, q_last_pos, causal, window, cap, sl, cl,
                      sc, tq4);
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    mbar_wait(smem_u32(&bars->v_ready[it % n_stages]), parity(it));
    pv_products<kBN, kD, kHalf>(o, ph, pl, kt + 2 * kTileBytes,
                                kt + 3 * kTileBytes, c0);
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) reg_fence(o[i]);
    mbar_arrive(smem_u32(&bars->empty[it % n_stages]));
  }

  // the rows' sums over the quad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (kDeal) {
    // the second warpgroup hands its (o, m, l) to the first through the
    // stages (every tile has been consumed: no load or split is in flight)
    float4* xo = (float4*)base_ptr;
    float4* xs = xo + (kD / 8) * 128;
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < kD / 8; ++i)
        xo[i * 128 + t] =
            make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
      xs[t] = make_float4(m[0], m[1], l[0], l[1]);
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (wg == 1) return;
    const float4 y = xs[t];
    const float ym[2] = {y.x, y.y}, yl[2] = {y.z, y.w};
    float ca[2], cb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mm = fmaxf(m[r], ym[r]);
      ca[r] = exp2f(m[r] - mm);
      cb[r] = exp2f(ym[r] - mm);
      l[r] = l[r] * ca[r] + yl[r] * cb[r];
      m[r] = mm;
    }
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      const float4 z = xo[i * 128 + t];
      o[4 * i] = o[4 * i] * ca[0] + z.x * cb[0];
      o[4 * i + 1] = o[4 * i + 1] * ca[0] + z.y * cb[0];
      o[4 * i + 2] = o[4 * i + 2] * ca[1] + z.z * cb[1];
      o[4 * i + 3] = o[4 * i + 3] * ca[1] + z.w * cb[1];
    }
  }

  if (n_parts > 1) {
    // this part's (o, m, l), unnormalised, to its slot of ``part`` ((o: 64
    // x kD, m: 64, l: 64) a part); the q-tile's last part to finish merges
    // them and stores the output
    const int n_cons = kDeal ? 128 : 256;        // consumer threads left
    const int64_t tile_id = (int64_t)blockIdx.x * n_qt + qi;
    float* mine = part + (tile_id * n_parts + p) * (kBM * (kD + 2));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_loc + 8 * r;
#pragma unroll
      for (int i = 0; i < kHalf / 8; ++i)
        *reinterpret_cast<float2*>(mine + row * kD + c0 + 8 * i + 2 * tq4) =
            make_float2(o[4 * i + 2 * r], o[4 * i + 2 * r + 1]);
      if (tq4 == 0 && wg == 0) {
        mine[kBM * kD + row] = m[r];
        mine[kBM * kD + kBM + row] = l[r];
      }
    }
    __threadfence();
    asm volatile("bar.sync 3, %0;\n" ::"r"(n_cons) : "memory");
    if (t == 0 && wg == 0) {
      // every part has counted: the counter goes back to zero for the
      // next launch
      bars->last = atomicAdd(count + tile_id, 1) == n_parts - 1;
      if (bars->last) count[tile_id] = 0;
    }
    asm volatile("bar.sync 3, %0;\n" ::"r"(n_cons) : "memory");
    if (!bars->last) return;
    // every part's state, this one's too, merged in part order into an
    // empty one: the same sums whichever part finishes last
    __threadfence();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) o[i] = 0.f;
    for (int pp = 0; pp < n_parts; ++pp) {
      const float* other =
          part + (tile_id * n_parts + pp) * (kBM * (kD + 2));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r_loc + 8 * r;
        const float mq = __ldcg(other + kBM * kD + row);
        const float lq = __ldcg(other + kBM * kD + kBM + row);
        const float mm = fmaxf(m[r], mq);
        const float ca = exp2f(m[r] - mm), cb = exp2f(mq - mm);
        m[r] = mm;
        l[r] = l[r] * ca + lq * cb;
#pragma unroll
        for (int i = 0; i < kHalf / 8; ++i) {
          const float2 z = __ldcg(reinterpret_cast<const float2*>(
              other + row * kD + c0 + 8 * i + 2 * tq4));
          o[4 * i + 2 * r] = o[4 * i + 2 * r] * ca + z.x * cb;
          o[4 * i + 2 * r + 1] = o[4 * i + 2 * r + 1] * ca + z.y * cb;
        }
      }
    }
  }

  // out = o / max(l, 1e-30); o[4i + e]: row r_loc + 8 (e >> 1), column
  // c0 + 8i + 2 (lane & 3) + (e & 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r_loc + 8 * r;
    if (row >= sq) continue;
    float* orow = out + (int64_t)b * osb + (int64_t)head * osh +
                  (int64_t)row * oss + c0 + 2 * tq4;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < kHalf / 8; ++i)
      *reinterpret_cast<float2*>(orow + 8 * i) =
          make_float2(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found once through the runtime
Encode encoder() {
  static Encode fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    if (err == cudaSuccess && got == cudaDriverEntryPointSuccess)
      fn = (Encode)p;
  }
  return fn;
}

// A tensor map over an (n_b, n_h, n_s, d) fp32 tensor with (batch, head,
// sequence) strides in elements and d contiguous: dims (d, then the three
// outer ones by increasing stride, those of size 1 last), boxes of 32
// values by `rows` rows of the sequence, 128-byte swizzle, zeros past the
// ends. perm gets the sequence's, head's and batch's slots (1-3).
cudaError_t make_map(CUtensorMap* map, const void* p, int n_b, int64_t sb,
                     int n_h, int64_t sh, int n_s, int64_t ss, int d,
                     int rows, int* perm) {
  const Encode enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  int64_t stride[3] = {ss, sh, sb};
  int64_t size[3] = {n_s, n_h, n_b};
  int order[3] = {0, 1, 2};
  // sizes above 1 first, by stride (a size-1 dim's stride is never used)
  auto key = [&](int i) { return size[i] > 1 ? stride[i] : INT64_MAX; };
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (key(order[j]) < key(order[i])) {
        const int x = order[i];
        order[i] = order[j];
        order[j] = x;
      }
  cuuint64_t dims[4] = {(cuuint64_t)d, 1, 1, 1};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {kBox, 1, 1, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  int slot[3];
  int64_t last = (int64_t)d * 4, last_n = 1;     // bytes, the span so far
  for (int i = 0; i < 3; ++i) {
    const int o = order[i];
    slot[o] = i + 1;
    dims[i + 1] = (cuuint64_t)size[o];
    int64_t bytes = stride[o] * 4;
    if (size[o] == 1) bytes = ((last * last_n + 15) / 16) * 16;
    strides[i] = (cuuint64_t)bytes;
    last = bytes;
    last_n = size[o];
    if (o == 0) box[i + 1] = (cuuint32_t)rows;
  }
  *perm = slot[0] | slot[1] << 2 | slot[2] << 4;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                         const_cast<void*>(p), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

using Kernel = void (*)(CUtensorMap, CUtensorMap, const float*, float*, int,
                        int, int, int, int64_t, int64_t, int64_t, int64_t,
                        int64_t, int64_t, int, int, float, float, int, int,
                        int, float*, int*, int);

const void* kernel_of(int d) {
  return d == 64    ? (const void*)flash_f32_wgmma_kernel<64>
         : d == 128 ? (const void*)flash_f32_wgmma_kernel<128>
                    : (const void*)flash_f32_wgmma_kernel<256>;
}

int d_slot(int d) { return d == 64 ? 0 : d == 128 ? 1 : 2; }

// keys a K/V tile at head dim d (a 16 KiB tile)
int key_tile(int d) { return kTileBytes / (4 * d); }

// the ring of stages that fits a block beside the exchange of S halves
void plan(int d, int* n_stages, size_t* smem) {
  const size_t fixed = 1024 + sizeof(Barriers) + xchg_bytes(d);
  const int s = (int)((kSmemCap - fixed) / kStageBytes);
  *n_stages = s > kMaxStages ? kMaxStages : s;
  *smem = fixed + (size_t)kStageBytes * *n_stages;
}

bool dims_ok(int d) { return d == 64 || d == 128 || d == 256; }

// Raise a kernel's dynamic shared-memory limit only when a larger size is
// first asked for on the current device, so launches captured in a CUDA
// graph make no such call.
size_t configured[kMaxDevices][3] = {};

cudaError_t configure(int d, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  size_t& have = configured[dev][d_slot(d)];
  if (smem <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel_of(d),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) have = smem;
  return err;
}

// TMA's rule: a 16-byte aligned base, strides of whole 16 bytes (4 fp32
// values; a dim of size 1 aside)
bool aligned(const void* p, int n0, int64_t s0, int n1, int64_t s1, int n2,
             int64_t s2) {
  return (uintptr_t)p % 16 == 0 && (n0 == 1 || s0 % 4 == 0) &&
         (n1 == 1 || s1 % 4 == 0) && (n2 == 1 || s2 % 4 == 0);
}

}  // namespace

extern "C" {

// q (b, h, sq, d), k and v (b, kv, sk, d), out (b, h, sq, d), all fp32,
// d in {64, 128, 256} contiguous, the other three dims strided (elements):
// q, k and v 16-byte aligned with strides of multiples of 4 (dims of size
// 1 aside), out 8-byte aligned with even strides. n_parts blocks share each
// 64-row tile's key tiles (1 to kMaxParts); above 1, part holds b h
// ceil(sq / 64) n_parts 64 (d + 2) floats of scratch and count b h
// ceil(sq / 64) ints, zero at the launch (and again after it).
int flash_attention_f32_wgmma(const void* q, const void* k, const void* v,
                              void* out, int b, int h, int kv, int sq,
                              int sk, int d, int64_t qsb, int64_t qsh,
                              int64_t qss, int64_t ksb, int64_t ksh,
                              int64_t kss, int64_t vsb, int64_t vsh,
                              int64_t vss, int64_t osb, int64_t osh,
                              int64_t oss, int causal, int window,
                              float scale, float cap, void* part,
                              void* count, int n_parts, void* stream) {
  if (!dims_ok(d) || kv <= 0 || h % kv != 0 || n_parts < 1 ||
      n_parts > kMaxParts || (n_parts > 1 && (part == nullptr ||
                                              count == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (!aligned(q, b, qsb, h, qsh, sq, qss) ||
      !aligned(k, b, ksb, kv, ksh, sk, kss) ||
      !aligned(v, b, vsb, kv, vsh, sk, vss) || (uintptr_t)out % 8 != 0 ||
      osb % 2 != 0 || osh % 2 != 0 || oss % 2 != 0)
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || sq <= 0) return (int)cudaGetLastError();
  if (sk <= 0) return (int)cudaErrorInvalidValue;
  const int n_qt = (sq + kBM - 1) / kBM;
  if ((int64_t)n_qt * n_parts > 65535 || (int64_t)b * h > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  int n_stages;
  size_t smem;
  plan(d, &n_stages, &smem);
  cudaError_t err = configure(d, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tk, tv;
  int pk, pv;
  const int bn = key_tile(d);
  if ((err = make_map(&tk, k, b, ksb, kv, ksh, sk, kss, d, bn, &pk)) !=
          cudaSuccess ||
      (err = make_map(&tv, v, b, vsb, kv, vsh, sk, vss, d, bn, &pv)) !=
          cudaSuccess)
    return (int)err;
  const dim3 grid((unsigned)(b * h), (unsigned)(n_qt * n_parts));
  const Kernel kern = (Kernel)kernel_of(d);
  kern<<<grid, 4 * 128, smem, (cudaStream_t)stream>>>(
      tk, tv, (const float*)q, (float*)out, h, kv, sq, sk, qsb, qsh, qss,
      osb, osh, oss, causal, window, scale, cap, n_stages, pk, pv,
      (float*)part, (int*)count, n_parts);
  return (int)cudaGetLastError();
}

// The kernel's resources at head dim d: info[0] registers per thread (at
// launch: setmaxnreg moves them between the roles), [1] static and [2]
// dynamic shared memory per block (bytes), [3] blocks resident per SM,
// [4] threads per block, [5] query rows per block, [6] stages, [7] keys a
// K/V tile.
int flash_attention_f32_wgmma_info(int d, int* info) {
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  int n_stages;
  size_t smem;
  plan(d, &n_stages, &smem);
  cudaError_t err = configure(d, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel_of(d));
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(d),
                                                      4 * 128, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)smem;
  info[3] = per_sm;
  info[4] = 4 * 128;
  info[5] = kBM;
  info[6] = n_stages;
  info[7] = key_tile(d);
  return 0;
}

}  // extern "C"
