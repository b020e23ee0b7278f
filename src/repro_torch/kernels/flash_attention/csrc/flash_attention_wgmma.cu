// flash_attention_wgmma: the 16-bit forms (bf16, and fp16 in a library of
// its own: flash_attention_wgmma_f16.cu) of causal flash attention at narrow
// head dims (d = dv in {64, 128, 256}) on Hopper's warpgroup products
// (wgmma) fed by the Tensor Memory Accelerator (TMA), warp-specialised;
// sm_90a, a plain C interface loaded by ctypes (kernels/_build.py, wrapper
// in kernels/flash_attention/kernel.py, which picks this instantiation by
// shape: flash_form). The text below says bf16; the fp16 form is the same
// source over __half (T16): wgmma's .f16 products, TMA's FLOAT16 maps, P
// split into fp16 hi and lo (elt16.cuh bounds the error), the output
// rounded to fp16 once; the scores, the running max and sum and the
// accumulators stay fp32, so only the output can overflow, as the
// reference's does.
//
// Replaces, for these shapes, the Pallas kernel repro/kernels/
// flash_attention/kernel.py::flash_attention_fwd (body _kernel) in bf16:
// q (B, H, Sq, d), k and v (B, KV, Sk, d) -> out (B, H, Sq, d), query head
// hh on KV head hh / (H / KV); suffix-aligned positions (query row i sits
// at i + Sk - Sq); key j visible to position p when j <= p (causal) and
// j > p - window (window > 0); logits q.k * scale, tanh-capped, masked; an
// online softmax in fp32; out = acc / max(l, 1e-30) rounded to bf16. The
// same function as flash_attention.cu's bf16 form (flash_kernel_16),
// which keeps the other shapes: odd or unaligned head dims and rows, and
// the wide 576 / 512 form.
//
// Bound on an H100 SXM at gemma2-2b's prefill (B 1, H 8, KV 4, d 256, Sq =
// Sk = 100 to 1000): the causal products, 4 d H Sq^2 / 2 flops, over the
// dense bf16 rate (989 TFLOP/s) beside q, k, v and the output moved once
// over 3.35 TB/s; at Sq 854, 2.99 GFLOP (0.00302 ms) against 10.5 MB
// (0.00313 ms): the two are level, and the work is too small to fill the
// card (8 heads x 14 query tiles of 64 rows), so the latency of one
// block's chain of key tiles is what the schedule below shortens. P.V
// runs twice (below), half again the products of the bound.
//
// Design (FlashAttention-3's shape).
// - A block is one producer warpgroup and two consumer warpgroups on the
//   same 64 query rows of one head. The producer's first thread issues
//   TMA loads: the block's Q tile once, then the K and V tiles of 64 keys
//   into a ring of stages (2 to 4), each tile completing on an mbarrier of
//   its own (K and V apart, so S = Q.K^T starts while V is in flight); a
//   consumer releases a stage on a third barrier. Tensor maps (built on the
//   host in the C entry, passed as __grid_constant__ parameters) go over
//   the tensors' own (batch, head, sequence) strides, so the model layout
//   (B, S, N, d) is read in place; boxes of 64 values (128 bytes) by 64
//   rows, 128-byte swizzled; TMA's zero fill pads the ragged last tiles.
// - S = Q.K^T: wgmma m64n64k16 with both operands in shared memory,
//   K-major, 128-byte swizzle (descriptors: SBO 1024 bytes, a k-step of 16
//   values 32 bytes into the swizzle atom). Scale, cap (tanh as 1 - 2 /
//   (exp(2x) + 1)), masks (only on tiles that reach the diagonal, the
//   window's edge or the end of the keys) and the online max and sum run
//   on the S accumulator in registers; a row lives in the four threads of
//   a quad (two shuffles).
// - O += P.V: wgmma m64n{d}k16 with A = P from registers (the S
//   accumulator of two 8-key steps is the A fragment of a 16-key step) and
//   B = V in shared memory, MN-major (the transposed B, which bf16 allows;
//   LBO 8192 bytes between 64-column blocks, SBO 1024 between 8-key
//   groups). P is split into bf16 hi and lo parts, two products (16
//   mantissa bits of each weight kept; rounding P to bf16 alone errs by up
//   to 2^-9 of a weight, which outputs near zero would not pass).
// - Registers: the 64 x 256 fp32 output accumulator is 128 a thread;
//   setmaxnreg gives each consumer thread 240 and the producer's 24.
// - The key tiles are dealt alternately to the two consumers (each keeps
//   its own running max, sum and output) and the two merge through shared
//   memory at the end, so a block's chain of key tiles is half the causal
//   range: gemma2-2b's prefill gives 8 heads x 14 query tiles, fewer
//   blocks than SMs, and the longest chain sets the call's time. Timed on
//   an H100 against three other schedules of the same kernel (one
//   consumer of 64 rows; two on the same rows of a GQA pair of heads,
//   sharing each K/V tile; two on 128 rows of one head) at 550 and 854
//   tokens, this one was the fastest (PERF.md's table of kernels), and it
//   alone is kept. The heaviest (last) query tiles are launched first.
// - What holds it back (kernels.flash_attention.phase_costs, one H100):
//   P.V's two products and the softmax; the loads are hidden.
//
// Offsets are 64-bit.

#include <cuda.h>            // CUtensorMap and its enums; the encoder is
                             // reached through the runtime (no -lcuda)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/elt16.cuh"

// The library's element type T16 (elt16.cuh) and what names it: bf16 by
// default, fp16 with FLASH_WGMMA_F16 defined (flash_attention_wgmma_f16.cu
// includes this file), each library its own entries.
#ifdef FLASH_WGMMA_F16
#define WG_TY "f16"
#define WG_TMA_TYPE CU_TENSOR_MAP_DATA_TYPE_FLOAT16
#define WG_ENTRY flash_attention_f16_wgmma
#define WG_INFO flash_attention_f16_wgmma_info
#else
#define WG_TY "bf16"
#define WG_TMA_TYPE CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
#define WG_ENTRY flash_attention_bf16_wgmma
#define WG_INFO flash_attention_bf16_wgmma_info
#endif

namespace {

#ifdef FLASH_WGMMA_F16
using T16 = __half;
#else
using T16 = __nv_bfloat16;
#endif

constexpr int kBM = 64;              // query rows a consumer warpgroup
constexpr int kBN = 64;              // keys a K/V tile
constexpr int kBox = 64;             // values a TMA box row (128 bytes)
constexpr int kBoxBytes = kBox * 2 * 64;   // one 64 x 64 box: 8 KiB
constexpr int kMaxStages = 4;
constexpr int kSmemCap = 232448;     // dynamic shared memory a block may use
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

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of an accumulator across the
// asynchronous products' issue and wait
__device__ __forceinline__ void reg_fence(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// a shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t sw128(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D (64 x 64, fp32) (+)= A (64 x 16, bf16, shared, K-major) . B (64 x 16,
// bf16, shared, K-major)^T; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." WG_TY "." WG_TY " "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, bf16, registers) . B (16 x 64, bf16,
// shared, MN-major: the transposed B)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." WG_TY "." WG_TY " "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
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

// D (64 x 128, fp32) += A (64 x 16, bf16, registers) . B (16 x 128, bf16,
// shared, MN-major: the transposed B)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." WG_TY "." WG_TY " "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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

// D (64 x 256, fp32) += A (64 x 16, bf16, registers) . B (16 x 256, bf16,
// shared, MN-major: the transposed B)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." WG_TY "." WG_TY " "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <int kD>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (kD == 64)
    wgmma_rs_n64(o, a, db, 1);
  else if constexpr (kD == 128)
    wgmma_rs_n128(o, a, db, 1);
  else
    wgmma_rs_n256(o, a, db, 1);
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
  uint64_t q_full;
  uint64_t k_full[kMaxStages];
  uint64_t v_full[kMaxStages];
  uint64_t empty[kMaxStages];
};

// kD: the head dim (64, 128 or 256). Shared memory (1024-byte aligned):
// the Q tile (64 rows, kD / 64 boxes), then n_stages K tiles and n_stages
// V tiles (64 keys, kD / 64 boxes each), then the barriers. Threads: two
// consumer warpgroups, then the producer's.
template <int kD>
__global__ void __launch_bounds__(3 * 128, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   T16* __restrict__ out, int h, int kv, int sq, int sk,
                   int64_t osb, int64_t osh, int64_t oss, int causal,
                   int window, float scale, float cap, int n_stages,
                   int perm_q, int perm_k, int perm_v) {
  constexpr int kCB = kD / kBox;                 // boxes a row
  constexpr int kTileBytes = kCB * kBoxBytes;    // a 64-row tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + kTileBytes;
  const uint32_t v_s = k_s + n_stages * kTileBytes;
  Barriers* bars = (Barriers*)(base_ptr + (1 + 2 * n_stages) * kTileBytes);
  const uint32_t bar_q = smem_u32(&bars->q_full);

  // the block's work: a head's 64 rows, the key tiles they see
  const int head = blockIdx.x % h;
  const int b = blockIdx.x / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;    // heaviest first
  const int off = sk - sq;                       // suffix alignment
  const int q_last = min(q0 + kBM, sq) - 1;
  const int k_end = causal ? min(sk, q_last + off + 1) : sk;
  const int t_first =
      (window > 0 ? max(0, q0 + off - window + 1) : 0) / kBN;
  const int n_tiles =
      k_end > t_first * kBN ? (k_end - t_first * kBN + kBN - 1) / kBN : 0;
  const int kh = head / (h / kv);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(smem_u32(&bars->k_full[s]), 1);
      mbar_init(smem_u32(&bars->v_full[s]), 1);
      // the consumer's threads that read the stage arrive
      mbar_init(smem_u32(&bars->empty[s]), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- the producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 2 * 128) return;
    mbar_expect_tx(bar_q, kTileBytes);
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
      tma_box(q_s + cb * kBoxBytes, &tq, bar_q, perm_q, cb * kBox, q0, head,
              b);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % n_stages;
      if (it >= n_stages)
        mbar_wait(smem_u32(&bars->empty[st]), ((it / n_stages) & 1) ^ 1);
      const int k0 = (t_first + it) * kBN;
      const uint32_t bk = smem_u32(&bars->k_full[st]);
      const uint32_t bv = smem_u32(&bars->v_full[st]);
      mbar_expect_tx(bk, kTileBytes);
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb)
        tma_box(k_s + st * kTileBytes + cb * kBoxBytes, &tk, bk, perm_k,
                cb * kBox, k0, kh, b);
      mbar_expect_tx(bv, kTileBytes);
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb)
        tma_box(v_s + st * kTileBytes + cb * kBoxBytes, &tv, bv, perm_v,
                cb * kBox, k0, kh, b);
    }
  } else {
    // ---- a consumer warpgroup: the 64 rows, every other key tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x % 128;
    const int w = t >> 5, lane = t & 31;
    const int r_loc = 16 * w + (lane >> 2);      // rows r_loc, r_loc + 8
    const int pos0 = q0 + r_loc + off;           // their positions
    const int q_first_pos = q0 + off, q_last_pos = q0 + kBM - 1 + off;
    const float sl = scale * kLog2e;             // logits in log2 units
    const float cl = cap * kLog2e;
    const float sc = cap > 0.f ? scale / cap : 0.f;

    float o[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(bar_q, 0);
    for (int it = wg; it < n_tiles; it += 2) {
      const int st = it % n_stages;
      const uint32_t par = (it / n_stages) & 1;
      const int k0 = (t_first + it) * kBN;
      const uint32_t kt = k_s + st * kTileBytes;
      const uint32_t vt = v_s + st * kTileBytes;

      // S = Q.K^T over kD / 16 k-steps
      float s[32];
      mbar_wait(smem_u32(&bars->k_full[st]), par);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t at = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
        wgmma_ss_n64(s, sw128(q_s + at, 16, 1024),
                     sw128(kt + at, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(s[i]);

      // scale, cap, mask; s[4i + e]: row r_loc + 8 (e >> 1), key
      // k0 + 8i + 2 (lane & 3) + (e & 1)
      const bool edge = k0 + kBN > sk ||
                        (causal && k0 + kBN - 1 > q_first_pos) ||
                        (window > 0 && k0 <= q_last_pos - window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x;
        if (cap > 0.f)
          x = cl * tanh_fast(s[i] * sc);
        else
          x = s[i] * sl;
        if (edge) {
          const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int p = pos0 + 8 * ((i >> 1) & 1);
          bool ok = kpos < sk;
          if (causal) ok = ok && kpos <= p;
          if (window > 0) ok = ok && kpos > p - window;
          x = ok ? x : -INFINITY;
        }
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
      // P (masked logits are -inf: exp2 gives 0) and its hi / lo A
      // fragments: 16-key step u is S's 8-key steps 2u and 2u + 1
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = exp2f(s[i] - m[r]);
        l[r] += s[i];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split2<T16>(s[8 * u + 2 * j], s[8 * u + 2 * j + 1], ph[u][j],
                      pl[u][j]);
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // O += P.V, the small products (P's lo) first
      mbar_wait(smem_u32(&bars->v_full[st]), par);
      wg_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wgmma_pv<kD>(o, pl[u], sw128(vt + u * 16 * 128, kBoxBytes, 1024));
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wgmma_pv<kD>(o, ph[u], sw128(vt + u * 16 * 128, kBoxBytes, 1024));
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) reg_fence(o[i]);
      mbar_arrive(smem_u32(&bars->empty[st]));
    }

    // the rows' sums over the quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    {
      // the second warpgroup hands its (o, m, l) to the first through the
      // K/V stages (every tile has been consumed: no load is in flight)
      float4* xo = (float4*)(base_ptr + kTileBytes);
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

    // out = o / max(l, 1e-30), rounded to T16; o[4i + e]: row r_loc +
    // 8 (e >> 1), column 8i + 2 (lane & 3) + (e & 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r_loc + 8 * r;
      if (row >= sq) continue;
      T16* orow = out + (int64_t)b * osb + (int64_t)head * osh +
                   (int64_t)row * oss + 2 * (lane & 3);
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int i = 0; i < kD / 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) =
            pack2<T16>(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
    }
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

// A tensor map over an (n_b, n_h, n_s, d) tensor of T16 with (batch, head,
// sequence) strides in elements and d contiguous: dims (d, then the three
// outer ones by increasing stride, those of size 1 last), boxes of 64
// values by 64 rows of the sequence, 128-byte swizzle, zeros past the
// ends. perm gets the sequence's, head's and batch's slots (1-3).
cudaError_t make_map(CUtensorMap* map, const void* p, int n_b, int64_t sb,
                     int n_h, int64_t sh, int n_s, int64_t ss, int d,
                     int* perm) {
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
  int64_t last = (int64_t)d * 2, last_n = 1;     // bytes, the span so far
  for (int i = 0; i < 3; ++i) {
    const int o = order[i];
    slot[o] = i + 1;
    dims[i + 1] = (cuuint64_t)size[o];
    int64_t bytes = stride[o] * 2;
    if (size[o] == 1) bytes = ((last * last_n + 15) / 16) * 16;
    strides[i] = (cuuint64_t)bytes;
    last = bytes;
    last_n = size[o];
    if (o == 0) box[i + 1] = kBM;
  }
  *perm = slot[0] | slot[1] << 2 | slot[2] << 4;
  const CUresult r = enc(map, WG_TMA_TYPE, 4,
                         const_cast<void*>(p), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

using Kernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, T16*, int,
                        int, int, int, int64_t, int64_t, int64_t, int, int,
                        float, float, int, int, int, int);

const void* kernel_of(int d) {
  return d == 64    ? (const void*)flash_wgmma_kernel<64>
         : d == 128 ? (const void*)flash_wgmma_kernel<128>
                    : (const void*)flash_wgmma_kernel<256>;
}

int d_slot(int d) { return d == 64 ? 0 : d == 128 ? 1 : 2; }

// the ring of K/V stages that fits a block beside the Q tile
void plan(int d, int* n_stages, size_t* smem) {
  const size_t tile = (size_t)(d / kBox) * kBoxBytes;
  const size_t fixed = 1024 + sizeof(Barriers) + tile;
  const int s = (int)((kSmemCap - fixed) / (2 * tile));
  *n_stages = s > kMaxStages ? kMaxStages : s;
  *smem = fixed + 2 * tile * (size_t)*n_stages;
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

bool aligned(const void* p, int n0, int64_t s0, int n1, int64_t s1, int n2,
             int64_t s2) {
  return (uintptr_t)p % 16 == 0 && (n0 == 1 || s0 % 8 == 0) &&
         (n1 == 1 || s1 % 8 == 0) && (n2 == 1 || s2 % 8 == 0);
}

}  // namespace

extern "C" {

// q (b, h, sq, d), k and v (b, kv, sk, d), out (b, h, sq, d), all T16,
// d in {64, 128, 256} contiguous, the other three dims strided (elements):
// q, k and v 16-byte aligned with strides of multiples of 8 (dims of size
// 1 aside), out 4-byte aligned with even strides.
int WG_ENTRY(const void* q, const void* k, const void* v,
                               void* out, int b, int h, int kv, int sq,
                               int sk, int d, int64_t qsb, int64_t qsh,
                               int64_t qss, int64_t ksb, int64_t ksh,
                               int64_t kss, int64_t vsb, int64_t vsh,
                               int64_t vss, int64_t osb, int64_t osh,
                               int64_t oss, int causal, int window,
                               float scale, float cap, void* stream) {
  if (!dims_ok(d) || kv <= 0 || h % kv != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned(q, b, qsb, h, qsh, sq, qss) ||
      !aligned(k, b, ksb, kv, ksh, sk, kss) ||
      !aligned(v, b, vsb, kv, vsh, sk, vss) || (uintptr_t)out % 4 != 0 ||
      osb % 2 != 0 || osh % 2 != 0 || oss % 2 != 0)
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || sq <= 0) return (int)cudaGetLastError();
  if (sk <= 0) return (int)cudaErrorInvalidValue;
  const int n_qt = (sq + kBM - 1) / kBM;
  if (n_qt > 65535 || (int64_t)b * h > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  int n_stages;
  size_t smem;
  plan(d, &n_stages, &smem);
  cudaError_t err = configure(d, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  int pq, pk, pv;
  if ((err = make_map(&tq, q, b, qsb, h, qsh, sq, qss, d, &pq)) !=
          cudaSuccess ||
      (err = make_map(&tk, k, b, ksb, kv, ksh, sk, kss, d, &pk)) !=
          cudaSuccess ||
      (err = make_map(&tv, v, b, vsb, kv, vsh, sk, vss, d, &pv)) !=
          cudaSuccess)
    return (int)err;
  const dim3 grid((unsigned)(b * h), (unsigned)n_qt);
  const Kernel kern = (Kernel)kernel_of(d);
  kern<<<grid, 3 * 128, smem, (cudaStream_t)stream>>>(
      tq, tk, tv, (T16*)out, h, kv, sq, sk, osb, osh, oss, causal, window,
      scale, cap, n_stages, pq, pk, pv);
  return (int)cudaGetLastError();
}

// The kernel's resources at head dim d: info[0] registers per thread (at
// launch: setmaxnreg moves them between the roles), [1] static and [2]
// dynamic shared memory per block (bytes), [3] blocks resident per SM,
// [4] threads per block, [5] query rows per block, [6] K/V stages.
int WG_INFO(int d, int* info) {
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
                                                      3 * 128, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)smem;
  info[3] = per_sm;
  info[4] = 3 * 128;
  info[5] = kBM;
  info[6] = n_stages;
  return 0;
}

}  // extern "C"
