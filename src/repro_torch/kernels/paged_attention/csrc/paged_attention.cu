// paged_attention: one-token decode attention read through a block table,
// written for Hopper (sm_90a), with a plain C interface loaded by ctypes
// (kernels/_build.py, wrapper in kernels/paged_attention/kernel.py).
//
// Replaces the Pallas kernel repro/kernels/paged_attention/kernel.py::_call
// (body _kernel), reached there by paged_attention_fwd (split K/V pools) and
// paged_attention_pool_fwd (two planes of one engine extent pool). One
// kernel serves both: it takes K and V base pointers, each with a row stride
// (one extent row) and a token stride (one token within the row), in
// elements. Split pools (E, page, KV, hd) have token stride KV*hd; the plane
// view of the engine pool (E, page, n_planes, KV, hd) has token stride
// n_planes*KV*hd, and its K and V bases are the pool offset by the plane.
//
// Semantics (the Pallas kernel's): for sequence b the query attends to
// positions < lengths[b]; page ip covers positions [ip*page, (ip+1)*page).
// A page runs only if it starts below the length, its extent is not a hole
// (table < 0) and, with a window, its last position is inside the window;
// a hole contributes nothing even where the TPU kernel's index map clamped
// it to row 0. Logits are q.k * scale, then tanh-capped, then masked per
// position; the softmax is online in fp32; the output is acc / max(l,
// 1e-30), so a lane with no live page returns zeros.
//
// Dtypes (the Pallas kernel takes any, upcasts inside and writes q's
// dtype): q, the pools and the output fp32; q, the pools and the output
// bf16 or fp16 (a 16-bit plan's split pools); or q and the output bf16 or
// fp16 over fp32 pools (a 16-bit plan's q against the fp32 engine pool of
// zero-copy serving). Loads convert to fp32; the logits, the softmax, the
// accumulators and the partials stay fp32; the output is rounded to q's
// dtype once, at the end (so in fp16 only the output can overflow, as the
// reference's can).
//
// Bound on an H100 SXM: bytes. Each live position's K and V rows of one KV
// head are read once (2 * hd * 4 bytes; 2 * hd * 2 from bf16 pools), q
// and the output once; the
// arithmetic is 4 * g * hd flops per position, far below the fp32 rate, and
// g = 2 query rows (gemma2-2b) is far below a tensor-core tile, so it stays
// on the CUDA cores in fp32. At the serving path's widths (8 sequences,
// 4 KV heads, hd 256, page 32, p_max 64, about 17 live pages a sequence)
// a call reads about 36 MB: 0.0107 ms at 3.35 TB/s.
//
// Design (flash-decoding; the lanes instantiation, then the packed one).
// - Grid (b * kv * row groups, n_split). The query rows of a KV head's GQA
//   group are cut into row groups of at most kMaxG rows (one at g <= 4);
//   the kernel is instantiated for G = 1, 2 or 4 rows a block (a smaller
//   group's extra rows are zero and never written), so the logits'
//   reductions and the softmax run without per-row branches and the
//   compiler interleaves their shuffle chains (a runtime row count puts a
//   branch around each shuffle and serialises them).
// - Split s of a (sequence, KV head) takes the s-th of n_split equal
//   shares of the pages that can run: from the first page reaching into
//   the window (0 without one) to the last page below the length. The
//   shares are cut here from lengths[b], on the card, so every block of a
//   live sequence has work; the wrapper picks n_split from shapes alone
//   (p_max, rows, the SM count, the group size: kernel.py paged_splits,
//   kBlocksPerSm blocks on every SM: 12 at the serving width), reads
//   nothing back, and the call stays capturable in a CUDA graph. A share
//   with no live page (past the length, or all holes) writes an empty
//   partial (m = -1e30, l = 0) and exits.
// - Staging. Warp 0 compacts the share's live pages (ballots) into shared
//   memory: one barrier. Then each warp runs on its own, with no barrier
//   until the end: the share's pages are cut into tiles of kTile
//   positions, warp w owns positions w, w + 4, ... of every tile, and lane
//   l owns the 16-byte slots l, l + 32 of hd: 4 floats each, or 8 bf16
//   values of a bf16 pool, so a lane's slot is columns 8l to 8l + 7 and
//   one slot a lane covers hd 256 (single values l + 32i where the base,
//   the strides or hd are not multiples of 16 bytes: chosen per tensor
//   here, for bf16 q by both pools together). A lane copies its own slots
//   of its warp's K and V rows with cp.async (16 bytes a copy on the fast
//   path; a single bf16 by a plain load and store) into its own part of
//   shared memory, two tiles deep, and reads back only what it copied, so
//   cp.async.wait_group alone orders it: no barrier and no __syncwarp per
//   page. Positions past the length or outside the window are not loaded.
// - Each warp keeps its own online softmax over its positions (m, l and
//   the lane's slots of the accumulator, per query row, in registers): per
//   tile one warp reduction per (row, position) for the logits, one
//   rescale. The cap's tanh is 1 - 2 / (exp(2x) + 1) on the fast exp and
//   divide (within about 1e-7 of tanhf), the exps are __expf.
// - End of block: the four warps' (m, l, acc) merge through shared memory
//   (two barriers); with n_split 1 the block writes the output itself,
//   else its partial (unnormalised acc, m, l per row) into the scratch
//   (b, kv, n_split, g, dv + 2) fp32 that the wrapper allocates.
// - Merge: a second small kernel over (b, kv) (not the last block by an
//   atomic ticket: a ticket needs a counter that outlives the call and
//   would be shared by two calls in flight on two streams), with the math
//   of models/attention.py merge_partials and finish_partial: a warp per
//   row finds m* = max m_s and each split's coefficient exp(m_s - m*)
//   once, into shared memory; then o = sum coef_s o_s / max(sum coef_s
//   l_s, 1e-30) per element. An empty partial (l = 0) has coefficient 0
//   and its acc is never read. It is launched with programmatic stream
//   serialization: its blocks may be scheduled while the main grid runs
//   and wait (griddepcontrol.wait) until it has finished.
// - Shared memory: 2 stages x kTile positions x (hd + hd_v) values (64 KiB
//   at hd 256 in fp32, 32 KiB in bf16), kBlocksPerSm = 3 blocks an SM.
// - Two instantiations of each (dtypes, copy width, rows) kernel, by a
//   lane's values of a row in registers (LF): 8 up to hd 256, today's code
//   and tiles; 20 up to 576 (five float4 slots, the fifth half used; five
//   8-byte slots of 4 bf16, which keep the fp32 form's registers where
//   16-byte ones would take 24; or 18 single ones), for MLA's absorbed
//   latent (deepseek-v3: K 576 = latent 512 + rope 64, V 512 on the
//   split pools and 576 on the engine pool's planes, G = 128 query heads
//   on one KV head). The wide one stages 160 KiB (one block an SM) and
//   keeps 2 x 4 rows x 20 floats of q and accumulator a lane; it now runs
//   where a KV head's group is small (fewer than kPackedMinG rows).
// - The packed instantiation (paged_packed_kernel, below): a wide head dim
//   (past 256) and a GQA group of at least kPackedMinG = 16 rows, MLA's
//   decode (G = 128 on one 576-wide latent), where the lanes kernel's 32
//   row groups of 4 each re-read a sequence's latent pages (32x the bytes
//   of the bound: 0.2955 ms against 0.00945 at deepseek-v3's serving
//   inputs on an H100). Bound there: the live K and V rows
//   once (bytes), level with the products at the tensor cores' 3xTF32
//   rate over the fp32 pool (2 x 128 x 1152 flops a position). Design:
//   - A block takes kPackedRows = 32 of the group's query rows and 16
//     positions a tile, so each latent page is read by g / 32 blocks (4 at
//     G = 128), and both products run on the tensor cores: S = Q.K^T by
//     all 8 warps, each over an eighth of d (its partial through shared
//     memory), the softmax by 8 threads a row, then O += P.V, each warp
//     its 8-wide column chunks of the output for all 32 rows. Over fp32
//     pools: mma.sync m16n8k8 in 3xTF32 (as flash's fp32 form; fragments
//     of fp32 rows by ldmatrix); with bf16 q over the fp32 pool q is exact
//     in TF32, so q.K^T is two products (K's hi and lo) and P.V three;
//     over bf16 pools: m16n8k16 with P split into bf16 hi and lo.
//   - Staging: Q once a segment, K double-buffered, V single-buffered (read
//     last, released first: its next tile loads during the next S), by
//     cp.async, a warp a row; rows past the length, outside the window or
//     past the page are zeros. A segment's live pages are compacted
//     kPackedList = 256 at a time, so shared memory (204 KiB at fp32 576,
//     168 KiB for bf16 q over the fp32 pool) does not grow with the block
//     table: a table of any width launches.
//   - The cut, on the card from lengths: the live page ranges of all b
//     sequences laid end to end, and block s of nb = b * n_split takes
//     pages [s W / nb, (s + 1) W / nb) -- a segment of each sequence it
//     reaches -- so every block does the same work whatever the lengths
//     (a per-sequence cut left the longest sequence's blocks the whole
//     critical path). Each segment writes a partial (slot s + i of the KV
//     head's nb + b); merge_rows_kernel (programmatic dependent launch)
//     merges each sequence's slots over (b, kh) x 4-row groups, with the
//     first slots' values loaded before the coefficients, and writes each
//     row's log-sum-exp for the stripe entry.
//   - 64 rows a block over bf16 pools was measured slower: with half the
//     row tiles the cut needs twice the blocks a row tile to fill the
//     card, and so twice the partials' bytes and merge.
//   - What holds it back (the dev phase variants, one call at deepseek-
//     v3's shapes, fp32): the products (3xTF32 on mma.sync, about two
//     thirds of the card's TF32 rate in the S and P.V phases) take most of
//     a tile; the merge and the partials about a sixth of the call; K/V
//     loads mostly hidden.
// - What holds the lanes kernel back (kernel phase_costs.py, variants that drop one part,
//   at the serving inputs): not the bytes. Dropping every K/V load saves
//   about a third of the call, the tile math about a quarter, the merge
//   about a sixth; what stays is the fixed cost of a call (two launches,
//   the length and table round trips before the first copy, the block's
//   merge and the partials' round trip), so the call is latency-bound at
//   about a third of the HBM rate. Overlapping the merge with the next
//   layer's work, or fewer and longer shares per SM with a deeper ring,
//   come next.
//
// Three libraries from this file, compiled in parallel: the fp32 form's
// kernels and entries (paged_attention, paged_attention_info) as it is; with
// PAGED_ATTENTION_BF16 defined (paged_attention_bf16.cu includes this file)
// the bf16 forms' (paged_attention_bf16, paged_attention_bf16_info); with
// PAGED_ATTENTION_F16 (paged_attention_f16.cu) the fp16 forms'
// (paged_attention_f16, paged_attention_f16_info). Each 16-bit library
// instantiates the same templates over its T16 (elt16.cuh: conversions by
// the intrinsics, the hi/lo split of P, m16n8k16 over T16). One file of 48
// instantiations took 78 s of nvcc, each half about 40.
//
// Offsets are 64-bit: an engine pool holds up to ~2^30 floats.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/elt16.cuh"

namespace {

using bf16 = __nv_bfloat16;
// the 16-bit library's element type (elt16.cuh): q's and the output's, and
// the split pools' of its k16 form
#if defined(PAGED_ATTENTION_F16)
#define PAGED_ATTENTION_16
#define PAGED16_ENTRY paged_attention_f16
#define PAGED16_INFO paged_attention_f16_info
using T16 = __half;
#elif defined(PAGED_ATTENTION_BF16)
#define PAGED_ATTENTION_16
#define PAGED16_ENTRY paged_attention_bf16
#define PAGED16_INFO paged_attention_bf16_info
using T16 = bf16;
#endif

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;                 // positions staged per step
constexpr int kPer = kTile / kWarps;      // positions of a warp per tile
constexpr int kMaxG = 4;                  // query rows per block
constexpr int kMaxD = 256;                // hd and hd_v: 8 floats a lane
constexpr int kMaxDWide = 576;            // the wide instantiation's
constexpr int kStages = 2;
constexpr int kBlocksPerSm = 3;           // the wrapper's paged_splits too
constexpr int kBlocksPerSmWide = 1;       // 160 KiB of stages at 576
constexpr int kMergeThreads = 256;
constexpr int kMergeSmem = 48 * 1024;     // the merge's coefficients
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp8(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ float to_f(T x) { return Elt16<T>::to_f(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x) { return Elt16<T>::from_f(x); }
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// one copy of W values of type T into shared memory: cp.async for 16, 8
// and 4 bytes; one 16-bit value (below cp.async's smallest copy) by a
// plain load and store, which the lane itself reads back later, so it
// needs no wait
template <typename T, int W>
__device__ __forceinline__ void cp_slot(T* dst, const T* src) {
  constexpr int kBytes = (int)sizeof(T) * W;
  if constexpr (kBytes == 16) cp16((float*)dst, (const float*)src);
  else if constexpr (kBytes == 8) cp8(dst, src);
  else if constexpr (kBytes == 4) cp4((float*)dst, (const float*)src);
  else *dst = *src;
}

// a pair of 16-bit T to floats: the low half first, exact
template <typename T>
__device__ __forceinline__ void unpack_pair(float* x, uint32_t u) {
  const float2 f = unpack2<T>(u);
  x[0] = f.x;
  x[1] = f.y;
}

// W values of type T from shared memory (one copy's slot) as floats
template <typename T, int W>
__device__ __forceinline__ void load_slot(float* x, const T* p) {
  if constexpr (sizeof(T) == 4 && W == 4) {
    const float4 y = *(const float4*)p;
    x[0] = y.x;
    x[1] = y.y;
    x[2] = y.z;
    x[3] = y.w;
  } else if constexpr (sizeof(T) == 2 && W == 8) {
    const uint4 y = *(const uint4*)p;
    unpack_pair<T>(x, y.x);
    unpack_pair<T>(x + 2, y.y);
    unpack_pair<T>(x + 4, y.z);
    unpack_pair<T>(x + 6, y.w);
  } else if constexpr (sizeof(T) == 2 && W == 4) {
    const uint2 y = *(const uint2*)p;
    unpack_pair<T>(x, y.x);
    unpack_pair<T>(x + 2, y.y);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) x[e] = to_f(p[e]);
  }
}

// tanh(x) = 1 - 2 / (exp(2x) + 1), within about 1e-7 of tanhf (ex2.approx
// and a fast divide), and exact at both ends
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// floats of one row a lane holds: slots of W floats, slot s at column
// (s * 32 + lane) * W
__host__ __device__ constexpr int lane_floats(int n, int w) {
  return ((n + 32 * w - 1) / (32 * w)) * w;
}

// a lane's floats of a row in registers: 8 up to hd 256 (today's code),
// 20 up to 576 (MLA's latent: five float4 slots, or 18 4-byte ones)
constexpr int kLaneNarrow = kMaxD / 32;
constexpr int kLaneWide = lane_floats(kMaxDWide, 4);

// TQ: q's and the output's type, TKV: the pools' (float, float; T16, T16;
// or T16 over float pools, T16 bf16 or fp16); WK, WV: values a K / V copy
// (16 bytes: 4 floats or 8 16-bit values; 8 bytes: 4 16-bit values in the
// wide instantiation; or 1);
// G: query rows a block (1, 2 or 4;
// rows of a smaller group are zero and never written), so the logits'
// reductions and the softmax have no per-row branches and interleave;
// LF: a lane's values of a row (kLaneNarrow or kLaneWide)
template <typename TQ, typename TKV, int WK, int WV, int G, int LF>
__global__ void __launch_bounds__(
    kThreads, LF == kLaneNarrow ? kBlocksPerSm : kBlocksPerSmWide)
paged_kernel(const void* __restrict__ q_, const void* __restrict__ k_,
             const void* __restrict__ v_, const int* __restrict__ table,
             const int* __restrict__ lengths, void* __restrict__ out_,
             float* __restrict__ part, int h, int kv, int d, int dv,
             int p_max, int page, int n_rows, int64_t k_row, int64_t k_tok,
             int64_t v_row, int64_t v_tok, int window, float scale,
             float cap, int n_rg, int n_split) {
  extern __shared__ __align__(16) float smem[];
  // let the merge kernel's blocks be scheduled; they wait for this grid
  asm volatile("griddepcontrol.launch_dependents;");
  const TQ* __restrict__ q = (const TQ*)q_;
  const TKV* __restrict__ k = (const TKV*)k_;
  const TKV* __restrict__ v = (const TKV*)v_;
  TQ* __restrict__ out = (TQ*)out_;
  constexpr int NK = LF / WK, NV = LF / WV;           // slots a lane
  const int fk = lane_floats(d, WK), fv = lane_floats(dv, WV);
  const int per_pos = (fk + fv) * 32;                 // values a position
  TKV* stages = (TKV*)smem;
  int* list = (int*)(stages + kStages * kWarps * kPer * per_pos);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rgi = blockIdx.x % n_rg;
  const int bkh = blockIdx.x / n_rg;
  const int kh = bkh % kv;
  const int bi = bkh / kv;
  const int split = blockIdx.y;
  const int g = h / kv;
  const int gb = (g + n_rg - 1) / n_rg;
  const int r0 = rgi * gb;
  const int nr = min(gb, g - r0);
  const int pps = (p_max + n_split - 1) / n_split;    // most pages a share
  int* list_ip = list;
  int* list_ext = list + pps;

  // the share: the s-th of n_split equal parts of the pages that can run
  const int length = lengths[bi];
  const int last = length > 0 ? min(p_max, (length + page - 1) / page) : 0;
  int first = 0;
  if (window > 0) {
    const int x = length - window - page;   // last position <= x: outside
    first = x < 0 ? 0 : x / page + 1;
  }
  const int n = max(0, last - first);
  const int lo = first + (int)((int64_t)split * n / n_split);
  const int hi = first + (int)((int64_t)(split + 1) * n / n_split);

  // the query rows' slots (K's lane map), loaded while the table arrives
  float qr[G][LF];
  const TQ* qb = q + ((int64_t)bi * h + (int64_t)kh * g + r0) * d;
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int s = 0; s < NK; ++s) {
      const int col = (s * 32 + lane) * WK;
      if (r < nr && col < d) {
        if constexpr (sizeof(TQ) == 4 && WK == 4) {
          const float4 x = *(const float4*)(qb + (int64_t)r * d + col);
          qr[r][s * 4] = x.x;
          qr[r][s * 4 + 1] = x.y;
          qr[r][s * 4 + 2] = x.z;
          qr[r][s * 4 + 3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < WK; ++e)
            qr[r][s * WK + e] = to_f(qb[(int64_t)r * d + col + e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < WK; ++e) qr[r][s * WK + e] = 0.f;
      }
    }

  // warp 0 compacts the share's live pages, in order
  if (warp == 0) {
    const int* trow = table + (int64_t)bi * p_max;
    int count = 0;
    for (int p0 = lo; p0 < hi; p0 += 32) {
      const int ip = p0 + lane;
      int ext = -1;
      bool run = false;
      if (ip < hi) {
        ext = trow[ip];
        run = ext >= 0 && ext < n_rows;   // [lo, hi) is in range already
      }
      const unsigned bal = __ballot_sync(0xffffffffu, run);
      if (run) {
        const int at = count + __popc(bal & ((1u << lane) - 1u));
        list_ip[at] = ip;
        list_ext[at] = ext;
      }
      count += __popc(bal);
    }
    if (lane == 0) list[2 * pps] = count;
  }
  __syncthreads();
  const int n_live = list[2 * pps];
  float* pb = part + (((int64_t)bi * kv + kh) * n_split + split) * g *
                         (int64_t)(dv + 2);
  if (n_live == 0 && n_split > 1) {       // an empty partial
    if (tid < nr) {
      pb[(int64_t)(r0 + tid) * (dv + 2) + dv] = kNegInf;
      pb[(int64_t)(r0 + tid) * (dv + 2) + dv + 1] = 0.f;
    }
    return;
  }

  const int tpp = (page + kTile - 1) / kTile;
  const int n_tiles = n_live * tpp;
  const int lim = length - 1 - window;    // window: positions > lim run
  TKV* lane_base = stages + warp * kPer * per_pos;   // stage 0, position 0

  // copy this lane's slots of this warp's positions of tile j
  auto issue = [&](int j) {
    const int li = j / tpp;
    const int tb = (j - li * tpp) * kTile;
    const int te = min(page, tb + kTile);
    const int ip = list_ip[li];
    const int64_t ext = list_ext[li];
    TKV* st = lane_base + (j & 1) * kWarps * kPer * per_pos;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = tb + warp + kWarps * i;
      const int pos = ip * page + t;
      if (t < te && pos < length && (window <= 0 || pos > lim)) {
        const TKV* kp = k + ext * k_row + t * k_tok + (int64_t)kh * d;
        const TKV* vp = v + ext * v_row + t * v_tok + (int64_t)kh * dv;
        TKV* ks = st + i * per_pos;
        TKV* vs = ks + fk * 32;
#pragma unroll
        for (int s = 0; s < NK; ++s) {
          const int col = (s * 32 + lane) * WK;
          if (col < d) cp_slot<TKV, WK>(ks + col, kp + col);
        }
#pragma unroll
        for (int s = 0; s < NV; ++s) {
          const int col = (s * 32 + lane) * WV;
          if (col < dv) cp_slot<TKV, WV>(vs + col, vp + col);
        }
      }
    }
    cp_commit();
  };

  float m[G], l[G], acc[G][LF];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < LF; ++e) acc[r][e] = 0.f;
  }

  if (n_tiles > 0) issue(0);
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      issue(j + 1);
      cp_wait<1>();                       // this lane's copies of tile j
    } else {
      cp_wait<0>();
    }
    const int li = j / tpp;
    const int tb = (j - li * tpp) * kTile;
    const int te = min(page, tb + kTile);
    const int base = list_ip[li] * page;
    const TKV* st = lane_base + (j & 1) * kWarps * kPer * per_pos;
    bool ok[kPer];
    float x[kPer][G];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = tb + warp + kWarps * i;
      const int pos = base + t;
      ok[i] = t < te && pos < length && (window <= 0 || pos > lim);
      const TKV* ks = st + i * per_pos;
      float kk[LF];
#pragma unroll
      for (int s = 0; s < NK; ++s) {
        const int col = (s * 32 + lane) * WK;
        if (ok[i] && col < d) {
          load_slot<TKV, WK>(kk + s * WK, ks + col);
        } else {
#pragma unroll
          for (int e = 0; e < WK; ++e) kk[s * WK + e] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < LF; ++e) dot += qr[r][e] * kk[e];
        x[i][r] = dot;
      }
    }
    // the warp sums of every (position, row), interleaved
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int r = 0; r < G; ++r)
          x[i][r] += __shfl_xor_sync(0xffffffffu, x[i][r], o);
    float p[kPer][G];
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float mt = kNegInf;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        float sc = x[i][r] * scale;
        if (cap > 0.f) sc = tanh_fast(sc / cap) * cap;
        x[i][r] = sc;
        if (ok[i]) mt = fmaxf(mt, sc);
      }
      const float m_new = fmaxf(m[r], mt);
      const float corr = __expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        p[i][r] = ok[i] ? __expf(x[i][r] - m_new) : 0.f;
        sum += p[i][r];
      }
      m[r] = m_new;
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int e = 0; e < LF; ++e) acc[r][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (!ok[i]) continue;               // the same in every lane
      const TKV* vs = st + i * per_pos + fk * 32;
      float vv[LF];
#pragma unroll
      for (int s = 0; s < NV; ++s) {
        const int col = (s * 32 + lane) * WV;
        if (col < dv) {
          load_slot<TKV, WV>(vv + s * WV, vs + col);
        } else {
#pragma unroll
          for (int e = 0; e < WV; ++e) vv[s * WV + e] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < G; ++r)
#pragma unroll
        for (int e = 0; e < LF; ++e) acc[r][e] += p[i][r] * vv[e];
    }
  }

  // merge the four warps' softmax states through shared memory
  __syncthreads();                        // every warp is done with stages
  const int rs = dv + 2;
  float* mw = smem;                       // (kWarps, kMaxG, dv + 2)
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r >= nr) continue;
    float* row = mw + (warp * kMaxG + r) * rs;
#pragma unroll
    for (int s = 0; s < NV; ++s) {
      const int col = (s * 32 + lane) * WV;
#pragma unroll
      for (int e = 0; e < WV; ++e)
        if (col + e < dv) row[col + e] = acc[r][s * WV + e];
    }
    if (lane == 0) {
      row[dv] = m[r];
      row[dv + 1] = l[r];
    }
  }
  __syncthreads();
  TQ* ob = out + ((int64_t)bi * h + (int64_t)kh * g + r0) * dv;
  for (int e = tid; e < nr * dv; e += kThreads) {
    const int r = e / dv;
    const int c = e - r * dv;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, mw[(w * kMaxG + r) * rs + dv]);
    float o = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* row = mw + (w * kMaxG + r) * rs;
      const float f = __expf(row[dv] - mx);
      o += f * row[c];
      lsum += f * row[dv + 1];
    }
    if (n_split == 1) {
      ob[(int64_t)r * dv + c] = from_f<TQ>(o / fmaxf(lsum, 1e-30f));
    } else {
      float* pr = pb + (int64_t)(r0 + r) * rs;
      pr[c] = o;
      if (c == 0) {
        pr[dv] = mx;
        pr[dv + 1] = lsum;
      }
    }
  }
}

// out[b, kh*g + r] from the n_split partials of (b, kh): merge_partials.
// A warp per query row finds the row's largest live m and each split's
// coefficient exp(m_s - m*) (0 for an empty split, whose acc is never
// read) and 1 / sum_s coef l_s, into shared memory; then each thread
// sums its elements over the splits, written in the output's type TO.
template <typename TO>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ part, TO* __restrict__ out, int h,
             int kv, int dv, int n_split) {
  extern __shared__ float coef[];         // (g, n_split), then (g) 1 / l
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int bkh = blockIdx.x;
  const int g = h / kv;
  const int rs = dv + 2;
  const int lane = threadIdx.x & 31;
  const float* pb = part + (int64_t)bkh * n_split * g * rs;
  float* inv = coef + g * n_split;
  for (int r = threadIdx.x >> 5; r < g; r += kMergeThreads / 32) {
    float mx = kNegInf;
    for (int s = lane; s < n_split; s += 32) {
      const float* pr = pb + ((int64_t)s * g + r) * rs;
      if (pr[dv + 1] > 0.f) mx = fmaxf(mx, pr[dv]);
    }
    mx = warp_max(mx);
    float lsum = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float* pr = pb + ((int64_t)s * g + r) * rs;
      const float ls = pr[dv + 1];
      const float c = ls > 0.f ? __expf(pr[dv] - mx) : 0.f;
      coef[r * n_split + s] = c;
      lsum += c * ls;
    }
    lsum = warp_sum(lsum);
    if (lane == 0) inv[r] = 1.f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  TO* ob = out + (int64_t)bkh * g * dv;      // (b, kh) rows are contiguous
  for (int e = threadIdx.x; e < g * dv; e += kMergeThreads) {
    const int r = e / dv;
    const int c = e - r * dv;
    const float* cr = coef + r * n_split;
    float o = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float f = cr[s];
      if (f != 0.f) o += f * pb[((int64_t)s * g + r) * rs + c];
    }
    ob[e] = from_f<TO>(o * inv[r]);
  }
}

// ---------------------------------------------------------------------------
// The packed instantiation: a KV head's query rows on the tensor cores.
// ---------------------------------------------------------------------------
constexpr int kPackedT = 16;              // positions a staged tile
constexpr int kPackedWarps = 8;
constexpr int kPackedThreads = kPackedWarps * 32;
constexpr int kPackedMinG = 16;           // the wrapper's PACKED_MIN_G
constexpr int kPackedRows = 32;           // query rows a block (PACKED_ROWS)
constexpr int kMaxChunksV = (kMaxDWide / 8 + kPackedWarps - 1) / kPackedWarps;
constexpr int kPackedList = 256;          // pages a segment compacts at once

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away); lo = x -
// hi is exact in fp32 and the tensor core reads its TF32 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two 8x8 tiles of 16-bit values, transposed: lanes 0-15 give the row
// addresses (tile 0's rows, then tile 1's); register j gets tile j's
// elements (2t, g) and (2t + 1, g), the B fragment of keys 2t, 2t + 1
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// four 8x8 matrices of 16-bit values: lane i gives the address of row
// i % 8 of matrix i / 8; register j gets matrix j's (g, 2t), (g, 2t + 1)
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp16z(void* dst, const void* src, bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp4z(void* dst, const void* src, bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

// n_rows rows of n values of T (row r from src + r * rs, or zeros where
// !in(r)) into shared rows of stride ss: a warp a row, its lanes along
// the row, 16-byte copies where vec, else single values (16 bits by a plain
// load and store, below cp.async's smallest copy)
template <typename T, typename In>
__device__ __forceinline__ void stage_rows(T* dst, int ss, const T* src,
                                           int64_t rs, int n_rows, int n,
                                           bool vec, In in) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < n_rows; r += kPackedWarps) {
    const bool ok = in(r);
    const T* s = ok ? src + r * rs : src;
    T* d = dst + r * ss;
    if (vec) {
      constexpr int kPer = 16 / (int)sizeof(T);
      for (int c = lane * kPer; c < n; c += 32 * kPer)
        cp16z(d + c, ok ? s + c : s, ok);
    } else {
      for (int c = lane; c < n; c += 32) {
        if constexpr (sizeof(T) == 4)
          cp4z(d + c, ok ? s + c : s, ok);
        else
          d[c] = ok ? s[c] : from_f<T>(0.f);
      }
    }
  }
}

// shared row strides (values) that keep the fragment loads free of bank
// conflicts: fp32 rows at 4 mod 8 words (Q and K: lanes (g, t) read row
// g, column t), fp32 V rows at 8 mod 32 (lanes read row t, column g),
// 16-bit rows at 8 values past a multiple of 16 (32-bit pairs and
// ldmatrix rows)
__host__ __device__ constexpr int packed_stride(int n, int item, bool v) {
  return item == 4 ? ((n + 7) & ~7) + (v ? 8 : 4) : ((n + 15) & ~15) + 8;
}

// the pages [first, first + n) of a sequence of length positions that can
// run (the lanes kernel's range: below the length and, with a window,
// reaching into it); returns n, writes first
__device__ __forceinline__ int packed_live(int length, int p_max, int page,
                                           int window, int* first) {
  const int last = length > 0 ? min(p_max, (length + page - 1) / page) : 0;
  int f = 0;
  if (window > 0) {
    const int x = length - window - page;
    f = x < 0 ? 0 : x / page + 1;
  }
  if (first != nullptr) *first = f;
  return max(0, last - f);
}

// TQ: q's and the output's type; TKV: the pools'. 16-bit pools (bf16 or
// fp16, q of the same type): the 16-bit family (m16n8k16 over TKV, P split
// into hi and lo of TKV); fp32 pools: the TF32 family (m16n8k8; q.K^T in
// 3xTF32, or two products where q is 16-bit and so exact in TF32; P.V in
// 3xTF32). kR: query rows a block.
template <typename TQ, typename TKV, int kR>
__global__ void __launch_bounds__(kPackedThreads, 1)
paged_packed_kernel(const void* __restrict__ q_, const void* __restrict__ k_,
                    const void* __restrict__ v_,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, void* __restrict__ out_,
                    float* __restrict__ part, int h, int kv, int d, int dv,
                    int p_max, int page, int n_rows, int64_t k_row,
                    int64_t k_tok, int64_t v_row, int64_t v_tok, int window,
                    float scale, float cap, int n_rt, int n_seq, int vec_q,
                    int vec_kv) {
  constexpr bool kBF = sizeof(TKV) == 2;
  constexpr int kRT = kR / 16;                        // 16-row tiles
  constexpr int kKT = kPackedT / 8;                   // 8-key tiles
  constexpr int kDS = kPackedWarps;                   // d split in S

  constexpr int kTPR = kPackedThreads / kR;           // softmax threads a row
  constexpr int kKPT = kPackedT / kTPR;               // their keys each
  constexpr int kSS = kPackedT + 4;                   // S / P row stride
  constexpr int kPS = kPackedT + 8;                   // 16-bit P row stride
  using TP = typename std::conditional<kBF, TKV, bf16>::type;   // P's
  extern __shared__ __align__(16) float smem[];
  asm volatile("griddepcontrol.launch_dependents;");
  const TQ* __restrict__ q = (const TQ*)q_;
  const TKV* __restrict__ k = (const TKV*)k_;
  const TKV* __restrict__ v = (const TKV*)v_;
  TQ* __restrict__ out = (TQ*)out_;
  const int qs = packed_stride(d, sizeof(TQ), false);
  const int ks = packed_stride(d, sizeof(TKV), false);
  const int vs = packed_stride(dv, sizeof(TKV), true);
  TQ* q_sm = (TQ*)smem;
  TKV* k_sm = (TKV*)(q_sm + kR * qs);    // 2 stages of K tiles
  TKV* v_sm = k_sm + 2 * kPackedT * ks;  // 1 of V
  float* s_sm = (float*)(v_sm + kPackedT * vs);       // (kDS, kR, kSS)
  TP* p_hi = (TP*)(s_sm + kDS * kR * kSS);            // 16-bit: (kR, kPS) x 2
  TP* p_lo = p_hi + (kBF ? kR * kPS : 0);
  float* row_corr = (float*)(p_lo + (kBF ? kR * kPS : 0));
  float* row_m = row_corr + kR;
  float* row_l = row_m + kR;
  int* list = (int*)(row_l + kR);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rti = blockIdx.x % n_rt;
  const int kh = blockIdx.x / n_rt;
  const int g = h / kv;
  const int r0 = rti * kR;
  const int nr = min(kR, g - r0);
  const int nb = gridDim.y;               // blocks over every sequence
  int* list_ip = list;                    // a chunk's live pages, in order
  int* list_ext = list + kPackedList;

  // zeros in every padding column, once (the staging never writes them)
  for (int i = tid; i < kR * (qs - d); i += kPackedThreads) {
    const int r = i / (qs - d);
    q_sm[r * qs + d + (i - r * (qs - d))] = from_f<TQ>(0.f);
  }
  for (int i = tid; i < 2 * kPackedT * (ks - d); i += kPackedThreads) {
    const int r = i / (ks - d);
    k_sm[r * ks + d + (i - r * (ks - d))] = from_f<TKV>(0.f);
  }
  for (int i = tid; i < kPackedT * (vs - dv); i += kPackedThreads) {
    const int r = i / (vs - dv);
    v_sm[r * vs + dv + (i - r * (vs - dv))] = from_f<TKV>(0.f);
  }

  // one segment: the pages [lo, hi) of sequence bi, its partial in slot
  // id of the KV head's nb + n_seq
  auto segment = [&](int bi, int lo, int hi, int id) {
  const int length = lengths[bi];
  __syncthreads();                        // the last segment is done

  // the sequence's query rows
  const TQ* qb = q + ((int64_t)bi * h + (int64_t)kh * g + r0) * d;
  stage_rows<TQ>(q_sm, qs, qb, d, kR, d, vec_q, [&](int r) { return r < nr; });
  cp_commit();

  float* pb = part + ((int64_t)kh * (nb + n_seq) + id) * g * (int64_t)(dv + 2);
  const int tpp = (page + kPackedT - 1) / kPackedT;
  const int lim = length - 1 - window;    // window: positions > lim run

  // tile j's positions (page list_ip[j / tpp], from (j % tpp) * kPackedT):
  // K into stage j & 1, V into its one stage (each its own cp.async
  // group); positions past the page, the length or the window are zeros
  auto load_tile = [&](int jt, bool is_v) {
    const int pi = jt / tpp;
    const int t0 = (jt - pi * tpp) * kPackedT;
    const int base_pos = list_ip[pi] * page + t0;
    const int64_t ext = list_ext[pi];
    auto in = [&](int r) {
      const int pos = base_pos + r;
      return t0 + r < page && pos < length && (window <= 0 || pos > lim);
    };
    if (is_v)
      stage_rows<TKV>(v_sm, vs,
                      v + ext * v_row + (int64_t)t0 * v_tok +
                          (int64_t)kh * dv,
                      v_tok, kPackedT, dv, vec_kv, in);
    else
      stage_rows<TKV>(k_sm + (jt & 1) * kPackedT * ks, ks,
                      k + ext * k_row + (int64_t)t0 * k_tok +
                          (int64_t)kh * d,
                      k_tok, kPackedT, d, vec_kv, in);
    cp_commit();                          // its own group
  };

  // the S job of this warp: every row and key of the tile over the
  // ds-th eighth of d
  const int ds = warp;
  // the softmax: kTPR threads a row, kKPT keys each
  const int sm_r = tid / kTPR;
  const int sm_k = (tid % kTPR) * kKPT;
  float m_run = kNegInf, l_run = 0.f;
  // P.V: this warp's 8-column chunks warp + 8i of the output, all rows
  const int nkv = (dv + 7) >> 3;
  float acc[kRT][kMaxChunksV][4];
#pragma unroll
  for (int a = 0; a < kRT; ++a)
#pragma unroll
    for (int c = 0; c < kMaxChunksV; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][c][e] = 0.f;

  // the segment's pages kPackedList at a time (shared memory that does not
  // grow with the table): warp 0 compacts a chunk's live pages, in order,
  // then its tiles run; the rows' (m, l) and accumulators carry over
  int seen = 0;                           // live pages of the segment
  for (int c0 = lo; c0 < hi; c0 += kPackedList) {
  const int c1 = min(hi, c0 + kPackedList);
  __syncthreads();                        // the last chunk's tiles are done
  if (warp == 0) {
    const int* trow = table + (int64_t)bi * p_max;
    int count = 0;
    for (int p0 = c0; p0 < c1; p0 += 32) {
      const int ip = p0 + lane;
      int ext = -1;
      bool run = false;
      if (ip < c1) {
        ext = trow[ip];
        run = ext >= 0 && ext < n_rows;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, run);
      if (run) {
        const int at = count + __popc(bal & ((1u << lane) - 1u));
        list_ip[at] = ip;
        list_ext[at] = ext;
      }
      count += __popc(bal);
    }
    if (lane == 0) list[2 * kPackedList] = count;
  }
  __syncthreads();
  const int n_live = list[2 * kPackedList];
  seen += n_live;
  const int n_tiles = n_live * tpp;

  // cp.async groups in order: Q (the first chunk), K(0), V(0), then K(j + 1)
  // at the top of tile j and V(j + 1) at its end (V(j) is read last and
  // released first)
  if (n_tiles > 0) {
    load_tile(0, false);
    load_tile(0, true);
  }
  for (int j = 0; j < n_tiles; ++j) {
    cp_wait<1>();                         // all but V(j): K(j) is in
    __syncthreads();                      // ... everyone's; j - 1 is done
    if (j + 1 < n_tiles) load_tile(j + 1, false);
    const TKV* kt_sm = k_sm + (j & 1) * kPackedT * ks;
    const TKV* vt_sm = v_sm;

    // S partial over this warp's part of d: rows a * 16 + (gq, gq + 8),
    // keys n * 8 + (2tq, 2tq + 1), each of the products into accumulators
    // of its own (no product waits on the one before it)
    {
      float sa[kRT][kKT][3][4] = {};
      if constexpr (kBF) {
        const int n16 = (d + 15) >> 4;
        const int per = (n16 + kDS - 1) / kDS;
        const int c0 = ds * per, c1 = min(n16, c0 + per);
        const TKV* qa = (const TKV*)q_sm + gq * qs + 2 * tq;
        const TKV* kb = kt_sm + gq * ks + 2 * tq;
        for (int c = c0; c < c1; ++c) {
          uint32_t a[kRT][4], bb[kKT][2];
#pragma unroll
          for (int m = 0; m < kRT; ++m) {
            const TKV* qr = qa + m * 16 * qs + 16 * c;
            a[m][0] = ld_u32(qr);
            a[m][1] = ld_u32(qr + 8 * qs);
            a[m][2] = ld_u32(qr + 8);
            a[m][3] = ld_u32(qr + 8 * qs + 8);
          }
#pragma unroll
          for (int n = 0; n < kKT; ++n) {
            const TKV* kr = kb + n * 8 * ks + 16 * c;
            bb[n][0] = ld_u32(kr);
            bb[n][1] = ld_u32(kr + 8);
          }
#pragma unroll
          for (int m = 0; m < kRT; ++m)
#pragma unroll
            for (int n = 0; n < kKT; ++n) mma16<TKV>(sa[m][n][0], a[m], bb[n]);
        }
      } else {
        const int n8 = (d + 7) >> 3;
        const int per = (n8 + kDS - 1) / kDS;
        const int c0 = ds * per, c1 = min(n8, c0 + per);
        // fragments of fp32 rows by ldmatrix (a 32-bit value as two b16
        // halves: lane (g, t) of an 8 x 8 b16 matrix gets row g's value
        // t): Q's 16 x 8 tile in one x4 (rows 0-7, 8-15 of columns 0-3,
        // then of 4-7: a0-a3), K's two 8-key tiles in another (b0, b1 of
        // each); 16-bit q by single loads
        const TQ* qa = q_sm + gq * qs + tq;
        const int lrow = lane & 7;
        const float* qm = (const float*)q_sm + (lrow + 8 * ((lane >> 3) & 1)) *
                          qs + 4 * (lane >> 4);
        const float* km = (const float*)kt_sm + (lrow + 8 * (lane >> 4)) * ks +
                          4 * ((lane >> 3) & 1);
        static_assert(kKT == 2, "K's two 8-key tiles in one ldmatrix.x4");
        for (int c = c0; c < c1; ++c) {
          uint32_t ah[kRT][4], al[kRT][4], bh[kKT][2], bl[kKT][2];
#pragma unroll
          for (int m = 0; m < kRT; ++m) {
            if constexpr (sizeof(TQ) == 4) {
              uint32_t r[4];
              ldsm_x4(r, qm + m * 16 * qs + 8 * c);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                split_tf32(__uint_as_float(r[e]), ah[m][e], al[m][e]);
            } else {                      // 16-bit q: exact in TF32
              const TQ* qr = qa + m * 16 * qs + 8 * c;
              const float x[4] = {to_f(qr[0]), to_f(qr[8 * qs]),
                                  to_f(qr[4]), to_f(qr[8 * qs + 4])};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                ah[m][e] = __float_as_uint(x[e]);
                al[m][e] = 0u;
              }
            }
          }
          {
            uint32_t r[4];
            ldsm_x4(r, km + 8 * c);
#pragma unroll
            for (int n = 0; n < kKT; ++n) {
              split_tf32(__uint_as_float(r[2 * n]), bh[n][0], bl[n][0]);
              split_tf32(__uint_as_float(r[2 * n + 1]), bh[n][1], bl[n][1]);
            }
          }
          if constexpr (sizeof(TQ) == 4) {
#pragma unroll
            for (int m = 0; m < kRT; ++m)
#pragma unroll
              for (int n = 0; n < kKT; ++n)
                mma_tf32(sa[m][n][2], al[m], bh[n]);
          }
#pragma unroll
          for (int m = 0; m < kRT; ++m)
#pragma unroll
            for (int n = 0; n < kKT; ++n) mma_tf32(sa[m][n][1], ah[m], bl[n]);
#pragma unroll
          for (int m = 0; m < kRT; ++m)
#pragma unroll
            for (int n = 0; n < kKT; ++n) mma_tf32(sa[m][n][0], ah[m], bh[n]);
        }
      }
#pragma unroll
      for (int m = 0; m < kRT; ++m)
#pragma unroll
        for (int n = 0; n < kKT; ++n) {
          float* sp = s_sm + (ds * kR + m * 16 + gq) * kSS + n * 8 + 2 * tq;
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[e] = sa[m][n][0][e] + (sa[m][n][1][e] + sa[m][n][2][e]);
          *reinterpret_cast<float2*>(sp) = make_float2(x[0], x[1]);
          *reinterpret_cast<float2*>(sp + 8 * kSS) = make_float2(x[2], x[3]);
        }
    }
    __syncthreads();

    // the softmax of row sm_r over keys sm_k .. + kKPT - 1 of the tile
    {
      const int pi = j / tpp;
      const int t0 = (j - pi * tpp) * kPackedT;
      const int base_pos = list_ip[pi] * page + t0;
      float x[kKPT];
      bool ok[kKPT];
      float mt = kNegInf;
#pragma unroll
      for (int e = 0; e < kKPT; ++e) {
        const int kk = sm_k + e;
        float y = 0.f;
#pragma unroll
        for (int a = 0; a < kDS; ++a) y += s_sm[(a * kR + sm_r) * kSS + kk];
        y *= scale;
        if (cap > 0.f) y = tanh_fast(y / cap) * cap;
        const int pos = base_pos + kk;
        ok[e] = t0 + kk < page && pos < length && (window <= 0 || pos > lim);
        x[e] = y;
        if (ok[e]) mt = fmaxf(mt, y);
      }
#pragma unroll
      for (int o = 1; o < kTPR; o <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m_run, mt);
      const float corr = __expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < kKPT; ++e) {
        x[e] = ok[e] ? __expf(x[e] - m_new) : 0.f;
        sum += x[e];
      }
#pragma unroll
      for (int o = 1; o < kTPR; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      m_run = m_new;
      l_run = l_run * corr + sum;
      if (sm_k == 0) row_corr[sm_r] = corr;
      if constexpr (kBF) {
#pragma unroll
        for (int e = 0; e < kKPT; e += 2) {
          uint32_t ph, pl;
          split2<TKV>(x[e], x[e + 1], ph, pl);
          *reinterpret_cast<uint32_t*>(p_hi + sm_r * kPS + sm_k + e) = ph;
          *reinterpret_cast<uint32_t*>(p_lo + sm_r * kPS + sm_k + e) = pl;
        }
      } else {                            // over the two S partials
        uint32_t* ph = (uint32_t*)s_sm + sm_r * kSS + sm_k;
        uint32_t* pl = ph + kR * kSS;
#pragma unroll
        for (int e = 0; e < kKPT; ++e) split_tf32(x[e], ph[e], pl[e]);
      }
    }
    if (j + 1 < n_tiles)
      cp_wait<1>();                       // all but K(j + 1): V(j) is in
    else
      cp_wait<0>();
    __syncthreads();

    // O = O * corr + P.V over this warp's column chunks
#pragma unroll
    for (int a = 0; a < kRT; ++a) {
      const float c_a = row_corr[a * 16 + gq];
      const float c_b = row_corr[a * 16 + gq + 8];
#pragma unroll
      for (int c = 0; c < kMaxChunksV; ++c) {
        acc[a][c][0] *= c_a;
        acc[a][c][1] *= c_a;
        acc[a][c][2] *= c_b;
        acc[a][c][3] *= c_b;
      }
    }
    if constexpr (kBF) {
      uint32_t ah[kRT][4], al[kRT][4];
#pragma unroll
      for (int a = 0; a < kRT; ++a) {
        const TP* ph = p_hi + (a * 16 + gq) * kPS + 2 * tq;
        const TP* pl = p_lo + (a * 16 + gq) * kPS + 2 * tq;
        ah[a][0] = ld_u32(ph);
        ah[a][1] = ld_u32(ph + 8 * kPS);
        ah[a][2] = ld_u32(ph + 8);
        ah[a][3] = ld_u32(ph + 8 * kPS + 8);
        al[a][0] = ld_u32(pl);
        al[a][1] = ld_u32(pl + 8 * kPS);
        al[a][2] = ld_u32(pl + 8);
        al[a][3] = ld_u32(pl + 8 * kPS + 8);
      }
      uint32_t bv[kMaxChunksV][2];
#pragma unroll
      for (int c = 0; c < kMaxChunksV; ++c) {
        const int ch = min(warp + kPackedWarps * c, nkv - 1);
        ldsm_x2_t(bv[c], vt_sm + (lane & 15) * vs + ch * 8);
      }
#pragma unroll
      for (int c = 0; c < kMaxChunksV; ++c)
        if (warp + kPackedWarps * c < nkv)
#pragma unroll
          for (int a = 0; a < kRT; ++a) mma16<TKV>(acc[a][c], al[a], bv[c]);
#pragma unroll
      for (int c = 0; c < kMaxChunksV; ++c)
        if (warp + kPackedWarps * c < nkv)
#pragma unroll
          for (int a = 0; a < kRT; ++a) mma16<TKV>(acc[a][c], ah[a], bv[c]);
    } else {
#pragma unroll
      for (int st = 0; st < kKT; ++st) {
        uint32_t ah[kRT][4], al[kRT][4];
#pragma unroll
        for (int a = 0; a < kRT; ++a) {
          const uint32_t* ph =
              (const uint32_t*)s_sm + (a * 16 + gq) * kSS + 8 * st + tq;
          const uint32_t* pl = ph + kR * kSS;
          ah[a][0] = ph[0];
          ah[a][1] = ph[8 * kSS];
          ah[a][2] = ph[4];
          ah[a][3] = ph[8 * kSS + 4];
          al[a][0] = pl[0];
          al[a][1] = pl[8 * kSS];
          al[a][2] = pl[4];
          al[a][3] = pl[8 * kSS + 4];
        }
        // every chunk's V fragments split first, then each product over
        // every chunk: an accumulator's products kMaxChunksV * kRT apart
        const float* vr = (const float*)vt_sm + (8 * st + tq) * vs + gq;
        uint32_t bh[kMaxChunksV][2], bl[kMaxChunksV][2];
#pragma unroll
        for (int c = 0; c < kMaxChunksV; ++c) {
          const int ch = min(warp + kPackedWarps * c, nkv - 1);
          split_tf32(vr[ch * 8], bh[c][0], bl[c][0]);
          split_tf32(vr[4 * vs + ch * 8], bh[c][1], bl[c][1]);
        }
#pragma unroll
        for (int c = 0; c < kMaxChunksV; ++c)
          if (warp + kPackedWarps * c < nkv)
#pragma unroll
            for (int a = 0; a < kRT; ++a) mma_tf32(acc[a][c], al[a], bh[c]);
#pragma unroll
        for (int c = 0; c < kMaxChunksV; ++c)
          if (warp + kPackedWarps * c < nkv)
#pragma unroll
            for (int a = 0; a < kRT; ++a) mma_tf32(acc[a][c], ah[a], bl[c]);
#pragma unroll
        for (int c = 0; c < kMaxChunksV; ++c)
          if (warp + kPackedWarps * c < nkv)
#pragma unroll
            for (int a = 0; a < kRT; ++a) mma_tf32(acc[a][c], ah[a], bh[c]);
      }
    }
    if (j + 1 < n_tiles) {
      __syncthreads();                    // everyone is done with V(j)
      load_tile(j + 1, true);
    }
  }
  }
  cp_wait<0>();                           // Q, where no tile waited for it
  if (seen == 0) {                        // an empty partial
    if (tid < nr) {
      pb[(int64_t)(r0 + tid) * (dv + 2) + dv] = kNegInf;
      pb[(int64_t)(r0 + tid) * (dv + 2) + dv + 1] = 0.f;
    }
    return;
  }

  // the rows' (m, l) and the unnormalised output: the segment's partial
  if (sm_k == 0) {
    row_m[sm_r] = m_run;
    row_l[sm_r] = l_run;
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < kRT; ++a)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = a * 16 + gq + 8 * hf;
      if (row >= nr) continue;
      float* pr = pb + (int64_t)(r0 + row) * (dv + 2);
#pragma unroll
      for (int c = 0; c < kMaxChunksV; ++c) {
        const int col = (warp + kPackedWarps * c) * 8 + 2 * tq;
        if (col + 1 < dv)                 // rows of dv + 2: pairs stay
          *reinterpret_cast<float2*>(pr + col) =   // 8-byte aligned
              make_float2(acc[a][c][2 * hf], acc[a][c][2 * hf + 1]);
        else if (col < dv)
          pr[col] = acc[a][c][2 * hf];
      }
    }
  if (tid < nr) {
    float* pr = pb + (int64_t)(r0 + tid) * (dv + 2);
    pr[dv] = row_m[tid];
    pr[dv + 1] = row_l[tid];
  }
  };

  // The cut (the merge's the same; tests/test_torch_attention_tiles.py
  // emulates it): the live page ranges of the n_seq sequences laid end to
  // end, W pages;
  // block s of the nb takes pages [s W / nb, (s + 1) W / nb), a segment of
  // each sequence it reaches, so that every block has the same share of
  // the work whatever the lengths. From lengths, on the card.
  int total = 0;
  for (int i = 0; i < n_seq; ++i)
    total += packed_live(lengths[i], p_max, page, window, nullptr);
  const int sb = blockIdx.y;
  const int g0 = (int)((int64_t)sb * total / nb);
  const int g1 = (int)((int64_t)(sb + 1) * total / nb);
  int at = 0;
  for (int i = 0; i < n_seq && at < g1; ++i) {
    int first_i;
    const int n_i = packed_live(lengths[i], p_max, page, window, &first_i);
    const int a = max(g0, at), e = min(g1, at + n_i);
    if (a < e) segment(i, first_i + a - at, first_i + e - at, sb + i);
    at += n_i;
  }
}

// The packed instantiation's merge: merge_kernel's math for the cut's
// segments, over a grid of (b, kh) x groups of kMergeRows rows (a GQA
// group of 128 rows gives 32 blocks a sequence and KV head). The
// sequence's pages [at, at + n) of the cut's total were reached by blocks
// s_first..s_last, each of which wrote slot s + bi: a warp a row puts each
// slot's coefficient exp(m_s - m*) (0 for a block that did not reach the
// sequence or saw no live position) into shared memory (2 nb floats a row
// at most) with 1 / l and the row's log-sum-exp (into lse); each thread
// sums its elements over the slots, kMergeUnroll slots' loads in flight,
// the first of them issued before the coefficients.
constexpr int kMergeRows = 4;
constexpr int kMergeUnroll = 4;

template <typename TO>
__global__ void __launch_bounds__(kMergeThreads)
merge_rows_kernel(const float* __restrict__ part, TO* __restrict__ out,
                  float* __restrict__ lse, const int* __restrict__ lengths,
                  int h, int kv, int dv, int p_max, int page, int window,
                  int n_seq, int nb) {
  extern __shared__ float coef[];         // (2, kMergeRows, nb), 1 / l
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int bi = blockIdx.x / kv, kh = blockIdx.x % kv;
  const int g = h / kv;
  const int rs = dv + 2;
  const int r0 = blockIdx.y * kMergeRows;
  const int nr = min(kMergeRows, g - r0);
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  float* slot_m = coef + kMergeRows * nb;
  float* inv = slot_m + kMergeRows * nb;
  int total = 0, at = 0, n = 0;
  for (int i = 0; i < n_seq; ++i) {
    const int ni = packed_live(lengths[i], p_max, page, window, nullptr);
    at += i < bi ? ni : 0;
    n = i == bi ? ni : n;
    total += ni;
  }
  int s_first = 0, n_slots = 0;
  if (n > 0) {
    s_first = (int)min((int64_t)nb - 1, ((int64_t)(at + 1) * nb - 1) / total);
    n_slots = (int)min((int64_t)nb - 1,
                       ((int64_t)(at + n) * nb - 1) / total) - s_first + 1;
  }
  const float* pb =
      part + ((int64_t)kh * (nb + n_seq) + s_first + bi) * g * rs;
  // each thread's elements of the block's rows, and the first
  // kMergeUnroll slots' values of them, loaded before the coefficients
  // (they do not depend on them)
  constexpr int kPer =
      (kMergeRows * kMaxDWide + kMergeThreads - 1) / kMergeThreads;
  const int64_t stride = (int64_t)g * rs;
  const float* src[kPer];
  const float* cf[kPer];
  float o[kPer], x[kPer][kMergeUnroll];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kMergeThreads;
    const int rl = min(e / dv, nr - 1);
    src[i] = pb + (int64_t)(r0 + rl) * rs + (e - (e / dv) * dv);
    cf[i] = coef + rl * nb;
    o[i] = 0.f;
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u)
      x[i][u] = u < n_slots && e < nr * dv ? src[i][u * stride] : 0.f;
  }
  // a warp a row: the slots' (m, l) in one pass (l into the coefficients
  // for now), m* and then exp(m_s - m*) from what was loaded
  if (wp < nr) {
    const int r = r0 + wp;
    float* cr = coef + wp * nb;
    float* mr = slot_m + wp * nb;
    float mx = kNegInf;
    for (int j = lane; j < n_slots; j += 32) {
      const int s = s_first + j;
      const int64_t g0 = (int64_t)s * total / nb;
      const int64_t g1 = (int64_t)(s + 1) * total / nb;
      const bool reached = (g0 > at ? g0 : (int64_t)at) <
                           (g1 < at + n ? g1 : (int64_t)(at + n));
      const float* pr = pb + ((int64_t)j * g + r) * rs;
      const float ls = reached ? pr[dv + 1] : 0.f;
      const float m = reached ? pr[dv] : kNegInf;
      cr[j] = ls;
      mr[j] = m;
      if (ls > 0.f) mx = fmaxf(mx, m);
    }
    mx = warp_max(mx);
    float lsum = 0.f;
    for (int j = lane; j < n_slots; j += 32) {
      const float ls = cr[j];
      const float c = ls > 0.f ? __expf(mr[j] - mx) : 0.f;
      cr[j] = c;
      lsum += c * ls;
    }
    lsum = warp_sum(lsum);
    if (lane == 0) {
      inv[wp] = 1.f / fmaxf(lsum, 1e-30f);
      lse[(int64_t)bi * h + (int64_t)kh * g + r] =
          lsum > 0.f ? mx + logf(lsum) : kNegInf;
    }
  }
  __syncthreads();
  for (int j0 = 0; j0 < n_slots; j0 += kMergeUnroll) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (threadIdx.x + i * kMergeThreads < nr * dv) {
        if (j0 > 0) {
#pragma unroll
          for (int u = 0; u < kMergeUnroll; ++u)
            x[i][u] = j0 + u < n_slots ? src[i][(j0 + u) * stride] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kMergeUnroll; ++u) {
          // a slot of coefficient 0 wrote no acc, or not for this row:
          // loaded, not used
          const float f = j0 + u < n_slots ? cf[i][j0 + u] : 0.f;
          o[i] = f != 0.f ? fmaf(f, x[i][u], o[i]) : o[i];
        }
      }
    }
  }
  TO* ob = out + ((int64_t)bi * h + (int64_t)kh * g + r0) * dv;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kMergeThreads;
    if (e < nr * dv) ob[e] = from_f<TO>(o[i] * inv[e / dv]);
  }
}

bool dims_ok(int d, int dv) {
  return d > 0 && d <= kMaxDWide && dv > 0 && dv <= kMaxDWide;
}

int is_wide(int d, int dv) { return d > kMaxD || dv > kMaxD; }

// the packed instantiation: a wide head dim and a large GQA group (the
// wrapper's paged_form)
int is_packed(int g, int d, int dv) {
  return g >= kPackedMinG && is_wide(d, dv);
}

using Kernel = void (*)(const void*, const void*, const void*, const int*,
                        const int*, void*, float*, int, int, int, int, int,
                        int, int, int64_t, int64_t, int64_t, int64_t, int,
                        float, float, int, int);

// the element types: q and pools fp32; q and pools T16 (k16); q T16 over
// fp32 pools (k16Q: the zero-copy serving mix, a 16-bit plan's q against
// the fp32 engine pool; the q.K^T of the packed kernel then takes q's
// values as TF32 with no rounding: bf16's 7 and fp16's 10 mantissa bits fit
// TF32's 10, and every fp16 exponent, subnormals included, is a normal
// TF32 one); TOut, the output's (and q's) type of this library's kernels
constexpr int kF32 = 0, k16 = 1, k16Q = 2;
#ifdef PAGED_ATTENTION_16
using TOut = T16;
#else
using TOut = float;
#endif

using PackedKernel = void (*)(const void*, const void*, const void*,
                              const int*, const int*, void*, float*, int, int,
                              int, int, int, int, int, int64_t, int64_t,
                              int64_t, int64_t, int, float, float, int, int,
                              int, int);

PackedKernel pick_packed(int types) {
#ifdef PAGED_ATTENTION_16
  return types == k16 ? paged_packed_kernel<T16, T16, kPackedRows>
                      : paged_packed_kernel<T16, float, kPackedRows>;
#else
  (void)types;
  return paged_packed_kernel<float, float, kPackedRows>;
#endif
}

size_t packed_smem(int types, int d, int dv) {
  const int rows = kPackedRows;
  const int iq = types == kF32 ? 4 : 2, ikv = types == k16 ? 2 : 4;
  const size_t q = (size_t)rows * packed_stride(d, iq, false) * iq;
  const size_t stages = (size_t)kPackedT * ikv *
                        (2 * packed_stride(d, ikv, false) +
                         packed_stride(dv, ikv, true));
  const size_t s = sizeof(float) * (size_t)kPackedWarps * rows *
                   (kPackedT + 4);
  const size_t p = types == k16 ? 2 * sizeof(bf16) * rows * (kPackedT + 8)
                                  : 0;
  return q + stages + s + p + sizeof(float) * 3 * rows +
         sizeof(int) * (2 * (size_t)kPackedList + 1);
}

// the rows a block takes, rounded up to an instantiated G
int rows_g(int g) {
  const int gb = (g + (g + kMaxG - 1) / kMaxG - 1) / ((g + kMaxG - 1) / kMaxG);
  return gb <= 1 ? 1 : gb <= 2 ? 2 : 4;
}

// values a vector copy of the pools moves: 16 bytes, but 8 for 16 bits in the
// wide instantiation (4 a copy keeps a lane's 20 values of a 576 row in
// registers, as fp32's five float4 slots do; 16-byte copies would take 24)
template <typename TKV, int LF>
constexpr int vec_values() {
  return sizeof(TKV) == 4 ? 4 : LF == kLaneNarrow ? 8 : 4;
}

template <typename TQ, typename TKV, int G, int LF>
Kernel pick_g(int vec_k, int vec_v) {
  constexpr int W = vec_values<TKV, LF>();
  if constexpr (sizeof(TQ) == 4) {          // fp32: each pool its own width
    if (vec_k)
      return vec_v ? paged_kernel<TQ, TKV, W, W, G, LF>
                   : paged_kernel<TQ, TKV, W, 1, G, LF>;
    return vec_v ? paged_kernel<TQ, TKV, 1, W, G, LF>
                 : paged_kernel<TQ, TKV, 1, 1, G, LF>;
  } else {                                  // 16-bit q: both or neither
    return vec_k && vec_v ? paged_kernel<TQ, TKV, W, W, G, LF>
                          : paged_kernel<TQ, TKV, 1, 1, G, LF>;
  }
}

template <typename TQ, typename TKV, int LF>
Kernel pick_lf(int vec_k, int vec_v, int gr) {
  return gr == 1   ? pick_g<TQ, TKV, 1, LF>(vec_k, vec_v)
         : gr == 2 ? pick_g<TQ, TKV, 2, LF>(vec_k, vec_v)
                   : pick_g<TQ, TKV, 4, LF>(vec_k, vec_v);
}

template <typename TQ, typename TKV>
Kernel pick_t(int vec_k, int vec_v, int gr, int wide) {
  return wide ? pick_lf<TQ, TKV, kLaneWide>(vec_k, vec_v, gr)
              : pick_lf<TQ, TKV, kLaneNarrow>(vec_k, vec_v, gr);
}

// the wide instantiation where either head dim passes 256; this
// library's element types only (the file's note on PAGED_ATTENTION_16)
Kernel pick(int types, int vec_k, int vec_v, int gr, int wide) {
#ifdef PAGED_ATTENTION_16
  return types == k16 ? pick_t<T16, T16>(vec_k, vec_v, gr, wide)
                      : pick_t<T16, float>(vec_k, vec_v, gr, wide);
#else
  (void)types;
  return pick_t<float, float>(vec_k, vec_v, gr, wide);
#endif
}

int slot(int types, int vec_k, int vec_v, int gr, int wide) {
  return types * 24 + wide * 12 + (gr == 1 ? 0 : gr == 2 ? 4 : 8) +
         vec_k * 2 + vec_v;
}

// a copy's values: the vector width where vec, else 1
int copy_values(int types, int vec, int wide) {
  if (!vec) return 1;
  return types == k16 && !wide ? 8 : 4;
}

size_t smem_bytes(int types, int d, int dv, int vec_k, int vec_v, int p_max,
                  int n_split) {
  const int wide = is_wide(d, dv);
  const size_t item = types == k16 ? (size_t)2 : sizeof(float);
  const int fk = lane_floats(d, copy_values(types, vec_k, wide));
  const int fv = lane_floats(dv, copy_values(types, vec_v, wide));
  const size_t stages =
      item * kStages * kWarps * kPer * (fk + fv) * 32;
  const size_t merge = sizeof(float) * kWarps * kMaxG * (dv + 2);
  const int pps = (p_max + n_split - 1) / n_split;
  return (stages > merge ? stages : merge) +
         sizeof(int) * (2 * (size_t)pps + 1);
}

// Raise a kernel's dynamic shared-memory limit only when a larger size is
// first asked for on the current device (the attribute is kept per device
// and per kernel), so launches captured in a CUDA graph make no such call.
// (the packed kernels' in the last three slots, by types)
size_t configured[kMaxDevices][3 * 24 + 3] = {};

cudaError_t set_smem(int slot_i, const void* kern, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  size_t& have = configured[dev][slot_i];
  if (smem <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) have = smem;
  return err;
}

cudaError_t configure(int types, int vec_k, int vec_v, int gr, int wide,
                      size_t smem) {
  return set_smem(slot(types, vec_k, vec_v, gr, wide),
                  (const void*)pick(types, vec_k, vec_v, gr, wide), smem);
}

cudaError_t configure_packed(int types, size_t smem) {
  return set_smem(3 * 24 + types, (const void*)pick_packed(types), smem);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// whether a pool plane takes copies of n values (n * item bytes): its base,
// its head dim and both strides aligned to them
bool vec_ok(const void* p, int d, int64_t row, int64_t tok, int n,
            int item) {
  return (uintptr_t)p % (n * item) == 0 && d % n == 0 && row % n == 0 &&
         tok % n == 0;
}

template <typename TO>
cudaError_t launch_merge(cudaStream_t st, const float* partials, TO* out,
                         int b, int h, int kv, int dv, int n_split,
                         size_t merge_smem) {
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((int64_t)b * kv));
  cfg.blockDim = dim3(kMergeThreads);
  cfg.dynamicSmemBytes = merge_smem;
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, merge_kernel<TO>, partials, out, h, kv, dv,
                     n_split);
  return cudaGetLastError();
}

// the packed instantiation's launch (launch's checks done): the cut's
// nb = b * n_split blocks for each (KV head, row tile), then the merge
// over (b, kv) x row groups, which also writes each row's log-sum-exp
// after the segments' partials (the wrapper's paged_partial_floats);
// 16-byte copies of q where its rows allow them, of the pools where both
// planes' bases, strides and head dims do
int launch_packed(const void* q, const void* k, const void* v,
                  const void* table, const void* lengths, void* out,
                  void* partials, int b, int h, int kv, int d, int dv,
                  int p_max, int page, int n_rows, int64_t k_row,
                  int64_t k_tok, int64_t v_row, int64_t v_tok, int window,
                  float scale, float cap, int n_split, void* stream,
                  int types) {
  const int g = h / kv;
  const int n_rt = (g + kPackedRows - 1) / kPackedRows;
  const int64_t nb = (int64_t)b * n_split;
  if (partials == nullptr || 2 * nb + 1 > kMergeSmem / (4 * kMergeRows) ||
      (int64_t)kv * n_rt > 0x7fffffff ||
      (int64_t)b * kv > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int iq = types == kF32 ? 4 : 2, ikv = types == k16 ? 2 : 4;
  const int vec_q = aligned16(q) && (d * iq) % 16 == 0;
  const int n = 16 / ikv;
  const int vec_kv = vec_ok(k, d, k_row, k_tok, n, ikv) &&
                     vec_ok(v, dv, v_row, v_tok, n, ikv);
  const size_t smem = packed_smem(types, d, dv);
  if (smem > (size_t)232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = configure_packed(types, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  pick_packed(types)<<<dim3((unsigned)(kv * n_rt), (unsigned)nb),
                       kPackedThreads, smem, st>>>(
      q, k, v, (const int*)table, (const int*)lengths, out, (float*)partials,
      h, kv, d, dv, p_max, page, n_rows, k_row, k_tok, v_row, v_tok, window,
      scale, cap, n_rt, b, vec_q, vec_kv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(b * kv),
                     (unsigned)((g + kMergeRows - 1) / kMergeRows));
  cfg.blockDim = dim3(kMergeThreads);
  cfg.dynamicSmemBytes = sizeof(float) * kMergeRows * (2 * (size_t)nb + 1);
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  float* lse = (float*)partials + (int64_t)kv * (nb + b) * g * (dv + 2);
  cudaLaunchKernelEx(&cfg, merge_rows_kernel<TOut>, (const float*)partials,
                     (TOut*)out, lse, (const int*)lengths, h, kv, dv, p_max,
                     page, window, b, (int)nb);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, const void* table,
           const void* lengths, void* out, void* partials, int b, int h,
           int kv, int d, int dv, int p_max, int page, int n_rows,
           int64_t k_row, int64_t k_tok, int64_t v_row, int64_t v_tok,
           int window, float scale, float cap, int n_split, void* stream,
           int types) {
  if (kv <= 0 || h % kv != 0 || !dims_ok(d, dv) || page <= 0 ||
      p_max < 0 || n_split < 1 ||
      n_split > (p_max > 1 ? p_max : 1) || n_split > 65535 ||
      (n_split > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || h <= 0) return (int)cudaGetLastError();
  const int g = h / kv;
  const size_t merge_smem = sizeof(float) * (size_t)g * (n_split + 1);
  if (n_split > 1 && merge_smem > (size_t)kMergeSmem)
    return (int)cudaErrorInvalidValue;
  if (is_packed(g, d, dv))
    return launch_packed(q, k, v, table, lengths, out, partials, b, h, kv, d,
                         dv, p_max, page, n_rows, k_row, k_tok, v_row, v_tok,
                         window, scale, cap, n_split, stream, types);
  const int n_rg = (g + kMaxG - 1) / kMaxG;
  const int64_t rows = (int64_t)b * kv * n_rg;
  if (rows > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int wide = is_wide(d, dv);
  int vec_k, vec_v;
  if (types == kF32) {      // q's slots load as float4 with K's
    vec_k = aligned16(q) && aligned16(k) && d % 4 == 0 && k_row % 4 == 0 &&
            k_tok % 4 == 0;
    vec_v = aligned16(v) && dv % 4 == 0 && v_row % 4 == 0 && v_tok % 4 == 0;
  } else {                  // 16-bit q loads by value: the pools decide
    const int n = copy_values(types, 1, wide);
    const int item = types == k16 ? 2 : 4;
    vec_k = vec_v = vec_ok(k, d, k_row, k_tok, n, item) &&
                    vec_ok(v, dv, v_row, v_tok, n, item);
  }
  const size_t smem = smem_bytes(types, d, dv, vec_k, vec_v, p_max, n_split);
  const int gr = rows_g(g);
  cudaError_t err = configure(types, vec_k, vec_v, gr, wide, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)rows, n_split);
  pick(types, vec_k, vec_v, gr, wide)<<<grid, kThreads, smem, st>>>(
      q, k, v, (const int*)table, (const int*)lengths, out, (float*)partials,
      h, kv, d, dv, p_max, page, n_rows, k_row, k_tok, v_row, v_tok, window,
      scale, cap, n_rg, n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  return (int)launch_merge(st, (const float*)partials, (TOut*)out, b, h, kv,
                           dv, n_split, merge_smem);
}

int info_of(int g, int d, int dv, int vec_k, int vec_v, int p_max,
            int n_split, int types, int* info) {
  if (g <= 0 || !dims_ok(d, dv) || n_split < 1)
    return (int)cudaErrorInvalidValue;
  if (is_packed(g, d, dv)) {
    const size_t smem = packed_smem(types, d, dv);
    cudaError_t err = configure_packed(types, smem);
    if (err != cudaSuccess) return (int)err;
    const void* kern = (const void*)pick_packed(types);
    cudaFuncAttributes a, am;
    if ((err = cudaFuncGetAttributes(&a, kern)) != cudaSuccess ||
        (err = cudaFuncGetAttributes(&am, merge_rows_kernel<TOut>)) !=
            cudaSuccess)
      return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, kPackedThreads, smem);
    if (err != cudaSuccess) return (int)err;
    info[0] = a.numRegs;
    info[1] = (int)a.sharedSizeBytes;
    info[2] = (int)smem;
    info[3] = per_sm;
    info[4] = kPackedThreads;
    info[5] = am.numRegs;
    info[6] = kPackedT;
    info[7] = kPackedRows;
    return 0;
  }
  vec_k = vec_k != 0;
  vec_v = vec_v != 0;
  if (types != kF32) vec_k = vec_v = vec_k && vec_v;
  const int gr = rows_g(g);
  const int wide = is_wide(d, dv);
  const size_t smem = smem_bytes(types, d, dv, vec_k, vec_v, p_max, n_split);
  cudaError_t err = configure(types, vec_k, vec_v, gr, wide, smem);
  if (err != cudaSuccess) return (int)err;
  const Kernel kern = pick(types, vec_k, vec_v, gr, wide);
  cudaFuncAttributes a, am;
  err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncGetAttributes(&am, merge_kernel<TOut>);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)smem;
  info[3] = per_sm;
  info[4] = kThreads;
  info[5] = am.numRegs;
  info[6] = kTile;
  info[7] = gr;
  return 0;
}

}  // namespace

extern "C" {

#ifndef PAGED_ATTENTION_16
// q (b, h, d) f32 contiguous; k, v: base pointers of the K and V planes,
// each with its row (extent) and token strides in elements, head stride d
// (K) / dv (V); table (b, p_max) i32; lengths (b,) i32; out (b, h, dv) f32
// contiguous; partials: scratch of b * kv * n_split * (h / kv) * (dv + 2)
// f32 when n_split > 1 (else unused, may be null). 1 <= n_split <= p_max.
int paged_attention(const void* q, const void* k, const void* v,
                    const void* table, const void* lengths, void* out,
                    void* partials, int b, int h, int kv, int d, int dv,
                    int p_max, int page, int n_rows, int64_t k_row,
                    int64_t k_tok, int64_t v_row, int64_t v_tok, int window,
                    float scale, float cap, int n_split, void* stream) {
  return launch(q, k, v, table, lengths, out, partials, b, h, kv, d, dv,
                p_max, page, n_rows, k_row, k_tok, v_row, v_tok, window,
                scale, cap, n_split, stream, kF32);
}

// The main kernel's resources for g query rows a KV head, head dims d, dv
// and n_split shares of p_max pages (vector loads where vec_k / vec_v):
// info[0] registers per thread, [1] static and [2] dynamic shared memory
// per block (bytes), [3] blocks resident per SM, [4] threads per block,
// [5] the merge kernel's registers per thread, [6] positions staged per
// tile, [7] query rows a block.
int paged_attention_info(int g, int d, int dv, int vec_k, int vec_v,
                         int p_max, int n_split, int* info) {
  return info_of(g, d, dv, vec_k, vec_v, p_max, n_split, kF32, info);
}
#else
// The same with q and out T16 (bf16 in paged_attention_bf16, fp16 in
// paged_attention_f16), and the K and V planes T16 (kv_16 1) or f32 (0);
// the partials stay f32.
int PAGED16_ENTRY(const void* q, const void* k, const void* v,
                  const void* table, const void* lengths, void* out,
                  void* partials, int b, int h, int kv, int d, int dv,
                  int p_max, int page, int n_rows, int64_t k_row,
                  int64_t k_tok, int64_t v_row, int64_t v_tok, int window,
                  float scale, float cap, int n_split, int kv_16,
                  void* stream) {
  return launch(q, k, v, table, lengths, out, partials, b, h, kv, d, dv,
                p_max, page, n_rows, k_row, k_tok, v_row, v_tok, window,
                scale, cap, n_split, stream, kv_16 ? k16 : k16Q);
}

// paged_attention_info for the 16-bit forms (kv_16 as in the entry above;
// vector loads where both vec_k and vec_v).
int PAGED16_INFO(int g, int d, int dv, int vec_k, int vec_v, int p_max,
                 int n_split, int kv_16, int* info) {
  return info_of(g, d, dv, vec_k, vec_v, p_max, n_split, kv_16 ? k16 : k16Q,
                 info);
}
#endif

}  // extern "C"
