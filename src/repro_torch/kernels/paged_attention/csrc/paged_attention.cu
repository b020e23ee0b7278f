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
// bf16 (a bf16 plan's split pools); or q and the output bf16 over fp32
// pools (a bf16 plan's q against the fp32 engine pool of zero-copy
// serving). Loads convert to fp32; the logits, the softmax, the
// accumulators and the partials stay fp32; the output is rounded to q's
// dtype once, at the end.
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
// Design (flash-decoding).
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
//   on one KV head, so 32 row groups of 4).
//   The wide one stages 160 KiB (one block an SM) and keeps 2 x 4 rows x
//   20 floats of q and accumulator a lane (launch bounds for one block an
//   SM, 255 registers). Each of the 32 row groups of a sequence re-reads
//   its latent pages: 32x the bytes of the bound, right and slow; packing
//   the G rows of one KV head into one block is a speed PR's work.
// - What holds it back (kernel phase_costs.py, variants that drop one part,
//   at the serving inputs): not the bytes. Dropping every K/V load saves
//   about a third of the call, the tile math about a quarter, the merge
//   about a sixth; what stays is the fixed cost of a call (two launches,
//   the length and table round trips before the first copy, the block's
//   merge and the partials' round trip), so the call is latency-bound at
//   about a third of the HBM rate. Overlapping the merge with the next
//   layer's work, or fewer and longer shares per SM with a deeper ring,
//   come next.
//
// Two libraries from this file, compiled in parallel: the fp32 form's
// kernels and entries (paged_attention, paged_attention_info) as it is, and
// with PAGED_ATTENTION_BF16 defined (paged_attention_bf16.cu includes this
// file) the bf16 forms' (paged_attention_bf16, paged_attention_bf16_info):
// one file of 48 instantiations took 78 s of nvcc, each half about 40.
//
// Offsets are 64-bit: an engine pool holds up to ~2^30 floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

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
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// one copy of W values of type T into shared memory: cp.async for 16, 8
// and 4 bytes; one bf16 (2 bytes, below cp.async's smallest copy) by a
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

// bf16 pairs to floats: the low half first, exact
__device__ __forceinline__ void unpack2(float* x, uint32_t u) {
  x[0] = __uint_as_float(u << 16);
  x[1] = __uint_as_float(u & 0xffff0000u);
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
    unpack2(x, y.x);
    unpack2(x + 2, y.y);
    unpack2(x + 4, y.z);
    unpack2(x + 6, y.w);
  } else if constexpr (sizeof(T) == 2 && W == 4) {
    const uint2 y = *(const uint2*)p;
    unpack2(x, y.x);
    unpack2(x + 2, y.y);
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

// TQ: q's and the output's type, TKV: the pools' (float, float; bf16,
// bf16; or bf16 over float pools); WK, WV: values a K / V copy (16 bytes:
// 4 floats or 8 bf16; 8 bytes: 4 bf16 in the wide instantiation; or 1);
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

bool dims_ok(int d, int dv) {
  return d > 0 && d <= kMaxDWide && dv > 0 && dv <= kMaxDWide;
}

int is_wide(int d, int dv) { return d > kMaxD || dv > kMaxD; }

using Kernel = void (*)(const void*, const void*, const void*, const int*,
                        const int*, void*, float*, int, int, int, int, int,
                        int, int, int64_t, int64_t, int64_t, int64_t, int,
                        float, float, int, int);

// the element types: q and pools fp32; q and pools bf16; q bf16 over fp32
// pools (the zero-copy serving mix: a bf16 plan's q, the fp32 engine pool);
// TOut, the output's (and q's) type of this library's kernels
constexpr int kF32 = 0, kBF16 = 1, kBF16Q = 2;
#ifdef PAGED_ATTENTION_BF16
using TOut = bf16;
#else
using TOut = float;
#endif

// the rows a block takes, rounded up to an instantiated G
int rows_g(int g) {
  const int gb = (g + (g + kMaxG - 1) / kMaxG - 1) / ((g + kMaxG - 1) / kMaxG);
  return gb <= 1 ? 1 : gb <= 2 ? 2 : 4;
}

// values a vector copy of the pools moves: 16 bytes, but 8 for bf16 in the
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
  } else {                                  // bf16 q: both or neither
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
// library's element types only (the file's note on PAGED_ATTENTION_BF16)
Kernel pick(int types, int vec_k, int vec_v, int gr, int wide) {
#ifdef PAGED_ATTENTION_BF16
  return types == kBF16 ? pick_t<bf16, bf16>(vec_k, vec_v, gr, wide)
                        : pick_t<bf16, float>(vec_k, vec_v, gr, wide);
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
  return types == kBF16 && !wide ? 8 : 4;
}

size_t smem_bytes(int types, int d, int dv, int vec_k, int vec_v, int p_max,
                  int n_split) {
  const int wide = is_wide(d, dv);
  const size_t item = types == kBF16 ? sizeof(bf16) : sizeof(float);
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
size_t configured[kMaxDevices][3 * 24] = {};

cudaError_t configure(int types, int vec_k, int vec_v, int gr, int wide,
                      size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  size_t& have = configured[dev][slot(types, vec_k, vec_v, gr, wide)];
  if (smem <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(pick(types, vec_k, vec_v, gr, wide),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) have = smem;
  return err;
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
  const int n_rg = (g + kMaxG - 1) / kMaxG;
  const int64_t rows = (int64_t)b * kv * n_rg;
  if (rows > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int wide = is_wide(d, dv);
  int vec_k, vec_v;
  if (types == kF32) {      // q's slots load as float4 with K's
    vec_k = aligned16(q) && aligned16(k) && d % 4 == 0 && k_row % 4 == 0 &&
            k_tok % 4 == 0;
    vec_v = aligned16(v) && dv % 4 == 0 && v_row % 4 == 0 && v_tok % 4 == 0;
  } else {                  // bf16 q loads by value: the pools decide
    const int n = copy_values(types, 1, wide);
    const int item = types == kBF16 ? 2 : 4;
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

#ifndef PAGED_ATTENTION_BF16
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
// The same with q and out bf16, and the K and V planes bf16 (kv_bf16 1)
// or f32 (0); the partials stay f32.
int paged_attention_bf16(const void* q, const void* k, const void* v,
                         const void* table, const void* lengths, void* out,
                         void* partials, int b, int h, int kv, int d, int dv,
                         int p_max, int page, int n_rows, int64_t k_row,
                         int64_t k_tok, int64_t v_row, int64_t v_tok,
                         int window, float scale, float cap, int n_split,
                         int kv_bf16, void* stream) {
  return launch(q, k, v, table, lengths, out, partials, b, h, kv, d, dv,
                p_max, page, n_rows, k_row, k_tok, v_row, v_tok, window,
                scale, cap, n_split, stream, kv_bf16 ? kBF16 : kBF16Q);
}

// paged_attention_info for the bf16 forms (kv_bf16 as in
// paged_attention_bf16; vector loads where both vec_k and vec_v).
int paged_attention_bf16_info(int g, int d, int dv, int vec_k, int vec_v,
                              int p_max, int n_split, int kv_bf16,
                              int* info) {
  return info_of(g, d, dv, vec_k, vec_v, p_max, n_split,
                 kv_bf16 ? kBF16 : kBF16Q, info);
}
#endif

}  // extern "C"
