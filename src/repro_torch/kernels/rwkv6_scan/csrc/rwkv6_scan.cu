// rwkv6_scan: the RWKV-6 (Finch) recurrence with data-dependent decay,
// written for Hopper (sm_90a), with a plain C interface loaded by ctypes
// (kernels/_build.py, wrapper in kernels/rwkv6_scan/kernel.py).
//
// Replaces the Pallas kernel repro/kernels/rwkv6_scan/kernel.py::
// rwkv6_scan_fwd (body _kernel). r, k, v, logw (B, S, H, hd) and u (H, hd)
// -> y (B, S, H, hd) and the final state (B, H, hd, hd):
//   y_t = r_t (S_{t-1} + (u * k_t)^T v_t),
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t,
// from S_0 = s0, or zeros when s0 is null (as the TPU kernel starts).
// r, k, v, logw and y are addressed through (batch, sequence, head) strides
// with hd contiguous, so the model layout is read in place; s0, the final
// state and u are contiguous. s0 and s_out may be the same buffer: a block
// reads its own slice of the state before it writes it, and no other block
// touches that slice.
//
// Dtypes, as the TPU kernel takes them: r, k, v, logw and y are fp32, bf16
// or fp16 together (the TI template argument: y in r's dtype; the 16-bit
// types' conversions in elt16.cuh), u fp32, bf16 or fp16 (a type code), s0
// and the final state fp32. Both schedules load a 16-bit input into fp32
// where they read it and compute in fp32 as the fp32 form does; y is
// rounded to its type once, on its store (in fp16 only y can overflow: the
// state stays fp32, as the reference's does). The prefill's 16-bit staging
// is synchronous (16-bit inputs cannot go through cp.async into the fp32
// tiles): a thread loads 8 bytes (4 values) where the tensor's base and
// strides allow, else 2, and stores them converted.
//
// Exactness of the column split. Column c of the state depends only on
// column c of v: S_t[j][c] = exp(w_t[j]) S_{t-1}[j][c] + k_t[j] v_t[c] and
// y_t[c] = sum_j r_t[j] (S_{t-1}[j][c] + u_j k_t[j] v_t[c]). Both schedules
// below cut the state's columns over blocks, which is exact and needs no
// merge across blocks.
//
// Bound on an H100 SXM. Decode (S = 1, the serving path's B 8, H 40): the
// state read and written, 2 hd^2 * 4 bytes per (b, h), 10.5 MB a call: bytes
// bound it (0.00326 ms). Prefill (B 1, about 500 tokens, H 40): r, k, v,
// logw and y, about 8 MB, against 0.49 GFLOP of the chunked form; bytes
// bound it too (0.0080 ms) once the products are on the tensor cores.
// The C entry picks the schedule from seq: kDecodeMax tokens or fewer take
// the decode schedule, more the prefill one.
//
// Decode schedule (seq <= kDecodeMax = 8). One warp per (head, batch,
// slice of 4 W columns), W = 4 (float4) when hd % 4 == 0 and the state is
// 16-byte aligned, else 1. Lane (row group rg, column group cg) keeps rows
// rg * ceil(hd/8) ... of its W columns of the state in registers: 16-byte
// loads, issued with every load of the tokens' r, k, logw, u and the
// warp's v columns (loops unrolled to the most a call can have, so no
// round trip waits for another), which are then staged in shared memory,
// then a loop over the tokens: y's partial sums over the lane's rows,
// three shuffles across the row groups, the state update in registers; the
// state goes out with 16-byte stores. No barrier but one __syncwarp. At
// the serving path's decode that is 1280 warps, every one resident at once.
//
// Prefill schedule. Grid (H, B, n_col): each block holds dp x dp/n_col of
// the state (hd padded to dp = 16, 32 or 64; cw = dp/n_col columns, a
// multiple of 8), n_col from B * H and the SM count (kernel.py
// rwkv6_n_col: double it while the grid stays within kBlocksPerSm blocks
// an SM: 4 at B 1, H 40, 160 blocks, one wave at two blocks an SM).
// Shared memory is sized to min(chunk, seq) rounded up to 16 rows,
// 112 KiB at chunk 64, hd 64 and n_col 4. Each chunk of up to
// 64 tokens is cut into 16-token sub-chunks a, b. With lc the inclusive
// running sum of logw inside a sub-chunk, lx its exclusive one, tot_a its
// total and P_a the sum of the totals before a:
//   y_i  = (r_i exp(P_a + lx_i)) S_in                         inter-chunk
//        + sum_{s < i, same sub-chunk} [sum_j r k exp(lx_i - lc_s)] v_s
//        + sum_{b < a} rt_a diag(mid_ab) kh_b^T v_b        off-diagonal
//        + (r_i . (u * k_i)) v_i                                   bonus
//   S_out = diag(exp(P_n)) S_in + sum_b (kh_b diag(suf_b))^T v_b
// with rt_i = r_i exp(lx_i), kh_s = k_s exp(tot_b - lc_s), mid_ab =
// exp(sum_{b < c < a} tot_c) and suf_b = exp(sum_{c > b} tot_c). For s in
// an earlier sub-chunk than i this is exp(cex_i - cum_s) = exp(cex_i -
// cum_B) exp(cum_B - cum_s) with B the last token before i's sub-chunk,
// split further at the end of s's sub-chunk: every exponent is a sum of
// log decays and never positive, so no factor overflows fp32 whatever the
// chunk's total decay (the reference's exp(-cum) overflows below -88), and
// a factor that underflows to 0 stands for a product that is below fp32's
// range anyway. Only the 16 x 16 diagonal sub-blocks keep one exp per
// (i, s, j), and of those only their two 8 x 8 triangles: the lower-left
// 8 x 8 quadrant is split the same way at the sub-chunk's 8th token. That
// is 56 x 64 exps per sub-chunk, one (row, key) pair a lane. rt, kh and
// the per-column factors are made once per chunk (two exps per element)
// by the thread that owns the element's column and sub-chunk. The exps
// are __expf.
//
// Products on the tensor cores: mma.sync m16n8k8 in 3xTF32 (x = hi + lo,
// hi the TF32 rounding; a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in fp32),
// as flash_attention.cu does: one TF32 product misses fp32's 1e-4, the
// split product does not. All four products use them: the off-diagonal
// intra-chunk sub-blocks rt_a (kh_b mid_ab)^T (their accumulator is the A
// operand of the next product, the keys permuted as in flash), att . v,
// the inter-chunk read (rt pre_a) S_in and the state update (kh suf)^T v.
// Warp (a, h) of the eight takes row sub-chunk a and every other key tile
// of it (and of the inter-chunk k steps), so each warp computes its own
// rows of att and keeps them in registers: att never goes to shared
// memory. The two warps of a sub-chunk add their y through shared memory.
// Each warp also takes tiles of the new state. The big and the small
// products of 3xTF32 go into separate accumulators, so consecutive
// products into one accumulator stand apart.
//
// Barriers a chunk: the chunk landed; the sub-chunk totals; rt, kh and
// the factors; the diagonal blocks done (raw r, k, logw free); y and the
// new state computed. After the fourth, the next chunk's r, k, logw and v
// are staged with cp.async (16 bytes where the tensor's base and strides
// allow, 4 otherwise; rows past the sequence zero-filled) while this
// chunk's products run. Columns of the padded head dim are zero.
//
// What holds it back (phase_costs.py, variants that drop one phase, at the
// serving prefill): the diagonal triangles' pairwise sums take about 40%
// of a call (their shared-memory reads, four 16-byte loads per four exps,
// and the exp rate), the products about as much again, 3xTF32's two extra
// products about 13% and the staging that is not hidden under them about
// 9%; 16 warps an SM (two blocks of eight, at the 128-register cap, a few
// spilled) hide little latency. Fewer exps on the diagonal (a finer split
// of its triangles) and wgmma for the products come next.
//
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/elt16.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 64;
constexpr int kMaxC = 64;
constexpr int kSub = 16;                      // sub-chunk of a chunk
constexpr int kDecodeMax = 8;                 // seq <= this: decode
constexpr int kBlocksPerSm = 2;               // prefill; kernel.py too
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------
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

// a . b in 3xTF32 from fp32 fragments (a: 4 values, b: 2): the big
// product into hi, the two small ones into lo (the caller adds them), so
// that products into one accumulator stand apart
__device__ __forceinline__ void mma3(float* hi, float* lo, const float* a,
                                     const float* b) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], ah[i], al[i]);
  split(b[0], bh[0], bl[0]);
  split(b[1], bh[1], bl[1]);
  mma(lo, al, bh);
  mma(hi, ah, bh);
  mma(lo, ah, bl);
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

// the type codes of the C entry (in_type, u_type)
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

// an input element as fp32, and y's store in its dtype
__device__ __forceinline__ float ld_in(const float* p) { return *p; }
template <typename T>
__device__ __forceinline__ float ld_in(const T* p) {
  return Elt16<T>::to_f(*p);
}
__device__ __forceinline__ void st_out(float* p, float x) { *p = x; }
template <typename T>
__device__ __forceinline__ void st_out(T* p, float x) {
  *p = Elt16<T>::from_f(x);
}
// u[i] of type code u_type
__device__ __forceinline__ float ld_u(const void* u, int64_t i, int u_type) {
  return u_type == kBF16  ? ld_in((const __nv_bfloat16*)u + i)
         : u_type == kF16 ? ld_in((const __half*)u + i)
                          : ((const float*)u)[i];
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The current device's SM count, read once per device (0 on an error).
int sm_count() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// ---------------------------------------------------------------------------
// decode schedule
// ---------------------------------------------------------------------------
template <typename TI, int W>
__global__ void __launch_bounds__(32)
decode_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
              const TI* __restrict__ v, const TI* __restrict__ w,
              const void* __restrict__ u, int u_type, const float* s0,
              TI* __restrict__ y, float* s_out, int seq, int h, int d,
              int64_t rsb, int64_t rss, int64_t rsh, int64_t ksb,
              int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
              int64_t vsh, int64_t wsb, int64_t wss, int64_t wsh,
              int64_t ysb, int64_t yss, int64_t ysh) {
  __shared__ float sr[kDecodeMax][kMaxD], sk[kDecodeMax][kMaxD];
  __shared__ float sw[kDecodeMax][kMaxD], sv[kDecodeMax][4 * W];
  __shared__ float su[kMaxD];
  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x;
  const int cg = lane & 3;
  const int rg = lane >> 2;
  const int rpl = (d + 7) >> 3;               // rows a lane
  const int c = blockIdx.z * 4 * W + cg * W;  // the lane's first column
  const int64_t soff = ((int64_t)b * h + hh) * d * d;

  float st[8][W];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = rg * rpl + i;
    const bool in = i < rpl && j < d && c < d;
    if constexpr (W == 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in && s0) x = *(const float4*)(s0 + soff + (int64_t)j * d + c);
      st[i][0] = x.x;
      st[i][W > 1 ? 1 : 0] = x.y;
      st[i][W > 2 ? 2 : 0] = x.z;
      st[i][W > 3 ? 3 : 0] = x.w;
    } else {
      st[i][0] = in && s0 ? s0[soff + (int64_t)j * d + c] : 0.f;
    }
  }
  // the tokens' r, k, logw, u and this warp's v columns: every load in
  // flight at once (unrolled to the most a call can have), then staged
  constexpr int kIt = kDecodeMax * kMaxD / 32;
  constexpr int kItV = (kDecodeMax * 4 * W + 31) / 32;
  const int n = seq * d;
  float ra[kIt], ka[kIt], wa[kIt], ua[kMaxD / 32], va[kItV];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int e = lane + 32 * it;
    if (e < n) {
      const int t = e / d;
      const int j = e - t * d;
      ra[it] = ld_in(r + (b * rsb + t * rss + hh * rsh + j));
      ka[it] = ld_in(k + (b * ksb + t * kss + hh * ksh + j));
      wa[it] = ld_in(w + (b * wsb + t * wss + hh * wsh + j));
    }
  }
#pragma unroll
  for (int it = 0; it < kMaxD / 32; ++it) {
    const int e = lane + 32 * it;
    if (e < d) ua[it] = ld_u(u, (int64_t)hh * d + e, u_type);
  }
#pragma unroll
  for (int it = 0; it < kItV; ++it) {
    const int e = lane + 32 * it;
    const int t = e / (4 * W);
    const int cc = blockIdx.z * 4 * W + (e - t * 4 * W);
    va[it] = (t < seq && cc < d)
                 ? ld_in(v + (b * vsb + t * vss + hh * vsh + cc))
                 : 0.f;
  }
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int e = lane + 32 * it;
    if (e < n) {
      const int t = e / d;
      const int j = e - t * d;
      sr[t][j] = ra[it];
      sk[t][j] = ka[it];
      sw[t][j] = __expf(wa[it]);
    }
  }
#pragma unroll
  for (int it = 0; it < kMaxD / 32; ++it) {
    const int e = lane + 32 * it;
    if (e < d) su[e] = ua[it];
  }
#pragma unroll
  for (int it = 0; it < kItV; ++it) {
    const int e = lane + 32 * it;
    const int t = e / (4 * W);
    if (t < seq) sv[t][e - t * 4 * W] = va[it];
  }
  __syncwarp();

  for (int t = 0; t < seq; ++t) {
    float vv[W], yp[W], ruk = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      vv[e] = sv[t][cg * W + e];
      yp[e] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = rg * rpl + i;
      if (i < rpl && j < d) {
        const float rj = sr[t][j], kj = sk[t][j], ej = sw[t][j];
        ruk += rj * su[j] * kj;
#pragma unroll
        for (int e = 0; e < W; ++e) {
          yp[e] += rj * st[i][e];
          st[i][e] = ej * st[i][e] + kj * vv[e];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < W; ++e) {
      yp[e] += ruk * vv[e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        yp[e] += __shfl_xor_sync(0xffffffffu, yp[e], o);
    }
    if (rg == 0 && c < d) {
      TI* yt = y + b * ysb + t * yss + hh * ysh + c;
      if constexpr (W == 4 && std::is_same<TI, float>::value) {
        *(float4*)yt = make_float4(yp[0], yp[W > 1 ? 1 : 0],
                                   yp[W > 2 ? 2 : 0], yp[W > 3 ? 3 : 0]);
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) st_out(yt + e, yp[e]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = rg * rpl + i;
    if (i < rpl && j < d && c < d) {
      float* o = s_out + soff + (int64_t)j * d + c;
      if constexpr (W == 4) {
        *(float4*)o = make_float4(st[i][0], st[i][W > 1 ? 1 : 0],
                                  st[i][W > 2 ? 2 : 0], st[i][W > 3 ? 3 : 0]);
      } else {
        o[0] = st[i][0];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// prefill schedule
// ---------------------------------------------------------------------------
// hd padded to 16, 32 or 64: a power of two, so every column split is a
// number of 8-column tiles that the kernel is built for
__host__ __device__ inline int padded_dim(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : 64;
}

struct Geo {
  int dp;     // hd padded (padded_dim)
  int cw;     // state columns a block
  int lmax;   // rows of a staged chunk: min(chunk, seq) padded to 16
  int pd;     // row pitch of the (lmax, dp) tiles: dp + 4
  int pv;     // row pitch of v, the state and y: cw (+ 8), 8 or 24 mod 32
  size_t floats;
};

__host__ __device__ inline Geo geometry(int d, int seq, int chunk,
                                        int n_col) {
  Geo g;
  g.dp = padded_dim(d);
  g.cw = g.dp / n_col;
  g.lmax = ((seq < chunk ? seq : chunk) + 15) & ~15;
  g.pd = g.dp + 4;
  g.pv = g.cw + (((g.cw >> 3) & 1) ? 0 : 8);
  const int yreg = 64 * g.pv > 4 * g.dp ? 64 * g.pv : 4 * g.dp;
  g.floats = 5 * (size_t)g.lmax * g.pd + 2 * (size_t)g.lmax * g.pv +
             (size_t)g.dp * g.pv + yreg + 13 * (size_t)g.dp;
  return g;
}

// rows [0, rows) of a chunk starting at token t0 (rows >= len zero-filled),
// columns [0, ncols) of a (seq, *) strided tensor, into shared rows of
// pitch p
__device__ __forceinline__ void stage(float* dst, int p, const float* src,
                                      int64_t rs, int t0, int len, int rows,
                                      int ncols, bool vec) {
  const int per = vec ? ncols >> 2 : ncols;   // copies a row, <= kThreads
  const int step = kThreads / per;            // rows a pass
  const int first = threadIdx.x / per;
  if (first >= step) return;                  // left over by a pass
  const int c = (threadIdx.x - first * per) << (vec ? 2 : 0);
  for (int row = first; row < rows; row += step) {
    const bool in = row < len;
    const float* s = in ? src + (int64_t)(t0 + row) * rs + c : src;
    if (vec)
      cp16(dst + row * p + c, s, in);
    else
      cp4(dst + row * p + c, s, in);
  }
}

// the same from a 16-bit tensor, synchronously: each value converted to
// fp32 on its way into the tile (vec: 8-byte loads of 4 values)
template <typename T>
__device__ __forceinline__ void stage(float* dst, int p, const T* src,
                                      int64_t rs, int t0, int len, int rows,
                                      int ncols, bool vec) {
  const int per = vec ? ncols >> 2 : ncols;   // loads a row, <= kThreads
  const int step = kThreads / per;            // rows a pass
  const int first = threadIdx.x / per;
  if (first >= step) return;                  // left over by a pass
  const int c = (threadIdx.x - first * per) << (vec ? 2 : 0);
  for (int row = first; row < rows; row += step) {
    const bool in = row < len;
    const T* s = src + (int64_t)(t0 + row) * rs + c;
    float* o = dst + row * p + c;
    if (vec) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in) {
        const uint2 raw = *(const uint2*)s;
        const float2 lo = unpack2<T>(raw.x);
        const float2 hi = unpack2<T>(raw.y);
        x = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      *(float4*)o = x;
    } else {
      *o = in ? ld_in(s) : 0.f;
    }
  }
}

template <typename TI, int NT>   // input dtype; 8-column tiles of the slice
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
prefill_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
               const TI* __restrict__ v, const TI* __restrict__ w,
               const void* __restrict__ u, int u_type, const float* s0,
               TI* __restrict__ y, float* s_out, int seq, int h, int d,
               int chunk, int n_col, int64_t rsb, int64_t rss, int64_t rsh,
               int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
               int64_t vss, int64_t vsh, int64_t wsb, int64_t wss,
               int64_t wsh, int64_t ysb, int64_t yss, int64_t ysh,
               int vec_in, int vec_v) {
  extern __shared__ __align__(16) float smem[];
  const Geo geo = geometry(d, seq, chunk, n_col);
  const int dp = geo.dp, lmax = geo.lmax, pd = geo.pd, pv = geo.pv;
  constexpr int cw = NT * 8;
  float* R = smem;                       // (lmax, pd): r
  float* K = R + lmax * pd;              // k
  float* W = K + lmax * pd;              // logw, then lc in place
  float* RT = W + lmax * pd;             // rt = r exp(lx)
  float* KH = RT + lmax * pd;            // kh = k exp(tot - lc)
  float* V0 = KH + lmax * pd;            // 2 x (lmax, pv): v's columns
  float* S = V0 + 2 * lmax * pv;         // (dp, pv): the state slice
  float* Y = S + dp * pv;                // (4, 16, pv): y of odd warps
  float* tot = Y;                        // (4, dp), aliases Y
  float* pre = Y + (64 * pv > 4 * dp ? 64 * pv : 4 * dp);  // (4, dp)
  float* suf = pre + 4 * dp;             // (4, dp)
  float* mid = suf + 4 * dp;             // (3, dp): (2,0), (3,1), (3,0)
  float* etot = mid + 3 * dp;            // (dp)
  float* us = etot + dp;                 // (dp)

  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.z * cw;
  const int cv = min(cw, d - c0);        // live columns of the slice
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int wa = warp >> 1;              // row sub-chunk of this warp
  const int wh = warp & 1;               // its half of the key tiles
  const int64_t soff = ((int64_t)b * h + hh) * d * d;

  const TI* rb = r + b * rsb + hh * rsh;
  const TI* kb = k + b * ksb + hh * ksh;
  const TI* vb = v + b * vsb + hh * vsh + c0;
  const TI* wb = w + b * wsb + hh * wsh;
  TI* yb = y + b * ysb + hh * ysh + c0;

  // padded columns of the staged tiles: zero, once (cp.async never
  // writes them)
  if (dp > d) {
    const int pad = dp - d;
    for (int i = tid; i < 3 * lmax * pad; i += kThreads) {
      const int row = i / pad;
      R[row * pd + d + (i - row * pad)] = 0.f;   // rows of R, K, W
    }
  }
  if (cv < cw) {
    const int pad = cw - cv;
    for (int i = tid; i < 2 * lmax * pad; i += kThreads) {
      const int row = i / pad;
      V0[row * pv + cv + (i - row * pad)] = 0.f;
    }
  }
  for (int i = tid; i < dp * cw; i += kThreads) {
    const int j = i / cw;
    const int c = i - j * cw;
    S[j * pv + c] =
        (s0 && j < d && c < cv) ? s0[soff + (int64_t)j * d + c0 + c] : 0.f;
  }
  for (int j = tid; j < dp; j += kThreads)
    us[j] = j < d ? ld_u(u, (int64_t)hh * d + j, u_type) : 0.f;

  const int n_chunks = (seq + chunk - 1) / chunk;
  {
    const int len = min(chunk, seq);
    const int rows = (len + kSub - 1) & ~(kSub - 1);
    stage(R, pd, rb, rss, 0, len, rows, d, vec_in);
    stage(K, pd, kb, kss, 0, len, rows, d, vec_in);
    stage(W, pd, wb, wss, 0, len, rows, d, vec_in);
    stage(V0, pv, vb, vss, 0, len, rows, cv, vec_v);
    cp_commit();
  }

  const int jc = tid & 63;               // phase 1: column ...
  const int ja = tid >> 6;               // ... and sub-chunk of a thread
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * chunk;
    const int len = min(chunk, seq - t0);
    const int nsub = (len + kSub - 1) / kSub;
    const float* Vc = V0 + (ci & 1) * lmax * pv;
    cp_wait_all();
    __syncthreads();                     // the chunk has landed

    // 1a. running sums of logw down each column of each sub-chunk
    float lc[kSub];
    const bool own = jc < dp && ja < nsub;
    if (own) {
      float run = 0.f;
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        float* x = W + (ja * kSub + q) * pd + jc;
        run += *x;
        lc[q] = run;
        *x = run;
      }
      tot[ja * dp + jc] = run;
    }
    __syncthreads();
    // 1b. the factors, rt and kh
    if (own) {
      float tt[4], pfx = 0.f, sfx = 0.f, all = 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        tt[a] = a < nsub ? tot[a * dp + jc] : 0.f;
        all += tt[a];
        if (a < ja) pfx += tt[a];
        if (a > ja) sfx += tt[a];
      }
      pre[ja * dp + jc] = expf(pfx);
      suf[ja * dp + jc] = expf(sfx);
      if (ja == 0) {
        etot[jc] = expf(all);
        mid[jc] = expf(tt[1]);
        mid[dp + jc] = expf(tt[2]);
        mid[2 * dp + jc] = expf(tt[1] + tt[2]);
      }
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        const int i = (ja * kSub + q) * pd + jc;
        RT[i] = R[i] * __expf(q ? lc[q - 1] : 0.f);
        KH[i] = K[i] * __expf(lc[kSub - 1] - lc[q]);
      }
    }
    __syncthreads();

    // 2. this warp's entries of its diagonal key tile, in its C fragment
    // (rows gq, gq + 8 of sub-chunk wa; keys 2 tq, 2 tq + 1 of the tile).
    // Tile 2 wa (wh 0) holds the upper-left 8 x 8 triangle of the diagonal
    // sub-block (rows gq) and its lower-left quadrant (rows gq + 8, every
    // key before them); tile 2 wa + 1 (wh 1) the lower-right triangle.
    // A triangle's 28 (row, key) pairs take one exp per (i, s, j), one
    // pair a lane (lanes 0-27), and its 8 bonus entries r_i . (u * k_i)
    // two a lane (lanes 28-31); shuffles then move each entry to the lane
    // that holds it in the C fragment. The quadrant is one more product,
    // split at the sub-chunk's 8th token: exp(lx_i - lc_s) =
    // exp(lx_i - lc_7) exp(lc_7 - lc_s), both exponents <= 0.
    float dg[4] = {0.f, 0.f, 0.f, 0.f};
    if (wa < nsub) {
      const int r0 = wa * kSub;
      const int t8 = r0 + 8 * wh;          // the triangle's first row
      float val = 0.f, bo2 = 0.f;
      if (lane < 28) {                     // pair (pi, ps), ps < pi
        int pi = 1;
        while ((pi + 1) * pi / 2 <= lane) ++pi;
        const int ps = lane - pi * (pi - 1) / 2;
        const float4* ri = (const float4*)(R + (t8 + pi) * pd);
        const float4* lx = (const float4*)(W + (t8 + pi - 1) * pd);
        const float4* ks = (const float4*)(K + (t8 + ps) * pd);
        const float4* ls = (const float4*)(W + (t8 + ps) * pd);
#pragma unroll
        for (int q = 0; q < kMaxD / 4; ++q) {
          if (q >= dp / 4) break;
          const float4 a = ri[q], x = lx[q], kb = ks[q], lb = ls[q];
          val += a.x * kb.x * __expf(x.x - lb.x) +
                 a.y * kb.y * __expf(x.y - lb.y) +
                 a.z * kb.z * __expf(x.z - lb.z) +
                 a.w * kb.w * __expf(x.w - lb.w);
        }
      } else {                             // bonus of rows 2m, 2m + 1
        const int m = lane - 28;
        const float4* u4 = (const float4*)us;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4* ri = (const float4*)(R + (t8 + 2 * m + e) * pd);
          const float4* ki = (const float4*)(K + (t8 + 2 * m + e) * pd);
          float bo = 0.f;
#pragma unroll
          for (int q = 0; q < kMaxD / 4; ++q) {
            if (q >= dp / 4) break;
            const float4 a = ri[q], kb = ki[q], uu = u4[q];
            bo += a.x * uu.x * kb.x + a.y * uu.y * kb.y +
                  a.z * uu.z * kb.z + a.w * uu.w * kb.w;
          }
          if (e == 0) val = bo; else bo2 = bo;
        }
      }
      // the C fragment's keys 2 tq + e of row gq (of the triangle)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int sk = 2 * tq + e;
        const int src = sk < gq ? gq * (gq - 1) / 2 + sk : 28 + (gq >> 1);
        const float pa = __shfl_sync(0xffffffffu, val, src);
        const float pb = __shfl_sync(0xffffffffu, bo2, src);
        dg[2 * wh + e] = sk < gq ? pa : sk == gq ? ((gq & 1) ? pb : pa) : 0.f;
      }
      if (wh == 0) {
        // the quadrant: rows 8 + gq (A rows gq are zero), keys gq
        const float* rq = R + (r0 + 8 + gq) * pd + tq;
        const float* xq = W + (r0 + 7 + gq) * pd + tq;   // lx of row 8 + gq
        const float* c7 = W + (r0 + 7) * pd + tq;
        const float* kq = K + (r0 + gq) * pd + tq;
        const float* lq = W + (r0 + gq) * pd + tq;
        float qd[4] = {0.f, 0.f, 0.f, 0.f}, ql[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kMaxD / 8; ++kk) {
          if (kk >= dp / 8) break;
          const int j = kk * 8;
          const float a[4] = {0.f, rq[j] * __expf(xq[j] - c7[j]), 0.f,
                              rq[j + 4] * __expf(xq[j + 4] - c7[j + 4])};
          const float bb[2] = {kq[j] * __expf(c7[j] - lq[j]),
                               kq[j + 4] * __expf(c7[j + 4] - lq[j + 4])};
          mma3(qd, ql, a, bb);
        }
        dg[2] = qd[2] + ql[2];
        dg[3] = qd[3] + ql[3];
      }
    }
    __syncthreads();                     // raw r, k and lc are free

    if (ci + 1 < n_chunks) {             // stage the next chunk meanwhile
      const int t1 = t0 + chunk;
      const int len1 = min(chunk, seq - t1);
      const int rows = (len1 + kSub - 1) & ~(kSub - 1);
      stage(R, pd, rb, rss, t1, len1, rows, d, vec_in);
      stage(K, pd, kb, kss, t1, len1, rows, d, vec_in);
      stage(W, pd, wb, wss, t1, len1, rows, d, vec_in);
      stage(V0 + ((ci + 1) & 1) * lmax * pv, pv, vb, vss, t1, len1, rows, cv,
            vec_v);
    }
    cp_commit();

    // 3. y of rows wa: (rt pre) S_in over every other k step, then att . v
    // over every other key tile
    float ya[NT][4], yl[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[n][e] = yl[n][e] = 0.f;
    if (wa < nsub) {
      const float* rt0 = RT + (wa * kSub + gq) * pd + tq;
      const float* pa = pre + wa * dp + tq;
#pragma unroll
      for (int k2 = 0; k2 < kMaxD / 16; ++k2) {
        const int kk = 2 * k2 + wh;
        if (kk >= dp / 8) break;
        const int j = kk * 8;
        const float a[4] = {rt0[j] * pa[j], rt0[8 * pd + j] * pa[j],
                            rt0[j + 4] * pa[j + 4],
                            rt0[8 * pd + j + 4] * pa[j + 4]};
        const float* sj = S + (j + tq) * pv + gq;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float bb[2] = {sj[n * 8], sj[4 * pv + n * 8]};
          mma3(ya[n], yl[n], a, bb);
        }
      }
      for (int st = wh; st <= 2 * wa + wh; st += 2) {
        float cf[4];
        if (st == 2 * wa + wh) {
#pragma unroll
          for (int e = 0; e < 4; ++e) cf[e] = dg[e];
        } else {
          // rows wa against keys of tile st (sub-chunk sb < wa)
          const int sb = st >> 1;
          const float* md = wa - sb == 2 ? mid + (sb == 0 ? 0 : dp)
                          : wa - sb == 3 ? mid + 2 * dp : nullptr;
          const float* kh = KH + (st * 8 + gq) * pd + tq;
          float cl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 4; ++e) cf[e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < kMaxD / 8; ++kk) {
            if (kk >= dp / 8) break;
            const int j = kk * 8;
            const float a[4] = {rt0[j], rt0[8 * pd + j], rt0[j + 4],
                                rt0[8 * pd + j + 4]};
            float bb[2] = {kh[j], kh[j + 4]};
            if (md) {
              bb[0] *= md[j + tq];
              bb[1] *= md[j + tq + 4];
            }
            mma3(cf, cl, a, bb);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) cf[e] += cl[e];
        }
        // the accumulator as an A fragment, keys permuted (column tq is
        // key 2 tq, column tq + 4 key 2 tq + 1); V's rows read the same way
        const float a[4] = {cf[0], cf[2], cf[1], cf[3]};
        const float* vr = Vc + (st * 8 + 2 * tq) * pv + gq;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float bb[2] = {vr[n * 8], vr[pv + n * 8]};
          mma3(ya[n], yl[n], a, bb);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ya[n][e] += yl[n][e];
      if (wh == 1) {
        float* yr = Y + (wa * kSub + gq) * pv + 2 * tq;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          yr[n * 8] = ya[n][0];
          yr[n * 8 + 1] = ya[n][1];
          yr[8 * pv + n * 8] = ya[n][2];
          yr[8 * pv + n * 8 + 1] = ya[n][3];
        }
      }
    }
    // the new state: tiles (16 rows of hd, 8 columns), round robin
    constexpr int kMaxTiles = (kMaxD / 16) * NT / kWarps > 0
                                  ? (kMaxD / 16) * NT / kWarps : 1;
    float sn[kMaxTiles][4];
    const int n_tiles = (dp / 16) * NT;
#pragma unroll
    for (int q = 0; q < kMaxTiles; ++q) {
      const int tile = warp + q * kWarps;
      if (tile >= n_tiles) continue;
      const int m = tile / NT;
      const int n = tile - m * NT;
      const int j0 = m * 16 + gq;
      const float* sr = S + j0 * pv + n * 8 + 2 * tq;
      sn[q][0] = sr[0] * etot[j0];
      sn[q][1] = sr[1] * etot[j0];
      sn[q][2] = sr[8 * pv] * etot[j0 + 8];
      sn[q][3] = sr[8 * pv + 1] * etot[j0 + 8];
      float lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kMaxC / 8; ++kk) {
        if (kk >= 2 * nsub) break;
        const int s = kk * 8 + tq;
        const float* f = suf + (kk >> 1) * dp + j0;
        const float* kh = KH + s * pd + j0;
        const float a[4] = {kh[0] * f[0], kh[8] * f[8], kh[4 * pd] * f[0],
                            kh[4 * pd + 8] * f[8]};
        const float* vr = Vc + s * pv + n * 8 + gq;
        const float bb[2] = {vr[0], vr[4 * pv]};
        mma3(sn[q], lo, a, bb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sn[q][e] += lo[e];
    }
    __syncthreads();                     // y halves and S_in reads done
    if (wa < nsub && wh == 0) {
      const float* yr = Y + (wa * kSub + gq) * pv + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = wa * kSub + gq + 8 * half;
        if (i < len) {
          TI* yt = yb + (int64_t)(t0 + i) * yss;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int c = n * 8 + 2 * tq;
            if (c < cv)
              st_out(yt + c, ya[n][2 * half] + yr[8 * half * pv + n * 8]);
            if (c + 1 < cv)
              st_out(yt + c + 1,
                 ya[n][2 * half + 1] + yr[8 * half * pv + n * 8 + 1]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxTiles; ++q) {
      const int tile = warp + q * kWarps;
      if (tile >= n_tiles) continue;
      const int m = tile / NT;
      const int n = tile - m * NT;
      float* sr = S + (m * 16 + gq) * pv + n * 8 + 2 * tq;
      sr[0] = sn[q][0];
      sr[1] = sn[q][1];
      sr[8 * pv] = sn[q][2];
      sr[8 * pv + 1] = sn[q][3];
    }
  }
  __syncthreads();
  for (int i = tid; i < d * cv; i += kThreads) {
    const int j = i / cv;
    const int c = i - j * cv;
    s_out[soff + (int64_t)j * d + c0 + c] = S[j * pv + c];
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename TI>
using Prefill = void (*)(const TI*, const TI*, const TI*, const TI*,
                         const void*, int, const float*, TI*, float*, int,
                         int, int, int, int, int64_t, int64_t, int64_t,
                         int64_t, int64_t, int64_t, int64_t, int64_t,
                         int64_t, int64_t, int64_t, int64_t, int64_t,
                         int64_t, int64_t, int, int);

template <typename TI>
Prefill<TI> prefill_for(int nt) {
  switch (nt) {
    case 1: return prefill_kernel<TI, 1>;
    case 2: return prefill_kernel<TI, 2>;
    case 4: return prefill_kernel<TI, 4>;
    default: return prefill_kernel<TI, 8>;
  }
}

// the prefill kernel of input type code `type` and nt tiles
const void* prefill_fn(int type, int nt) {
  return type == kBF16  ? (const void*)prefill_for<__nv_bfloat16>(nt)
         : type == kF16 ? (const void*)prefill_for<__half>(nt)
                        : (const void*)prefill_for<float>(nt);
}

// the prefill grid's column blocks: doubled while the slice stays a
// multiple of 8 columns and the grid within kBlocksPerSm blocks an SM
// (kernel.py rwkv6_n_col is the same rule)
int pick_cols(int bh, int dp, int sms) {
  int n = 1;
  while (n < 8 && (dp / (2 * n)) % 8 == 0 &&
         (int64_t)bh * 2 * n <= (int64_t)kBlocksPerSm * sms)
    n *= 2;
  return n;
}

size_t configured[kMaxDevices][3][4] = {};

cudaError_t configure(int type, int nt, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const int slot = nt == 1 ? 0 : nt == 2 ? 1 : nt == 4 ? 2 : 3;
  if (smem <= configured[dev][type][slot]) return cudaSuccess;
  err = cudaFuncSetAttribute(prefill_fn(type, nt),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) configured[dev][type][slot] = smem;
  return err;
}

// rows of 4 elements of `size` bytes each, aligned to 4 * size: the
// 16-byte (fp32) or 8-byte (16-bit) accesses
bool rows_aligned4(const void* p, int64_t sb, int64_t ss, int64_t sh, int d,
                   int size) {
  return (uintptr_t)p % (4 * size) == 0 && d % 4 == 0 && sb % 4 == 0 &&
         ss % 4 == 0 && sh % 4 == 0;
}

template <typename TI>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, int u_type,
                   const void* s0, void* y, void* s_out, int b, int seq,
                   int h, int d, int chunk, int64_t rsb, int64_t rss,
                   int64_t rsh, int64_t ksb, int64_t kss, int64_t ksh,
                   int64_t vsb, int64_t vss, int64_t vsh, int64_t wsb,
                   int64_t wss, int64_t wsh, int64_t ysb, int64_t yss,
                   int64_t ysh, cudaStream_t st) {
  constexpr bool k16 = sizeof(TI) == 2;
  constexpr int kType = std::is_same<TI, __nv_bfloat16>::value ? kBF16
                        : k16                                    ? kF16
                                                                 : kF32;
  constexpr int kSize = (int)sizeof(TI);
  if (seq <= kDecodeMax) {
    // 16-bit y is stored a value at a time, so only the state asks 16 bytes
    const bool vec = d % 4 == 0 && (uintptr_t)s_out % 16 == 0 &&
                     (s0 == nullptr || (uintptr_t)s0 % 16 == 0) &&
                     (k16 || rows_aligned4(y, ysb, yss, ysh, d, kSize));
    const int wcols = vec ? 16 : 4;
    dim3 grid(h, b, (d + wcols - 1) / wcols);
    if (vec)
      decode_kernel<TI, 4><<<grid, 32, 0, st>>>(
          (const TI*)r, (const TI*)k, (const TI*)v, (const TI*)logw, u,
          u_type, (const float*)s0, (TI*)y, (float*)s_out, seq, h, d, rsb,
          rss, rsh, ksb, kss, ksh, vsb, vss, vsh, wsb, wss, wsh, ysb, yss,
          ysh);
    else
      decode_kernel<TI, 1><<<grid, 32, 0, st>>>(
          (const TI*)r, (const TI*)k, (const TI*)v, (const TI*)logw, u,
          u_type, (const float*)s0, (TI*)y, (float*)s_out, seq, h, d, rsb,
          rss, rsh, ksb, kss, ksh, vsb, vss, vsh, wsb, wss, wsh, ysb, yss,
          ysh);
    return cudaGetLastError();
  }
  const int dp = padded_dim(d);
  const int n_col = pick_cols(b * h, dp, sm_count());
  const Geo geo = geometry(d, seq, chunk, n_col);
  const int nt = geo.cw / 8;
  const size_t smem = sizeof(float) * geo.floats;
  cudaError_t err = configure(kType, nt, smem);
  if (err != cudaSuccess) return err;
  const int vec_in = rows_aligned4(r, rsb, rss, rsh, d, kSize) &&
                     rows_aligned4(k, ksb, kss, ksh, d, kSize) &&
                     rows_aligned4(logw, wsb, wss, wsh, d, kSize);
  const int vec_v = rows_aligned4(v, vsb, vss, vsh, d, kSize);
  prefill_for<TI>(nt)<<<dim3(h, b, n_col), kThreads, smem, st>>>(
      (const TI*)r, (const TI*)k, (const TI*)v, (const TI*)logw, u, u_type,
      (const float*)s0, (TI*)y, (float*)s_out, seq, h, d, chunk, n_col, rsb,
      rss, rsh, ksb, kss, ksh, vsb, vss, vsh, wsb, wss, wsh, ysb, yss, ysh,
      vec_in, vec_v);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v, logw (b, seq, h, d) with (batch, sequence, head) strides in
// elements and d contiguous; u (h, d); s0 (b, h, d, d) or null; y
// (b, seq, h, d) strided like the inputs; s_out (b, h, d, d). r, k, v,
// logw and y of type code in_type (0 fp32, 1 bf16, 2 fp16); u of type code
// u_type; s0 and s_out fp32.
int rwkv6_scan(const void* r, const void* k, const void* v, const void* logw,
               const void* u, const void* s0, void* y, void* s_out, int b,
               int seq, int h, int d, int chunk, int64_t rsb, int64_t rss,
               int64_t rsh, int64_t ksb, int64_t kss, int64_t ksh,
               int64_t vsb, int64_t vss, int64_t vsh, int64_t wsb,
               int64_t wss, int64_t wsh, int64_t ysb, int64_t yss,
               int64_t ysh, int in_type, int u_type, void* stream) {
  if (d <= 0 || d > kMaxD || chunk <= 0 || chunk > kMaxC || seq < 0 ||
      in_type < kF32 || in_type > kF16 || u_type < kF32 || u_type > kF16)
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || h <= 0) return (int)cudaGetLastError();
  if (b > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto go = [&](auto tag) {
    using TI = decltype(tag);
    return launch<TI>(r, k, v, logw, u, u_type, s0, y, s_out, b, seq, h, d,
                      chunk, rsb, rss, rsh, ksb, kss, ksh, vsb, vss, vsh, wsb,
                      wss, wsh, ysb, yss, ysh, st);
  };
  return (int)(in_type == kBF16  ? go(__nv_bfloat16{})
               : in_type == kF16 ? go(__half{})
                                 : go(0.f));
}

// What rwkv6_scan launches for these shapes (on the current device, with
// 16-byte access; the 16-bit forms' with in_type 1 or 2): info[0] schedule
// (0 decode, 1 prefill), [1] column blocks a (batch, head), [2] blocks in
// the grid, [3] threads per block, [4] registers per thread, [5] static and
// [6] dynamic shared memory per block (bytes), [7] blocks resident per SM.
int rwkv6_scan_info(int b, int seq, int h, int d, int chunk, int in_type,
                    int* info) {
  if (d <= 0 || d > kMaxD || chunk <= 0 || chunk > kMaxC || seq < 0 ||
      b <= 0 || h <= 0 || in_type < kF32 || in_type > kF16)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err;
  int per_sm = 0;
  if (seq <= kDecodeMax) {
    const bool vec = d % 4 == 0;
    const void* fn =
        in_type == kBF16
            ? (vec ? (const void*)decode_kernel<__nv_bfloat16, 4>
                   : (const void*)decode_kernel<__nv_bfloat16, 1>)
        : in_type == kF16 ? (vec ? (const void*)decode_kernel<__half, 4>
                                 : (const void*)decode_kernel<__half, 1>)
                          : (vec ? (const void*)decode_kernel<float, 4>
                                 : (const void*)decode_kernel<float, 1>);
    err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 32, 0);
    if (err != cudaSuccess) return (int)err;
    const int cols = (d + (vec ? 16 : 4) - 1) / (vec ? 16 : 4);
    info[0] = 0;
    info[1] = cols;
    info[2] = b * h * cols;
    info[3] = 32;
    info[6] = 0;
  } else {
    const int dp = padded_dim(d);
    const int n_col = pick_cols(b * h, dp, sm_count());
    const Geo geo = geometry(d, seq, chunk, n_col);
    const size_t smem = sizeof(float) * geo.floats;
    const int nt = geo.cw / 8;
    err = configure(in_type, nt, smem);
    if (err != cudaSuccess) return (int)err;
    const void* fn = prefill_fn(in_type, nt);
    err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    info[0] = 1;
    info[1] = n_col;
    info[2] = b * h * n_col;
    info[3] = kThreads;
    info[6] = (int)smem;
  }
  info[4] = a.numRegs;
  info[5] = (int)a.sharedSizeBytes;
  info[7] = per_sm;
  return 0;
}

}  // extern "C"
