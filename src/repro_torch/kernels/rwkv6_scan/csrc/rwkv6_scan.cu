// rwkv6_scan: the RWKV-6 (Finch) recurrence with data-dependent decay,
// written for Hopper (sm_90a), with a plain C interface loaded by ctypes
// (kernels/_build.py, wrapper in kernels/rwkv6_scan/kernel.py).
//
// Replaces the Pallas kernel repro/kernels/rwkv6_scan/kernel.py::
// rwkv6_scan_fwd (body _kernel). r, k, v, logw (B, S, H, hd) and u (H, hd)
// -> y (B, S, H, hd) and the final state (B, H, hd, hd), all fp32:
//   y_t = r_t (S_{t-1} + (u * k_t)^T v_t),
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t,
// from S_0 = s0, or zeros when s0 is null (as the TPU kernel starts).
// r, k, v, logw and y are addressed through (batch, sequence, head) strides
// with hd contiguous, so the model layout is read in place; s0, the final
// state and u are contiguous. s0 and s_out may be the same buffer: a block
// reads its own state slice before it writes it.
//
// Schedule. One thread block per (batch, head) walks the sequence in chunks
// of at most `chunk` (<= 64) tokens; the ragged last chunk is simply
// shorter. The TPU wrapper halves its chunk until it divides S (down to one
// token for a prime S); here any S takes full chunks. Within a chunk the
// TPU kernel's quadratic form, with cum the inclusive and cex the exclusive
// running sum of logw inside the chunk:
//   y_i  = (r_i * exp(cex_i)) S_in                           inter-chunk
//        + sum_{s<i} [sum_k r_ik k_sk exp(cex_ik - cum_sk)] v_s   intra
//        + (r_i . (u * k_i)) v_i                              bonus
//   S_out = diag(exp(cum_L)) S_in + sum_s (k_s * exp(cum_L - cum_s))^T v_s.
// Decay factors are taken pairwise, exp(cex_i - cum_s) and
// exp(cum_L - cum_s): their exponents are sums of log decays and never
// positive, so no factor overflows whatever the chunk's total decay. (The
// reference splits them as exp(cex_i) * exp(-cum_s), whose second factor
// overflows fp32 once a chunk's decay sums below -88.) The price is one
// exp per (i, s, k) of the intra-chunk term instead of one per (s, k).
//
// Shared memory (fp32, pitch hd + 1 against bank conflicts where a warp
// walks rows): the chunk's r, k, v, cum and cex tiles (5 x 64 x 65), the
// (chunk x chunk) intra-chunk matrix and the hd x hd state: 116 KiB at
// hd 64, so one block per SM plus room for a second. 256 threads; each
// product loops over its output elements with the thread index fastest
// along the contiguous dimension.
//
// Bound on an H100 SXM: per (b, h) and token the work is about 2 hd^2
// flops for the state (inter-chunk read and update) plus 2 C hd for the
// intra-chunk form, against 5 hd * 4 bytes of r, k, v, logw and y. At
// hd 64 and C 64 that is about 80 flops per byte, above fp32's 20 flops
// per byte on this card (67 TFLOP/s over 3.35 TB/s): the fp32 rate bounds
// it at prefill. At decode (S = 1) the state read and written, 2 hd^2 * 4
// bytes against 4 hd^2 flops, makes it bound by bytes. This first version
// uses one block per (b, h) (40 blocks at the serving path's prefill, so
// most SMs idle) and no tensor cores: speed is later work.
//
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 64;
constexpr int kMaxC = 64;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
rwkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* s0,
             float* __restrict__ y, float* s_out, int seq, int h, int d,
             int chunk, int64_t rsb, int64_t rss, int64_t rsh, int64_t ksb,
             int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
             int64_t wsb, int64_t wss, int64_t wsh, int64_t ysb, int64_t yss,
             int64_t ysh) {
  extern __shared__ float smem[];
  const int dp = d + 1;                 // padded row pitch of the tiles
  const int cp = chunk + 1;             // padded row pitch of att
  float* rs = smem;                     // (C, d + 1): r, then r * exp(cex)
  float* ks = rs + chunk * dp;          // (C, d + 1): k, then decayed k
  float* vs = ks + chunk * dp;          // (C, d + 1)
  float* cum = vs + chunk * dp;         // (C, d + 1): inclusive log decay
  float* cex = cum + chunk * dp;        // (C, d + 1): exclusive log decay
  float* att = cex + chunk * dp;        // (C, C + 1)
  float* st = att + chunk * cp;         // (d, d): the carried state
  float* us = st + d * d;               // (d)

  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int dd = d * d;
  const int64_t soff = ((int64_t)b * h + hh) * dd;

  for (int i = tid; i < dd; i += kThreads) st[i] = s0 ? s0[soff + i] : 0.f;
  for (int i = tid; i < d; i += kThreads) us[i] = u[(int64_t)hh * d + i];

  const float* rb = r + (int64_t)b * rsb + (int64_t)hh * rsh;
  const float* kb = k + (int64_t)b * ksb + (int64_t)hh * ksh;
  const float* vb = v + (int64_t)b * vsb + (int64_t)hh * vsh;
  const float* wb = w + (int64_t)b * wsb + (int64_t)hh * wsh;
  float* yb = y + (int64_t)b * ysb + (int64_t)hh * ysh;

  for (int t0 = 0; t0 < seq; t0 += chunk) {
    const int len = min(chunk, seq - t0);
    const int n = len * d;
    __syncthreads();                    // the previous chunk's readers are done
    for (int i = tid; i < n; i += kThreads) {
      const int t = i / d;
      const int c = i - t * d;
      const int64_t tt = t0 + t;
      rs[t * dp + c] = rb[tt * rss + c];
      ks[t * dp + c] = kb[tt * kss + c];
      vs[t * dp + c] = vb[tt * vss + c];
      cum[t * dp + c] = wb[tt * wss + c];
    }
    __syncthreads();
    // running sums of the log decay down each column
    for (int c = tid; c < d; c += kThreads) {
      float run = 0.f;
      for (int t = 0; t < len; ++t) {
        cex[t * dp + c] = run;
        run += cum[t * dp + c];
        cum[t * dp + c] = run;
      }
    }
    __syncthreads();
    // intra-chunk matrix: strictly lower part with pairwise decay, the
    // bonus on the diagonal
    for (int i = tid; i < len * len; i += kThreads) {
      const int row = i / len;
      const int s = i - row * len;
      float a = 0.f;
      if (s < row) {
        const float* rr = rs + row * dp;
        const float* ce = cex + row * dp;
        const float* kr = ks + s * dp;
        const float* cs = cum + s * dp;
        for (int c = 0; c < d; ++c)
          a += rr[c] * kr[c] * expf(ce[c] - cs[c]);
      } else if (s == row) {
        const float* rr = rs + row * dp;
        const float* kr = ks + s * dp;
        for (int c = 0; c < d; ++c) a += rr[c] * us[c] * kr[c];
      }
      att[row * cp + s] = a;
    }
    __syncthreads();
    // r decayed to the chunk's start, k decayed to its end
    const float* last = cum + (len - 1) * dp;
    for (int i = tid; i < n; i += kThreads) {
      const int t = i / d;
      const int c = i - t * d;
      rs[t * dp + c] *= expf(cex[t * dp + c]);
      ks[t * dp + c] *= expf(last[c] - cum[t * dp + c]);
    }
    __syncthreads();
    // y = r_dec S_in + att v
    for (int i = tid; i < n; i += kThreads) {
      const int t = i / d;
      const int c = i - t * d;
      const float* rr = rs + t * dp;
      float acc = 0.f;
      for (int j = 0; j < d; ++j) acc += rr[j] * st[j * d + c];
      const float* ar = att + t * cp;
      for (int s = 0; s <= t; ++s) acc += ar[s] * vs[s * dp + c];
      yb[(int64_t)(t0 + t) * yss + c] = acc;
    }
    __syncthreads();                    // every reader of S_in is done
    // S_out = diag(exp(cum_L)) S_in + k_dec^T v
    for (int i = tid; i < dd; i += kThreads) {
      const int row = i / d;
      const int c = i - row * d;
      float acc = expf(last[row]) * st[i];
      for (int s = 0; s < len; ++s) acc += ks[s * dp + row] * vs[s * dp + c];
      st[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < dd; i += kThreads) s_out[soff + i] = st[i];
}

}  // namespace

extern "C" {

// r, k, v, logw (b, seq, h, d) with (batch, sequence, head) strides in
// elements and d contiguous; u (h, d); s0 (b, h, d, d) or null; y
// (b, seq, h, d) strided like the inputs; s_out (b, h, d, d). All f32.
int rwkv6_scan(const void* r, const void* k, const void* v, const void* logw,
               const void* u, const void* s0, void* y, void* s_out, int b,
               int seq, int h, int d, int chunk, int64_t rsb, int64_t rss,
               int64_t rsh, int64_t ksb, int64_t kss, int64_t ksh,
               int64_t vsb, int64_t vss, int64_t vsh, int64_t wsb,
               int64_t wss, int64_t wsh, int64_t ysb, int64_t yss,
               int64_t ysh, void* stream) {
  if (d <= 0 || d > kMaxD || chunk <= 0 || chunk > kMaxC || seq < 0)
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || h <= 0) return (int)cudaGetLastError();
  const size_t smem =
      sizeof(float) * (5 * (size_t)chunk * (d + 1) +
                       (size_t)chunk * (chunk + 1) + (size_t)d * d + d);
  // raise the dynamic shared-memory limit only when a larger size is
  // first asked for on this device (the attribute is kept per device), so
  // launches captured in a CUDA graph make no such call
  static size_t configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(
        rwkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = smem;
  }
  dim3 grid(h, b);
  rwkv6_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)logw,
      (const float*)u, (const float*)s0, (float*)y, (float*)s_out, seq, h, d,
      chunk, rsb, rss, rsh, ksb, kss, ksh, vsb, vss, vsh, wsb, wss, wsh, ysb,
      yss, ysh);
  return (int)cudaGetLastError();
}

}  // extern "C"
