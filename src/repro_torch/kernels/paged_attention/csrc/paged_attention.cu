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
// position; the softmax is online in fp32 (running max m, sum l, and an
// accumulator rescaled by exp(m_prev - m_new) per page); the output is
// acc / max(l, 1e-30), so a lane with no live page returns zeros.
//
// Bound on an H100 SXM: bytes. Each live page's K and V rows of one KV head
// are read once (2 * page * hd * 4 bytes), q and the output once; the
// arithmetic is 4 * g * hd flops per position, far below the fp32 rate.
// At the serving path's widths (8 sequences, 4 KV heads, hd 256, page 32)
// a decode step reads about 1 MiB of K/V per 128 cached tokens.
//
// Design (simple and correct first). One thread block of 256 threads per
// (sequence, KV head) walks the sequence's block-table row in order. The g
// query rows of the KV head's group (GQA) stay in shared memory with their
// m, l and accumulator; each live page's K and V (page x hd fp32: 32 KiB
// each at page 32, hd 256) are staged in shared memory with coalesced
// loads along hd, then one warp per (query row, position) forms a logit
// with a shuffle reduction, one warp per query row updates the softmax
// state, and each thread rescales and accumulates its own accumulator
// elements. Shared memory is page*(hd+hd_v) + g*(hd+page+hd_v) + 3g floats
// (about 70 KiB at the serving widths), set as dynamic shared memory. No
// split over pages yet: a later PR can split long rows across blocks and
// merge the partials (models/attention.py merge_partials) to fill more SMs.
//
// Offsets are 64-bit: an engine pool holds up to ~2^30 floats.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void __launch_bounds__(kThreads)
paged_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ table,
             const int* __restrict__ lengths, float* __restrict__ out, int h,
             int kv, int d, int dv, int p_max, int page, int n_rows,
             int64_t k_row, int64_t k_tok, int64_t v_row, int64_t v_tok,
             int window, float scale, float cap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int g = h / kv;
  float* ks = smem;                 // (page, d)
  float* vs = ks + page * d;        // (page, dv)
  float* qs = vs + page * dv;       // (g, d)
  float* ss = qs + g * d;           // (g, page) logits, then probabilities
  float* acc = ss + g * page;       // (g, dv)
  float* ms = acc + g * dv;         // (g,) running max
  float* ls = ms + g;               // (g,) running sum
  float* cs = ls + g;               // (g,) this page's rescale factor
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const float* qb = q + ((int64_t)b * h + (int64_t)kh * g) * d;
  for (int i = tid; i < g * d; i += kThreads) qs[i] = qb[i];
  for (int i = tid; i < g * dv; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < g; i += kThreads) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }
  __syncthreads();

  const int length = lengths[b];
  const int* trow = table + (int64_t)b * p_max;
  for (int ip = 0; ip < p_max; ++ip) {
    const int base = ip * page;
    const int ext = trow[ip];
    bool run = base < length && ext >= 0 && ext < n_rows;
    if (window > 0) run = run && (base + page - 1) > (length - 1 - window);
    if (!run) continue;  // the same decision in every thread of the block
    __syncthreads();     // the previous page's readers of ks/vs/ss are done
    const float* kp = k + (int64_t)ext * k_row + (int64_t)kh * d;
    const float* vp = v + (int64_t)ext * v_row + (int64_t)kh * dv;
    for (int i = tid; i < page * d; i += kThreads) {
      const int t = i / d;
      ks[i] = kp[(int64_t)t * k_tok + (i - t * d)];
    }
    for (int i = tid; i < page * dv; i += kThreads) {
      const int t = i / dv;
      vs[i] = vp[(int64_t)t * v_tok + (i - t * dv)];
    }
    __syncthreads();
    for (int pr = warp; pr < g * page; pr += kWarps) {
      const int r = pr / page;
      const int t = pr - r * page;
      float dot = 0.f;
      for (int c = lane; c < d; c += 32) dot += qs[r * d + c] * ks[t * d + c];
      dot = warp_sum(dot);
      if (lane == 0) {
        float s = dot * scale;
        if (cap > 0.f) s = tanhf(s / cap) * cap;
        ss[pr] = s;
      }
    }
    __syncthreads();
    for (int r = warp; r < g; r += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) {
        const int pos = base + t;
        bool valid = pos < length;
        if (window > 0) valid = valid && pos > (length - 1 - window);
        if (valid) mx = fmaxf(mx, ss[r * page + t]);
      }
      mx = warp_max(mx);
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const int pos = base + t;
        bool valid = pos < length;
        if (window > 0) valid = valid && pos > (length - 1 - window);
        const float p = valid ? expf(ss[r * page + t] - m_new) : 0.f;
        ss[r * page + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
        cs[r] = corr;
      }
    }
    __syncthreads();
    for (int i = tid; i < g * dv; i += kThreads) {
      const int r = i / dv;
      const int c = i - r * dv;
      const float* pr = ss + r * page;
      float a = acc[i] * cs[r];
      for (int t = 0; t < page; ++t) a += pr[t] * vs[t * dv + c];
      acc[i] = a;  // each element is owned by one thread throughout
    }
  }
  __syncthreads();
  float* ob = out + ((int64_t)b * h + (int64_t)kh * g) * dv;
  for (int i = tid; i < g * dv; i += kThreads)
    ob[i] = acc[i] / fmaxf(ls[i / dv], 1e-30f);
}

}  // namespace

extern "C" {

// q (b, h, d) f32 contiguous; k, v: base pointers of the K and V planes,
// each with its row (extent) and token strides in elements, head stride d
// (K) / dv (V);
// table (b, p_max) i32; lengths (b,) i32; out (b, h, dv) f32 contiguous.
int paged_attention(const void* q, const void* k, const void* v,
                    const void* table, const void* lengths, void* out, int b,
                    int h, int kv, int d, int dv, int p_max, int page,
                    int n_rows, int64_t k_row, int64_t k_tok, int64_t v_row,
                    int64_t v_tok, int window, float scale, float cap,
                    void* stream) {
  if (kv <= 0 || h % kv != 0 || d <= 0 || dv <= 0 || page <= 0)
    return (int)cudaErrorInvalidValue;
  if (b <= 0) return (int)cudaGetLastError();
  const int g = h / kv;
  const size_t smem = sizeof(float) * ((size_t)page * (d + dv) +
                                       (size_t)g * (d + page + dv) + 3 * g);
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
        paged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = smem;
  }
  dim3 grid(b, kv);
  paged_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)table,
      (const int*)lengths, (float*)out, h, kv, d, dv, p_max, page, n_rows,
      k_row, k_tok, v_row, v_tok, window, scale, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
