// flash_attention: causal attention forward with a sliding window, a tanh
// logit cap and GQA, written for Hopper (sm_90a), with a plain C interface
// loaded by ctypes (kernels/_build.py, wrapper in
// kernels/flash_attention/kernel.py).
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd (body _kernel). q (B, H, Sq, hd), k and v
// (B, KV, Sk, hd) -> out (B, H, Sq, hd); query head hh reads KV head
// hh / (H / KV). Positions are suffix-aligned: query row i sits at
// i + Sk - Sq. Key j is visible to query position p when j <= p (causal)
// and j > p - window (window > 0). Logits are q.k * scale, then tanh-capped,
// then masked; the softmax is online in fp32; out = acc / max(l, 1e-30).
// Every tensor is addressed through (batch, head, sequence) strides with
// the head dimension contiguous, so the model layout (B, S, H, hd) is read
// and written in place, without a transposing copy.
//
// The TPU wrapper halves its block until it divides the sequence, down to
// one row for an odd length. Here the tiles are fixed and the ragged last
// query and key tiles are masked instead: the same function for any length.
//
// Bound on an H100 SXM: at the serving path's prefill (B 1, Sq = Sk = 100 to
// 1000, H 8, KV 4, hd 256) the causal work is about 4 * hd * H * Sq^2 / 2
// flops against (2 Sq H + 2 Sk KV) * hd * 4 bytes, i.e. hundreds of flops
// per byte: the fp32 rate bounds it (67 TFLOP/s outside the tensor cores;
// the kernel must compute in fp32 to hold the port's 1e-4 tolerance, so
// TF32 tensor cores are not used).
//
// Tiles. A query tile of BQ = 32 rows and key/value tiles of BK = 32 rows.
// At hd 256 in fp32 a 64-row tile is 64 KiB; Q (32 x 257, padded against
// bank conflicts), K (32 x 257), V (32 x 256) and the probability tile
// (32 x 32) take 100 KiB of the 227 KiB a block may use, which leaves room
// for two blocks per SM. 32-row query tiles also make 8 x ceil(Sq / 32)
// blocks per prompt (144 at Sq = 550), enough to cover the 132 SMs where
// 64-row tiles would leave half of them idle. 256 threads: eight per query
// row; thread (r, c) owns logits at key columns c + 8i (i < 4) and output
// columns c + 8j (j < hd / 8, at most 32 fp32 registers, so hd <= 256).
// Key tiles wholly outside the causal band or the window are never loaded:
// the loop runs only over the tiles the query tile can see.
//
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kCols = kThreads / kBQ;   // threads per query row (8)
constexpr int kPerThreadK = kBK / kCols;  // logits per thread per tile (4)
constexpr int kMaxD = 256;
constexpr int kRegs = kMaxD / kCols;    // output columns per thread (32)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float group_max(float x) {
  for (int o = 1; o < kCols; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  for (int o = 1; o < kCols; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int h,
             int kv, int sq, int sk, int d, int64_t qsb, int64_t qsh,
             int64_t qss, int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
             int64_t vsh, int64_t vss, int64_t osb, int64_t osh, int64_t oss,
             int causal, int window, float scale, float cap) {
  extern __shared__ float smem[];
  const int dp = d + 1;                 // padded row of Q and K tiles
  float* qs = smem;                     // (BQ, d + 1)
  float* ks = qs + kBQ * dp;            // (BK, d + 1)
  float* vs = ks + kBK * dp;            // (BK, d)
  float* ps = vs + kBK * d;             // (BQ, BK)
  const int q0 = blockIdx.x * kBQ;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = hh / (h / kv);
  const int tid = threadIdx.x;
  const int r = tid / kCols;
  const int cg = tid % kCols;

  const float* qb = q + (int64_t)b * qsb + (int64_t)hh * qsh;
  const float* kb = k + (int64_t)b * ksb + (int64_t)kh * ksh;
  const float* vb = v + (int64_t)b * vsb + (int64_t)kh * vsh;
  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int row = i / d;
    const int c = i - row * d;
    qs[row * dp + c] = q0 + row < sq ? qb[(int64_t)(q0 + row) * qss + c] : 0.f;
  }

  const int off = sk - sq;              // suffix alignment
  const int my_pos = q0 + r + off;
  const int last_row = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, last_row + off + 1) : sk;
  const int k_begin = window > 0 ? max(0, q0 + off - window + 1) : 0;

  float acc[kRegs];
#pragma unroll
  for (int j = 0; j < kRegs; ++j) acc[j] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();                    // the previous tile's readers are done
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int row = i / d;
      const int c = i - row * d;
      const bool in = k0 + row < sk;
      ks[row * dp + c] = in ? kb[(int64_t)(k0 + row) * kss + c] : 0.f;
      vs[row * d + c] = in ? vb[(int64_t)(k0 + row) * vss + c] : 0.f;
    }
    __syncthreads();
    float s[kPerThreadK];
    bool ok[kPerThreadK];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kPerThreadK; ++i) {
      const int col = cg + kCols * i;
      const float* qr = qs + r * dp;
      const float* kr = ks + col * dp;
      float dot = 0.f;
      for (int c = 0; c < d; ++c) dot += qr[c] * kr[c];
      float sc = dot * scale;
      if (cap > 0.f) sc = tanhf(sc / cap) * cap;
      const int kpos = k0 + col;
      bool valid = kpos < sk;
      if (causal) valid = valid && kpos <= my_pos;
      if (window > 0) valid = valid && kpos > my_pos - window;
      ok[i] = valid;
      s[i] = valid ? sc : kNegInf;
      mx = fmaxf(mx, s[i]);
    }
    mx = group_max(mx);
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPerThreadK; ++i) {
      const float p = ok[i] ? expf(s[i] - m_new) : 0.f;
      ps[r * kBK + cg + kCols * i] = p;
      sum += p;
    }
    sum = group_sum(sum);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();                       // a row's probabilities: one warp
    const float* pr = ps + r * kBK;
#pragma unroll
    for (int j = 0; j < kRegs; ++j) {
      const int c = cg + kCols * j;
      if (c < d) {
        float a = acc[j] * corr;
        for (int t = 0; t < kBK; ++t) a += pr[t] * vs[t * d + c];
        acc[j] = a;
      }
    }
  }
  if (q0 + r < sq) {
    float* orow = out + (int64_t)b * osb + (int64_t)hh * osh +
                  (int64_t)(q0 + r) * oss;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < kRegs; ++j) {
      const int c = cg + kCols * j;
      if (c < d) orow[c] = acc[j] / den;
    }
  }
}

}  // namespace

extern "C" {

// q (b, h, sq, d), k and v (b, kv, sk, d), out (b, h, sq, d), all f32 with
// the last dimension contiguous and the other three strided (elements).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int b, int h, int kv, int sq, int sk, int d, int64_t qsb,
                    int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,
                    int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
                    int64_t osb, int64_t osh, int64_t oss, int causal,
                    int window, float scale, float cap, void* stream) {
  if (d <= 0 || d > kMaxD || kv <= 0 || h % kv != 0)
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || sq <= 0) return (int)cudaGetLastError();
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + kBK) * (d + 1) + (size_t)kBK * d +
                       (size_t)kBQ * kBK);
  // raise the dynamic shared-memory limit only when a larger size is
  // first asked for, so launches captured in a CUDA graph make no such call
  static size_t configured = 0;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, h, kv,
      sq, sk, d, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
      causal, window, scale, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
