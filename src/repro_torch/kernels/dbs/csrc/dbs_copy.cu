// dbs_copy: the DBS copy-on-write extent copy, written for Hopper (sm_90a),
// with a plain C interface loaded by ctypes (kernels/_build.py, wrapper in
// kernels/dbs/copy_kernel.py).
//
// Replaces the Pallas kernel repro/kernels/dbs/copy_kernel.py::dbs_copy
// (body _kernel): pool[dst[i]] = pool[src[i]] for every lane with mask[i],
// in place, on an (n_rows, page, d) fp32 pool.
//
// Bound on an H100 SXM (3.35 TB/s HBM): pure data movement, so bytes bound
// it. A copied lane reads and writes one whole extent row (page * d * 4
// bytes each way). At the block device's width (page 32, d 4096) a row is
// 512 KiB and a batch of 64 CoW lanes moves 64 MiB, about 20 us of HBM
// time; on the serving baseline at gemma2-2b (page 32, d 4 * 256) a row is
// 128 KiB.
//
// What the simple design does about it. One thread block per (chunk of a
// row, lane): 256 threads, each loading eight 16-byte float4 values before
// storing them, so a block moves 32 KiB and has 2048 loads in flight, and a
// 512 KiB row spreads over 16 blocks (a 64-lane batch fills 1024 blocks on
// 132 SMs). float4 when d % 4 == 0 and the pool is 16-byte aligned (the
// wrapper decides), scalar otherwise.
//
// Masked lanes. The TPU kernel rewrites a masked lane's destination with its
// own contents, and its non-pool wrapper clamps dst = -1 to extent 0: that
// is harmless only because Pallas runs the grid in order. Here blocks run
// concurrently, so a masked lane would race a live lane that copies into
// the same row. A masked lane therefore returns without touching memory,
// and so does a lane whose src or dst lies outside [0, n_rows) (the WriteOps
// NULL convention, -1) or whose src == dst (a no-op copy).
//
// Hazard. The in-place copy is race-free only if live lanes have distinct
// dst and no live lane's src is another live lane's dst. dbs.write_pages
// guarantees both: a CoW destination is a freshly allocated free extent.
// The wrapper checks it when asked (check_routing=True).
//
// Offsets are 64-bit: a block-device pool holds 1.6e9 floats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;  // elements of T per block

template <typename T>
__global__ void copy_kernel(T* pool, const int* __restrict__ src,
                            const int* __restrict__ dst, const void* mask,
                            int mask_i32, int n_rows, int64_t row) {
  const int i = blockIdx.y;
  const bool live = mask_i32 ? ((const int*)mask)[i] != 0
                             : ((const unsigned char*)mask)[i] != 0;
  if (!live) return;
  const int s = src[i];
  const int t = dst[i];
  if (s < 0 || s >= n_rows || t < 0 || t >= n_rows || s == t) return;
  const T* from = pool + (int64_t)s * row;
  T* to = pool + (int64_t)t * row;
  const int64_t base = (int64_t)blockIdx.x * kChunk + threadIdx.x;
  T v[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t e = base + (int64_t)k * kThreads;
    if (e < row) v[k] = from[e];
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t e = base + (int64_t)k * kThreads;
    if (e < row) to[e] = v[k];
  }
}

}  // namespace

extern "C" {

// pool (n_rows, page, d) f32, updated in place; src, dst (n_lanes,) i32;
// mask (n_lanes,) bool (one byte each) or i32 (mask_i32 != 0). vec4 != 0
// selects float4 accesses (d % 4 == 0, aligned). n_lanes <= 65535.
int dbs_copy(void* pool, const void* src, const void* dst, const void* mask,
             int mask_i32, int n_lanes, int n_rows, int page, int d, int vec4,
             void* stream) {
  if (n_lanes > 0 && n_rows > 0 && page > 0 && d > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t row = (int64_t)page * (vec4 ? d / 4 : d);
    const dim3 grid((unsigned)((row + kChunk - 1) / kChunk),
                    (unsigned)n_lanes);
    if (vec4) {
      copy_kernel<float4><<<grid, kThreads, 0, st>>>(
          (float4*)pool, (const int*)src, (const int*)dst, mask, mask_i32,
          n_rows, row);
    } else {
      copy_kernel<float><<<grid, kThreads, 0, st>>>(
          (float*)pool, (const int*)src, (const int*)dst, mask, mask_i32,
          n_rows, row);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
