// dbs_rw: the DBS write-composition and hole-masked read-gather kernels,
// written for Hopper (sm_90a), with a plain C interface loaded by ctypes
// (kernels/_build.py, wrappers in kernels/dbs/rw_kernel.py).
//
// dbs_rw_write replaces the Pallas kernel repro/kernels/dbs/rw_kernel.py
// ::dbs_rw_write (body _write_kernel). For each routed lane i, extent row
// pool[dst[i]] becomes pool[src[i]] with block j replaced by
// payload[lane_of[i][j]] wherever lane_of[i][j] >= 0. The pool is updated in
// place.
//
// dbs_rw_read replaces repro/kernels/dbs/rw_kernel.py::dbs_rw_read (body
// _read_kernel): out[i] = pool[clamp(ext[i])][clamp(block[i])], zeros where
// the raw ext[i] < 0.
//
// Bound on an H100 SXM (3.35 TB/s HBM): both are pure data movement with no
// arithmetic, so bytes bound them. The semantic bytes are those of
// kernels/dbs/ops.py dbs_write_bytes / dbs_read_bytes: a CoW lane reads and
// writes one whole extent row (page * D * 4 bytes each way), every written
// block moves D * 4 bytes, every read lane reads and writes D * 4 bytes. At
// the main path's widths (page 32, D 4096 fp32, 64 lanes) a write batch
// averages about 10.7 MB, 3.2 us of HBM time, and one read batch is 2 MiB,
// about 0.63 us: a batch is too small to fill the card for long, so what
// counts is how many loads are in flight at once.
//
// Write design: one thread block per (block j of the row, lane i), 32 x 64
// = 2048 blocks at the block device's width. A block reads dst[i], src[i]
// and lane_of[i][j] once and returns at once for a lane routed to the dump
// row (otherwise every non-leader lane would write that one row
// concurrently) and for a block kept in place (lane_of < 0 and src == dst:
// an in-place write moves only its payload blocks). Otherwise it copies one
// D-vector, payload[lane_of[i][j]] or pool[src[i]][j], into pool[dst[i]][j]:
// 256 threads, each issuing its four 16-byte loads before its stores, so
// 16 KiB (D 4096) moves in one round with 1024 loads in flight; a wider
// block (D 26624 on zero-copy serving, 104 KiB) loops over such rounds.
// float4 when D % 4 == 0 and both base pointers are 16-byte aligned (the
// wrapper decides), a scalar loop otherwise. Read design: one warp per lane,
// eight lanes per thread block, each warp copying one contiguous D-vector.
//
// Hazard. Pallas runs the grid in order; here thread blocks run
// concurrently, and the blocks of one row no longer run in one thread
// block. The in-place write is race-free under the routing contract that
// kernels/dbs/ops.py _route_writes and dbs.write_pages give: each live row
// is written by exactly one lane, and no lane's src is another lane's dst.
// So each (row, block) cell of the pool has exactly one writer, one thread
// block; what it reads is the payload (never written) or the same block of
// its own lane's src row, which no thread block writes in this batch (a CoW
// source is never a destination, and src == dst copies nothing). The
// wrapper checks the contract when asked (check_routing=True).
//
// Offsets are 64-bit: a full-size pool holds more than 2^31 floats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWriteThreads = 256;
constexpr int kWritePerThread = 4;   // loads in flight per thread per round
constexpr int kReadWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWriteThreads)
write_kernel(T* __restrict__ pool, const int* __restrict__ src,
             const int* __restrict__ dst, const int* __restrict__ lane_of,
             const T* __restrict__ payload, int dump, int page, int d_vec) {
  const int j = blockIdx.x;
  const int i = blockIdx.y;
  const int t = dst[i];
  if (t == dump) return;  // non-leader and masked lanes: a no-op by routing
  const int s = src[i];
  const int lane = lane_of[(int64_t)i * page + j];
  if (lane < 0 && s == t) return;  // block kept in place: nothing to move
  const T* from = lane >= 0 ? payload + (int64_t)lane * d_vec
                            : pool + ((int64_t)s * page + j) * d_vec;
  T* to = pool + ((int64_t)t * page + j) * d_vec;
  for (int e0 = threadIdx.x; e0 < d_vec;
       e0 += kWriteThreads * kWritePerThread) {
    T v[kWritePerThread];
#pragma unroll
    for (int u = 0; u < kWritePerThread; ++u) {
      const int e = e0 + u * kWriteThreads;
      if (e < d_vec) v[u] = from[e];
    }
#pragma unroll
    for (int u = 0; u < kWritePerThread; ++u) {
      const int e = e0 + u * kWriteThreads;
      if (e < d_vec) to[e] = v[u];
    }
  }
}

template <typename T>
__global__ void read_kernel(const T* __restrict__ pool,
                            const int* __restrict__ ext,
                            const int* __restrict__ block, T* __restrict__ out,
                            int n_lanes, int n_rows, int page, int d_vec) {
  const int i = blockIdx.x * kReadWarps + threadIdx.x / 32;
  if (i >= n_lanes) return;
  const int lane = threadIdx.x % 32;
  const int e = ext[i];
  T* o = out + (int64_t)i * d_vec;
  if (e < 0) {  // hole: zeros, as the TPU kernel masks with the raw id
    const T zero{};
    for (int k = lane; k < d_vec; k += 32) o[k] = zero;
    return;
  }
  const int ec = min(e, n_rows - 1);
  const int bc = min(max(block[i], 0), page - 1);
  const T* from = pool + ((int64_t)ec * page + bc) * d_vec;
  for (int k = lane; k < d_vec; k += 32) o[k] = from[k];
}

}  // namespace

extern "C" {

// pool (n_rows, page, d) f32, aliased in place; src, dst (n_lanes,) i32;
// lane_of (n_lanes, page) i32; payload (n_lanes, d) f32. The dump row is
// n_rows - 1. vec4 != 0 selects float4 accesses (d % 4 == 0, aligned).
int dbs_rw_write(void* pool, const void* src, const void* dst,
                 const void* lane_of, const void* payload, int n_lanes,
                 int n_rows, int page, int d, int vec4, void* stream) {
  if (n_lanes > 65535) return (int)cudaErrorInvalidValue;
  if (n_lanes > 0 && page > 0 && d > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int dump = n_rows - 1;
    const dim3 grid((unsigned)page, (unsigned)n_lanes);
    if (vec4) {
      write_kernel<float4><<<grid, kWriteThreads, 0, st>>>(
          (float4*)pool, (const int*)src, (const int*)dst,
          (const int*)lane_of, (const float4*)payload, dump, page, d / 4);
    } else {
      write_kernel<float><<<grid, kWriteThreads, 0, st>>>(
          (float*)pool, (const int*)src, (const int*)dst,
          (const int*)lane_of, (const float*)payload, dump, page, d);
    }
  }
  return (int)cudaGetLastError();
}

// The write kernel's resources (float4 when vec4 != 0): info[0] registers
// per thread, [1] static and [2] dynamic shared memory per block (bytes),
// [3] blocks resident per SM, [4] threads per block.
int dbs_rw_write_info(int vec4, int* info) {
  const void* fn = vec4 ? (const void*)write_kernel<float4>
                        : (const void*)write_kernel<float>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      kWriteThreads, 0);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = 0;
  info[3] = per_sm;
  info[4] = kWriteThreads;
  return 0;
}

// pool (n_rows, page, d) f32; ext, block (n_lanes,) i32; out (n_lanes, d).
int dbs_rw_read(const void* pool, const void* ext, const void* block,
                void* out, int n_lanes, int n_rows, int page, int d, int vec4,
                void* stream) {
  if (n_lanes > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int grid = (n_lanes + kReadWarps - 1) / kReadWarps;
    if (vec4) {
      read_kernel<float4><<<grid, kReadWarps * 32, 0, st>>>(
          (const float4*)pool, (const int*)ext, (const int*)block,
          (float4*)out, n_lanes, n_rows, page, d / 4);
    } else {
      read_kernel<float><<<grid, kReadWarps * 32, 0, st>>>(
          (const float*)pool, (const int*)ext, (const int*)block, (float*)out,
          n_lanes, n_rows, page, d);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
