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
// Any dtype, as the TPU kernels take: both kernels move bytes. A block of D
// elements is block_bytes = D * itemsize bytes, moved in words of 16, 8, 4,
// 2 or 1 bytes, the widest that divides block_bytes and the base pointers'
// alignment (words.cuh; the wrappers decide: fp32 blocks of D % 4 == 0
// take 16). A hole reads as zero bytes, which is 0 in every float and
// integer dtype.
//
// Bound on an H100 SXM (3.35 TB/s HBM): both are pure data movement with no
// arithmetic, so bytes bound them. The semantic bytes are those of
// kernels/dbs/ops.py dbs_write_bytes / dbs_read_bytes: a CoW lane reads and
// writes one whole extent row (page * D * itemsize bytes each way), every
// written block moves D * itemsize bytes, every read lane reads and writes
// D * itemsize bytes. At the main path's widths (page 32, D 4096 fp32, 64
// lanes) a write batch averages about 10.7 MB, 3.2 us of HBM time, and one
// read batch is 2 MiB, about 0.63 us: a batch is too small to fill the card
// for long, so what counts is how many loads are in flight at once.
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
// In narrower words (a block whose bytes are no multiple of 16, or an
// unaligned base) a round moves 1024 words.
//
// Read design: one thread block per (lane i, chunk c of its D-vector), the
// lanes on gridDim.x (no lane limit) and the chunks on gridDim.y. Each
// thread loads ext[i] and block[i] together, then issues its four 16-byte
// loads of the chunk before its four stores, so a block of T threads moves
// 64 T bytes (4 T words) in one round: two dependent trips to memory in
// all. T is
// chosen per call from D and the lane count: the widest of 256, 128 and 64
// threads whose grid still gives every SM of the card a block (the SM
// count is read once per device). At the block device's width (64 lanes of
// 16 KiB) that is 64 threads and 4 KiB chunks, 256 blocks; at zero-copy
// serving's (16 lanes of 104 KiB) 128 threads and 8 KiB chunks, 208
// blocks; the old one-warp-per-lane design gave 8 and 2 blocks. A hole
// lane's blocks store zeros and load nothing.
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
// The read kernel is race-free by construction: the pool is only read, and
// every element of out has one writer, the thread of its (lane, chunk)
// block.
//
// Offsets are 64-bit: a full-size pool holds more than 2^31 words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "words.cuh"

namespace {

constexpr int kWriteThreads = 256;
constexpr int kWritePerThread = 4;   // loads in flight per thread per round
constexpr int kReadPerThread = 4;    // 16-byte loads in flight per thread
constexpr int kReadMaxThreads = 256;
constexpr int kReadMinThreads = 64;
constexpr int kMaxDevices = 64;

// The current device's SM count, read once per device (0 on an error,
// which the launch's cudaGetLastError then reports).
int sm_count() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

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

// pool and out are not __restrict__, so the compiler must keep every load
// of a chunk ahead of its stores (with both restricted it stored each value
// as it arrived, and a thread's later loads waited for its first one).
template <typename T>
__global__ void __launch_bounds__(kReadMaxThreads)
read_kernel(const T* pool, const int* __restrict__ ext,
            const int* __restrict__ block, T* out, int n_rows, int page,
            int d_vec, int n_chunks) {
  const int i = blockIdx.x;
  // both ids load together (no branch between them); holes read as
  // zeros, as the TPU kernel masks with the raw id
  const int e = ext[i];
  const int b = block[i];
  const bool hole = e < 0;
  const T* from = pool + ((int64_t)min(max(e, 0), n_rows - 1) * page +
                          min(max(b, 0), page - 1)) * d_vec;
  T* o = out + (int64_t)i * d_vec;
  const int chunk = (int)blockDim.x * kReadPerThread;
  for (int c = blockIdx.y; c < n_chunks; c += gridDim.y) {
    const int e0 = c * chunk + threadIdx.x;
    T v[kReadPerThread];
#pragma unroll
    for (int u = 0; u < kReadPerThread; ++u) {
      const int k = e0 + u * (int)blockDim.x;
      v[u] = T{};
      if (!hole && k < d_vec) v[u] = from[k];
    }
#pragma unroll
    for (int u = 0; u < kReadPerThread; ++u) {
      const int k = e0 + u * (int)blockDim.x;
      if (k < d_vec) o[k] = v[u];
    }
  }
}

// The read kernel's block size for n_lanes lanes of d_vec elements: the
// widest whose grid gives every SM a block, else the narrowest.
int read_threads(int n_lanes, int d_vec) {
  const int64_t sms = sm_count();
  int t = kReadMaxThreads;
  while (t > kReadMinThreads &&
         (int64_t)n_lanes * ((d_vec + t * kReadPerThread - 1) /
                             (t * kReadPerThread)) < sms)
    t /= 2;
  return t;
}

}  // namespace

extern "C" {

// pool (n_rows, page, d) of any dtype, aliased in place; src, dst
// (n_lanes,) i32; lane_of (n_lanes, page) i32; payload (n_lanes, d) of the
// pool's dtype; block_bytes = d * itemsize. The dump row is n_rows - 1.
// word: the bytes of one access (16, 8, 4, 2 or 1; it divides block_bytes
// and both base pointers' alignment).
int dbs_rw_write(void* pool, const void* src, const void* dst,
                 const void* lane_of, const void* payload, int n_lanes,
                 int n_rows, int page, int block_bytes, int word,
                 void* stream) {
  if (n_lanes > 65535 || word <= 0 || block_bytes % word)
    return (int)cudaErrorInvalidValue;
  if (n_lanes > 0 && page > 0 && block_bytes > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int dump = n_rows - 1;
    const dim3 grid((unsigned)page, (unsigned)n_lanes);
    const int d_vec = block_bytes / word;
    const bool known = by_word(word, [&](auto w) {
      using T = decltype(w);
      write_kernel<T><<<grid, kWriteThreads, 0, st>>>(
          (T*)pool, (const int*)src, (const int*)dst, (const int*)lane_of,
          (const T*)payload, dump, page, d_vec);
    });
    if (!known) return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The write kernel's resources in words of `word` bytes: info[0] registers
// per thread, [1] static and [2] dynamic shared memory per block (bytes),
// [3] blocks resident per SM, [4] threads per block.
int dbs_rw_write_info(int word, int* info) {
  const void* fn = nullptr;
  if (!by_word(word, [&](auto w) {
        fn = (const void*)write_kernel<decltype(w)>;
      }))
    return (int)cudaErrorInvalidValue;
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

// pool (n_rows, page, d) of any dtype; ext, block (n_lanes,) i32; out
// (n_lanes, d) of the pool's dtype; block_bytes and word as dbs_rw_write's.
int dbs_rw_read(const void* pool, const void* ext, const void* block,
                void* out, int n_lanes, int n_rows, int page, int block_bytes,
                int word, void* stream) {
  if (word <= 0 || block_bytes % word) return (int)cudaErrorInvalidValue;
  if (n_lanes > 0 && block_bytes > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int d_vec = block_bytes / word;
    const int threads = read_threads(n_lanes, d_vec);
    const int n_chunks =
        (d_vec + threads * kReadPerThread - 1) / (threads * kReadPerThread);
    const dim3 grid((unsigned)n_lanes, (unsigned)min(n_chunks, 65535));
    const bool known = by_word(word, [&](auto w) {
      using T = decltype(w);
      read_kernel<T><<<grid, threads, 0, st>>>(
          (const T*)pool, (const int*)ext, (const int*)block, (T*)out,
          n_rows, page, d_vec, n_chunks);
    });
    if (!known) return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The read kernel's resources at n_lanes lanes of block_bytes-byte blocks
// in words of `word` bytes: info[0] registers per thread, [1] static and
// [2] dynamic shared memory per block (bytes), [3] blocks resident per SM,
// [4] threads per block, [5] blocks in the grid.
int dbs_rw_read_info(int n_lanes, int block_bytes, int word, int* info) {
  if (n_lanes <= 0 || block_bytes <= 0 || word <= 0 || block_bytes % word)
    return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  if (!by_word(word, [&](auto w) {
        fn = (const void*)read_kernel<decltype(w)>;
      }))
    return (int)cudaErrorInvalidValue;
  const int d_vec = block_bytes / word;
  const int threads = read_threads(n_lanes, d_vec);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      0);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = 0;
  info[3] = per_sm;
  info[4] = threads;
  info[5] = n_lanes * min((d_vec + threads * kReadPerThread - 1) /
                              (threads * kReadPerThread),
                          65535);
  return 0;
}

}  // extern "C"
