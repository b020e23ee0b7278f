// dbs_copy: the DBS copy-on-write extent copy, written for Hopper (sm_90a),
// with a plain C interface loaded by ctypes (kernels/_build.py, wrapper in
// kernels/dbs/copy_kernel.py).
//
// Replaces the Pallas kernel repro/kernels/dbs/copy_kernel.py::dbs_copy
// (body _kernel): pool[dst[i]] = pool[src[i]] for every lane with mask[i],
// in place, on an (n_rows, page, d) pool of any dtype. A copy moves bytes:
// the kernel sees a row as row_bytes bytes and copies it in words of 16,
// 8, 4, 2 or 1 bytes, the widest that divides the row's bytes and the
// pool's alignment (words.cuh; the wrapper decides: fp32 rows of
// d % 4 == 0 take 16).
//
// Bound on an H100 SXM (3.35 TB/s HBM): pure data movement, so bytes bound
// it. A copied lane reads and writes one whole extent row (page * d *
// itemsize bytes each way). At the block device's width (page 32, d 4096
// fp32) a row is 512 KiB and a batch of 64 CoW lanes moves 64 MiB, about
// 20 us of HBM time; on the serving baseline at gemma2-2b (page 32, d 4 *
// 256) a row is 128 KiB in fp32 and 64 KiB on the bf16 serve plan's
// pools. But the block device's own calls copy 0.3-0.4 rows on average and
// most copy none, so a call is mostly its launch: what counts is that a
// call with no live lane does next to nothing.
//
// Design: a small grid that compacts the live lanes itself, warp by warp.
// 64-thread blocks, one per SM of the card (the SM count is read once per
// device), and no more warps than there could be work items. Every warp
// reads the mask, src and dst of a window of 128 lanes (four per thread,
// all loads issued before any is used: one round trip, 9 bytes a lane,
// from L2), keeps the live lanes with one ballot per group of 32, and is
// done with the window when none is live. Otherwise the grid's warps walk
// the window's work items, (live lane, 4 KiB chunk of its row), warp w of
// block b taking items b + w * gridDim.x + k * (warps in the grid), so a
// live row spreads over many SMs first: a 512 KiB row over 128 warps, a
// 128 KiB row over 32. For each item the warp finds its lane among the
// ballots and takes its (src, dst) from the thread that loaded them (a
// shuffle); each thread then issues its eight 16-byte loads before its
// stores. No warp waits for another (no shared memory, no barrier), so the
// first data load follows the mask's arrival at once: with a block prefix
// in shared memory instead (one barrier to leave an empty window, two more
// to build the list) an empty call cost about the same and a live call
// more. Every warp computes the same list. A call with no live lane costs
// its launch and one round trip for 576 bytes (64 lanes). More lanes than
// a window take more windows (the wrapper allows 65535). The word is the
// wrapper's: 16 bytes (4 KiB items) when the row's bytes are a multiple of
// 16 and the pool is 16-byte aligned, else the widest of 8, 4, 2 and 1
// bytes that fits (items of 32 x 8 words). A row holds fewer than 2^31
// words, so item offsets are 32-bit; a larger row is refused.
//
// Launch. Most calls do next to nothing, so the launch itself is much of a
// call. The kernel is launched with programmatic stream serialization
// (Hopper's programmatic dependent launch): its blocks may be scheduled
// while the grid before it in the stream still runs, and each first waits
// (griddepcontrol.wait) until that grid has finished and its writes are
// visible, so the stream's order holds; then it lets the next grid launch
// (griddepcontrol.launch_dependents), which waits the same way if it asked
// to overlap and is ordered as usual if not. CUDA graphs capture the launch
// as a programmatic edge. Without the launch attribute both instructions
// are no-ops; kernels/dbs/compare.py can time the two builds in turns.
//
// Masked lanes. The TPU kernel rewrites a masked lane's destination with its
// own contents, and its non-pool wrapper clamps dst = -1 to extent 0: that
// is harmless only because Pallas runs the grid in order. Here blocks run
// concurrently, so a masked lane would race a live lane that copies into
// the same row. A masked lane therefore is not live and touches nothing,
// and neither does a lane whose src or dst lies outside [0, n_rows) (the
// WriteOps NULL convention, -1) or whose src == dst (a no-op copy).
//
// Hazard. The in-place copy is race-free only if live lanes have distinct
// dst and no live lane's src is another live lane's dst. dbs.write_pages
// guarantees both: a CoW destination is a freshly allocated free extent.
// Then every element of the pool that is written has one writer (the
// thread of its one work item), and no element that is read is written in
// the call, whichever warps run first. The wrapper checks the contract
// when asked (check_routing=True).
//
// Row offsets are 64-bit: a block-device pool holds 6.4e9 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "words.cuh"


namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;                 // 16-byte loads in flight
constexpr int kItem = 32 * kPerThread;        // words per warp item
constexpr int kLanesPerThread = 4;
constexpr int kWindow = 32 * kLanesPerThread; // lanes a warp compacts a pass
constexpr int kBlocksPerSm = 1;
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

// Every warp compacts the live lanes of a window by itself, then copies
// the window's work items whose number equals its global warp index
// modulo the warps of the grid.
template <typename T>
__global__ void __launch_bounds__(kThreads)
copy_kernel(T* pool, const int* __restrict__ src, const int* __restrict__ dst,
            const void* mask, int mask_i32, int n_lanes, int n_rows, int row,
            int items_per_row) {
  // wait for the grids before this one in the stream (their writes of the
  // pool, mask, src and dst), then let the next grid launch
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  const int n_warps = gridDim.x * kWarps;
  const int gw = (threadIdx.x / 32) * gridDim.x + blockIdx.x;  // SMs first
  for (int w0 = 0; w0 < n_lanes; w0 += kWindow) {
    bool live[kLanesPerThread];
    int s[kLanesPerThread], t[kLanesPerThread];
#pragma unroll
    for (int k = 0; k < kLanesPerThread; ++k) {
      const int i = w0 + k * 32 + lane;
      bool m = false;
      s[k] = t[k] = -1;
      if (i < n_lanes) {
        m = mask_i32 ? ((const int*)mask)[i] != 0
                     : ((const unsigned char*)mask)[i] != 0;
        s[k] = src[i];
        t[k] = dst[i];
      }
      live[k] = m && s[k] >= 0 && s[k] < n_rows && t[k] >= 0 &&
                t[k] < n_rows && s[k] != t[k];
    }
    unsigned bal[kLanesPerThread];
    int n_live = 0;
#pragma unroll
    for (int k = 0; k < kLanesPerThread; ++k) {
      bal[k] = __ballot_sync(0xffffffffu, live[k]);
      n_live += __popc(bal[k]);
    }
    const int n_items = n_live * items_per_row;
    int li = gw / items_per_row;
    int c = gw - li * items_per_row;
    const int dli = n_warps / items_per_row;
    const int dc = n_warps - dli * items_per_row;
    for (int it = gw; it < n_items; it += n_warps) {
      // the li-th live lane of the window: the thread of its group that
      // holds it hands its (src, dst) to the warp
      int sv = 0, tv = 0, r = li;
#pragma unroll
      for (int k = 0; k < kLanesPerThread; ++k) {
        const int n = __popc(bal[k]);
        const unsigned who = __ballot_sync(
            0xffffffffu, live[k] && __popc(bal[k] & below) == r);
        const int from_lane = who ? __ffs(who) - 1 : 0;
        const int sk = __shfl_sync(0xffffffffu, s[k], from_lane);
        const int tk = __shfl_sync(0xffffffffu, t[k], from_lane);
        if (r >= 0 && r < n) {
          sv = sk;
          tv = tk;
        }
        r -= n;
      }
      const T* from = pool + (int64_t)sv * row + c * kItem;
      T* to = pool + (int64_t)tv * row + c * kItem;
      const int left = row - c * kItem;
      T v[kPerThread];
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int e = lane + u * 32;
        if (e < left) v[u] = from[e];
      }
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int e = lane + u * 32;
        if (e < left) to[e] = v[u];
      }
      li += dli;
      c += dc;
      if (c >= items_per_row) {
        c -= items_per_row;
        ++li;
      }
    }
  }
}

// The grid: at most kBlocksPerSm blocks an SM, and no more warps than the
// work items there could be.
unsigned copy_grid(int n_lanes, int items_per_row) {
  const int64_t cap = (int64_t)kBlocksPerSm * sm_count();
  const int64_t most =
      ((int64_t)n_lanes * items_per_row + kWarps - 1) / kWarps;
  return (unsigned)(most < cap ? most : (cap > 0 ? cap : 1));
}

}  // namespace

extern "C" {

// pool (n_rows, page, d) of any dtype, updated in place, row_bytes = page *
// d * itemsize bytes a row; src, dst (n_lanes,) i32; mask (n_lanes,) bool
// (one byte each) or i32 (mask_i32 != 0). word: the bytes of one access
// (16, 8, 4, 2 or 1; it divides row_bytes and the pool's alignment).
int dbs_copy(void* pool, const void* src, const void* dst, const void* mask,
             int mask_i32, int n_lanes, int n_rows, int64_t row_bytes,
             int word, void* stream) {
  if (word <= 0 || row_bytes % word) return (int)cudaErrorInvalidValue;
  if (n_lanes > 0 && n_rows > 0 && row_bytes > 0) {
    const int64_t row64 = row_bytes / word;
    if (row64 > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const int row = (int)row64;
    const int items = (int)((row64 + kItem - 1) / kItem);
    const unsigned grid = copy_grid(n_lanes, items);
    cudaLaunchAttribute pdl[1];
    pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    pdl[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = pdl;
    cfg.numAttrs = 1;
    const bool known = by_word(word, [&](auto w) {
      using T = decltype(w);
      cudaLaunchKernelEx(&cfg, copy_kernel<T>, (T*)pool, (const int*)src,
                         (const int*)dst, mask, mask_i32, n_lanes, n_rows,
                         row, items);
    });
    if (!known) return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The copy kernel's resources at n_lanes lanes of row_bytes-byte rows in
// words of `word` bytes: info[0] registers per thread, [1] static and [2]
// dynamic shared memory per block (bytes), [3] blocks resident per SM, [4]
// threads per block, [5] blocks in the grid.
int dbs_copy_info(int n_lanes, int64_t row_bytes, int word, int* info) {
  if (n_lanes <= 0 || row_bytes <= 0 || word <= 0 || row_bytes % word)
    return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  if (!by_word(word, [&](auto w) {
        fn = (const void*)copy_kernel<decltype(w)>;
      }))
    return (int)cudaErrorInvalidValue;
  const int64_t row = row_bytes / word;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      0);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = 0;
  info[3] = per_sm;
  info[4] = kThreads;
  info[5] = (int)copy_grid(n_lanes, (int)((row + kItem - 1) / kItem));
  return 0;
}

}  // extern "C"
