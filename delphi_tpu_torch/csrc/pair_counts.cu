// K1 pair_counts: co-occurrence count matrices of code-column pairs.
//
// Replaces delphi_tpu/ops/pallas_kernels.py::_pair_count_kernel, which
// contracted one-hot(x)^T . one-hot(y) on the TPU's MXU over 4096-row tiles
// with an f32 accumulator (exact only below 2^24 rows). Here the count is
// computed directly: each row adds one to bin (x+1)*(vy+1) + (y+1) of its
// pair's [vx+1, vy+1] int32 matrix (NULL = -1 shifts to slot 0).
//
// What bounds it on an H100: reading each code column the launch needs once
// (4 bytes per row per distinct column); the matrices written are small
// beside that. Shared-memory atomics on a few hot bins are the other limit.
//
// Design:
// * One read per column. The launch's distinct columns are listed once in
//   the table. For each tile of 1,024 rows every thread copies 4 consecutive
//   rows of each column into its own slots of shared memory (one 16-byte
//   cp.async; four 4-byte ones when the rows are not 16-byte aligned), and
//   then counts every pair of the launch from there. No column is read once
//   per pair. Two stage buffers: the copy of the next tile is in flight
//   while this one counts.
// * Contention. Pairs whose matrices fit shared memory together count into
//   one histogram per block there, the smallest matrices first (the main
//   path's 444 bins take 1.7 KB). Two ways to spread the hot bins were
//   built and timed on an H100 at 9x4 and on the main path: one histogram
//   copy per warp came out level at 9x4 and slower on the main path, and
//   warp-aggregated atomics (__match_any_sync + __popc) slower at both, so
//   the kernel keeps neither (PERF.md, section 6).
// * Grid and merge. A persistent grid of up to 4 blocks per SM (fewer when
//   the block's shared memory allows fewer) strides over the tiles; at the
//   end each block adds its nonzero bins into the output with one global
//   atomicAdd per bin. Integer adds are order-free, so the result is
//   bit-identical run to run.
// * Big matrices (smem_off < 0, e.g. 2047x2047 = 16 MB, which stays in the
//   50 MB L2) count with global atomics inside the same launch.
//
// The host entry zeroes the launch's output range with cudaMemsetAsync and
// sets the kernel's shared-memory limit once per process and device. Limit:
// fewer than 2^31 rows. Codes must lie in [-1, v): the kernel only checks
// that a row's fused bin falls inside its pair's matrix, which drops the
// -2 that pads the last tile; a code outside its vocabulary is not caught.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPairs = 128;
constexpr int kMaxCols = 16;
constexpr int kMaxDevices = 64;

// Mirrored by ops/kernels/pair_counts.py::PairEntry (ctypes); 24 bytes.
//   0 out_off   int64  element offset of the pair's matrix in `out`
//   8 smem_off  int32  offset of its bins in the shared histogram,
//                      -1 for the global-atomic route
//  12 wy        int32  vy + 1
//  16 bins      int32  (vx + 1) * (vy + 1)
//  20 xs, ys    uint8  slots of x and y in PairTable::cols
//  22 pad       uint16
struct PairEntry {
  int64_t out_off;
  int32_t smem_off;
  int32_t wy;
  int32_t bins;
  uint8_t xs;
  uint8_t ys;
  uint16_t pad;
};
static_assert(sizeof(PairEntry) == 24, "PairEntry layout");

// Mirrored by ops/kernels/pair_counts.py::PairTable (ctypes); 3,176 bytes,
// passed to the kernel by value (within the classic 4 KB parameter limit).
//    0 codes        const int32*  [m, n_rows] code matrix
//    8 out          int32*        flat output of every pair
//   16 n_rows       int64
//   24 n_pairs      int32         pairs of this launch (<= 128), contiguous
//                                 in `out`
//   28 n_cols       int32         distinct columns of this launch (<= 16)
//   32 hist_bins    int32         bins of the block's shared histogram
//   36 pad          int32
//   40 cols         int32[16]     column index of each slot
//  104 pairs        PairEntry[128]
struct PairTable {
  const int32_t* codes;
  int32_t* out;
  int64_t n_rows;
  int32_t n_pairs;
  int32_t n_cols;
  int32_t hist_bins;
  int32_t pad;
  int32_t cols[kMaxCols];
  PairEntry pairs[kMaxPairs];
};
static_assert(sizeof(PairTable) == 3176, "PairTable layout");

// Counts one row of pair e: into `hist` (the block's histogram) or,
// for a pair on the global route, straight into the output.
__device__ __forceinline__ void count_row(const PairEntry& e, int32_t* hist,
                                          int32_t* out, int x, int y) {
  // rows past the end are staged as -2, which gives a negative bin
  const int bin = (x + 1) * e.wy + (y + 1);
  if (static_cast<unsigned>(bin) >= static_cast<unsigned>(e.bins)) return;
  if (e.smem_off >= 0) {  // uniform over the launch
    atomicAdd(hist + e.smem_off + bin, 1);
  } else {
    atomicAdd(out + e.out_off + bin, 1);
  }
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(int4* dst, const int4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Starts the copy of this thread's 4 rows (quad q) of every column into
// its own slots of one stage buffer; rows past the end are staged as -2.
template <bool kVec>
__device__ __forceinline__ void stage_quad(const PairTable& t, int4* stage,
                                           int64_t q, int64_t n_quads,
                                           int tid) {
  const int64_t n = t.n_rows;
  for (int c = 0; c < t.n_cols; ++c) {
    int4* dst = stage + c * kThreads + tid;
    const int32_t* col = t.codes + static_cast<int64_t>(t.cols[c]) * n;
    if (kVec && q < n_quads) {
      cp_async16(dst, reinterpret_cast<const int4*>(col) + q);
    } else {
      int32_t* d = reinterpret_cast<int32_t*>(dst);
      for (int k = 0; k < 4; ++k) {
        const int64_t r = q * 4 + k;
        if (q < n_quads && r < n) cp_async4(d + k, col + r); else d[k] = -2;
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    pair_counts_kernel(const __grid_constant__ PairTable t) {
  extern __shared__ int4 smem[];
  int4* stage = smem;  // [2][n_cols][kThreads], each thread's own rows
  int32_t* hist = reinterpret_cast<int32_t*>(smem + 2 * t.n_cols * kThreads);
  const int tid = threadIdx.x;
  for (int i = tid; i < t.hist_bins; i += kThreads) hist[i] = 0;
  __syncthreads();
  const int64_t n_quads = (t.n_rows + 3) >> 2;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  const int buf_len = t.n_cols * kThreads;
  int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  // two stage buffers: the copy of the next tile runs while this one counts
  if (base < n_quads) stage_quad<kVec>(t, stage, base + tid, n_quads, tid);
  cp_async_commit();
  for (int buf = 0; base < n_quads; base += step, buf ^= 1) {  // uniform
    if (base + step < n_quads) {
      stage_quad<kVec>(t, stage + (buf ^ 1) * buf_len, base + step + tid,
                       n_quads, tid);
    }
    cp_async_commit();
    cp_async_wait_prior();  // this thread's rows of the current tile landed
    const int4* cur = stage + buf * buf_len;
    for (int p = 0; p < t.n_pairs; ++p) {
      const PairEntry& e = t.pairs[p];
      const int4 x = cur[e.xs * kThreads + tid];
      const int4 y = cur[e.ys * kThreads + tid];
      count_row(e, hist, t.out, x.x, y.x);
      count_row(e, hist, t.out, x.y, y.y);
      count_row(e, hist, t.out, x.z, y.z);
      count_row(e, hist, t.out, x.w, y.w);
    }
  }
  __syncthreads();
  // each nonzero bin goes out in one global atomic
  for (int p = 0; p < t.n_pairs; ++p) {
    const PairEntry& e = t.pairs[p];
    if (e.smem_off < 0) continue;
    for (int i = tid; i < e.bins; i += kThreads) {
      const int32_t c = hist[e.smem_off + i];
      if (c != 0) atomicAdd(t.out + e.out_off + i, c);
    }
  }
}

// Lifts both instantiations' dynamic shared-memory limit to the card's
// opt-in maximum, once per process and device.
cudaError_t allow_large_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(pair_counts_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(pair_counts_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

}  // namespace

// table: host pointer to one PairTable (copied into the launch's
// parameters); grid and smem_bytes come from the wrapper's plan. Zeroes the
// launch's output range, then launches on `stream`. Returns the first
// cudaError_t met (0 on success). Nothing here waits for the device.
extern "C" int delphi_pair_counts(const void* table, int grid, int smem_bytes,
                                  void* stream) {
  const PairTable& t = *static_cast<const PairTable*>(table);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t.n_pairs < 1 || t.n_pairs > kMaxPairs || t.n_cols < 1 ||
      t.n_cols > kMaxCols || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_large_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const PairEntry& last = t.pairs[t.n_pairs - 1];
  const int64_t lo = t.pairs[0].out_off;
  const int64_t hi = last.out_off + last.bins;
  err = cudaMemsetAsync(t.out + lo, 0,
                        static_cast<size_t>(hi - lo) * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = t.n_rows % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(t.codes) % 16 == 0;
  if (vec) {
    pair_counts_kernel<true><<<grid, kThreads, smem_bytes, s>>>(t);
  } else {
    pair_counts_kernel<false><<<grid, kThreads, smem_bytes, s>>>(t);
  }
  return static_cast<int>(cudaGetLastError());
}
