// K2 entropy_terms: entropy partial sums of count segments.
//
// Replaces delphi_tpu/ops/pallas_kernels.py::_entropy_kernel, which reduced
// ONE flattened f32 count vector per call in a single VMEM block. Here one
// launch covers every segment of a phase (all H(x,y), or all H(y)) and
// reduces counts[off[s], off[s+1]) to
//   h = -sum_{c>0} (c/n) log2(c/n),   total = sum c,   nnz = #{c > 0}.
// It reads the int32 matrices K1 wrote, in place on the device: no host
// round trip, no cast to f32. The missing-mass correction stays on the host.
//
// What bounds it on an H100: reading 4 bytes per count. Beyond that the f64
// division and log2 of each count, tens of instructions, which a warp pays
// whenever any of its lanes holds a nonzero count.
//
// Design:
// * Chunks. Every segment is cut into chunks of `chunk` counts (at least
//   one chunk, so an empty segment still writes zeros), and one warp takes
//   one chunk, so a 4.2M-count segment spreads over every SM while a
//   47-count segment costs one warp, not a block. The wrapper sizes the
//   chunks to the call: about 2,048 chunks, 256 to 8,192 counts each. A
//   warp reads its chunk with 16-byte int4 loads between a scalar head and
//   tail.
// * Terms. The four terms of an int4 are computed without a branch, so
//   their f64 chains overlap. A shared table of p * log2(p) for counts
//   below 512 was built and timed on an H100: it won on big sparse
//   matrices (255x255, 2047x2047) and lost at 28 pairs of 8 columns and on
//   the main path's small calls; no count threshold told 255x255 (65,536
//   counts) from the 28 pairs (67,691) apart, so every term is computed
//   (PERF.md, section 6).
// * Fixed-order reductions. Each lane sums its counts in index order; the
//   warp folds its lanes with a shuffle tree (lane 0 keeps the result). A
//   one-chunk segment writes its result directly. A longer one writes an
//   f64 h partial and int64 total/nnz partials per chunk; the last warp to
//   finish the segment (a per-segment ticket after __threadfence) sums the
//   partials in chunk order, lane-strided, then by the same shuffle tree.
//   No float atomics, so the result repeats bit for bit.
// * Formula. p = c / n; h += p * log2(p) in f64 per count, as the reference's
//   host route computes it; log2 n - sum c log2 c / n would cancel badly at
//   small entropy.
//
// The segment table travels by value in the launch's parameters: a uniform
// stride and count (mode 0, the singletons phase), up to 192 inline segment
// offsets (mode 1), or a device copy the wrapper uploaded from pinned memory
// (mode 2). The host entry zeroes the tickets with cudaMemsetAsync.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInline = 192;  // segments held inline in the table
constexpr unsigned kFull = 0xffffffffu;

// Mirrored by ops/kernels/entropy.py::EntropyTable (ctypes); 3,208 bytes,
// passed to the kernel by value.
//    0 counts              const int32*  count buffer
//    8 h                   double*       [n_segments] result
//   16 total               int64*        [n_segments]
//   24 nnz                 int64*        [n_segments]
//   32 part_h              double*       [n_chunks] partials (multi-chunk)
//   40 part_total          int64*        [n_chunks]
//   48 part_nnz            int64*        [n_chunks]
//   56 tickets             int32*        [n_segments], null when every
//                                        segment is one chunk
//   64 table_dev           const int64*  mode 2: offsets[S+1], chunk_base[S+1]
//   72 n_rows              double
//   80 base                int64         mode 0: segment s starts at
//   88 stride              int64                 base + s * stride
//   96 chunk               int64         counts per chunk
//  104 n_segments          int32
//  108 n_chunks            int32
//  112 chunks_per_segment  int32         mode 0
//  116 mode                int32         0 uniform, 1 inline, 2 device
//  120 table               int64[386]    mode 1: offsets[S+1], chunk_base[S+1]
struct EntropyTable {
  const int32_t* counts;
  double* h;
  int64_t* total;
  int64_t* nnz;
  double* part_h;
  int64_t* part_total;
  int64_t* part_nnz;
  int32_t* tickets;
  const int64_t* table_dev;
  double n_rows;
  int64_t base;
  int64_t stride;
  int64_t chunk;
  int32_t n_segments;
  int32_t n_chunks;
  int32_t chunks_per_segment;
  int32_t mode;
  int64_t table[2 * (kInline + 1)];
};
static_assert(sizeof(EntropyTable) == 3208, "EntropyTable layout");

// The term p * log2(p) of one count, without a branch: a zero count takes
// p = 1, whose term is +0.0, and adding +0.0 leaves every partial sum
// unchanged. __dmul_rn keeps the product rounded on its own (never fused
// into the sum it feeds).
__device__ __forceinline__ double term(int32_t c, double n) {
  const double p = c > 0 ? static_cast<double>(c) / n : 1.0;
  return __dmul_rn(p, log2(p));
}

__device__ __forceinline__ void add_count(int32_t c, double n, double& h,
                                          long long& tot, long long& nz) {
  h += term(c, n);
  tot += static_cast<long long>(c > 0 ? c : 0);
  nz += c > 0;
}

// Four consecutive counts: their four terms are independent, so their
// chains overlap; they are added in index order.
__device__ __forceinline__ void add_count4(int4 v, double n, double& h,
                                           long long& tot, long long& nz) {
  const double t0 = term(v.x, n);
  const double t1 = term(v.y, n);
  const double t2 = term(v.z, n);
  const double t3 = term(v.w, n);
  h += t0;
  h += t1;
  h += t2;
  h += t3;
  tot += static_cast<long long>(v.x > 0 ? v.x : 0);
  tot += static_cast<long long>(v.y > 0 ? v.y : 0);
  tot += static_cast<long long>(v.z > 0 ? v.z : 0);
  tot += static_cast<long long>(v.w > 0 ? v.w : 0);
  nz += (v.x > 0) + (v.y > 0) + (v.z > 0) + (v.w > 0);
}

// Fixed-order shuffle tree; lane 0 ends with the warp's sum.
__device__ __forceinline__ void warp_sum(double& h, long long& tot,
                                         long long& nz) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    h += __shfl_down_sync(kFull, h, o);
    tot += __shfl_down_sync(kFull, tot, o);
    nz += __shfl_down_sync(kFull, nz, o);
  }
}

__global__ void __launch_bounds__(kThreads)
    entropy_terms_kernel(const __grid_constant__ EntropyTable t) {
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= t.n_chunks) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;

  // the warp's segment s, its first chunk cb and chunk count k, its range
  int s;
  int64_t cb, k, seg_lo, seg_hi;
  if (t.mode == 0) {
    k = t.chunks_per_segment;
    s = static_cast<int>(w / k);
    cb = s * k;
    seg_lo = t.base + s * t.stride;
    seg_hi = seg_lo + t.stride;
  } else {
    const int64_t* off = t.mode == 1 ? t.table : t.table_dev;
    const int64_t* chunk_base = off + t.n_segments + 1;
    int lo = 0, hi = t.n_segments;  // chunk_base[lo] <= w < chunk_base[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (chunk_base[mid] <= w) lo = mid; else hi = mid;
    }
    s = lo;
    cb = chunk_base[s];
    k = chunk_base[s + 1] - cb;
    seg_lo = off[s];
    seg_hi = off[s + 1];
  }
  const int64_t lo = seg_lo + (w - cb) * t.chunk;
  const int64_t hi = lo + t.chunk < seg_hi ? lo + t.chunk : seg_hi;

  double h = 0.0;
  long long tot = 0, nz = 0;
  const double n = t.n_rows;
  const int32_t* c = t.counts;
  // [lo, a) scalar head, [a, b) int4 body, [b, hi) scalar tail
  const int64_t shift = static_cast<int64_t>(
      (reinterpret_cast<uintptr_t>(c) >> 2) & 3);
  int64_t a = lo + ((4 - ((lo + shift) & 3)) & 3);
  if (a > hi) a = hi;
  const int64_t b = a + ((hi - a) & ~static_cast<int64_t>(3));
  if (lane < a - lo) {
    add_count(__ldg(c + lo + lane), n, h, tot, nz);
  }
  const int4* body = reinterpret_cast<const int4*>(c + a);
  const int64_t n_vec = (b - a) >> 2;
#pragma unroll 8
  for (int64_t i = lane; i < n_vec; i += 32) {
    add_count4(__ldg(body + i), n, h, tot, nz);
  }
  if (lane < hi - b) {
    add_count(__ldg(c + b + lane), n, h, tot, nz);
  }
  warp_sum(h, tot, nz);

  if (k == 1) {
    if (lane == 0) {
      t.h[s] = 0.0 - h;
      t.total[s] = tot;
      t.nnz[s] = nz;
    }
    return;
  }
  int ticket = 0;
  if (lane == 0) {
    t.part_h[w] = h;
    t.part_total[w] = tot;
    t.part_nnz[w] = nz;
    __threadfence();
    ticket = atomicAdd(t.tickets + s, 1);
  }
  ticket = __shfl_sync(kFull, ticket, 0);
  if (ticket != k - 1) return;
  __threadfence();
  h = 0.0;
  tot = 0;
  nz = 0;
#pragma unroll 16
  for (int64_t i = lane; i < k; i += 32) {
    h += __ldcg(t.part_h + cb + i);
    tot += __ldcg(reinterpret_cast<const long long*>(t.part_total + cb + i));
    nz += __ldcg(reinterpret_cast<const long long*>(t.part_nnz + cb + i));
  }
  warp_sum(h, tot, nz);
  if (lane == 0) {
    t.h[s] = 0.0 - h;
    t.total[s] = tot;
    t.nnz[s] = nz;
  }
}

}  // namespace

// table: host pointer to one EntropyTable (copied into the launch's
// parameters). Zeroes the tickets, then launches one warp per chunk on
// `stream`. Returns the first cudaError_t met (0 on success). Nothing here
// waits for the device.
extern "C" int delphi_entropy_terms(const void* table, void* stream) {
  const EntropyTable& t = *static_cast<const EntropyTable*>(table);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t.n_segments < 1 || t.n_chunks < t.n_segments || t.chunk < 1 ||
      (t.mode == 1 && t.n_segments > kInline)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (t.tickets != nullptr) {
    const cudaError_t err = cudaMemsetAsync(
        t.tickets, 0, static_cast<size_t>(t.n_segments) * sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid =
      static_cast<unsigned>((t.n_chunks + kWarps - 1) / kWarps);
  entropy_terms_kernel<<<grid, kThreads, 0, s>>>(t);
  return static_cast<int>(cudaGetLastError());
}
