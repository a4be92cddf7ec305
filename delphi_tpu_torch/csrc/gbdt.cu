// K3 + K4: the GBDT tree builder's per-level programs and the boosted
// predictor.
//
// Replace the jitted XLA programs of delphi_tpu/models/gbdt.py (not
// Pallas): the histogram, split search and routing of _build_tree (:106,
// one level of its loop :157-218, the leaf sums :220-222), and
// _predict_tree / _predict_boosted (:230, :373). On the TPU each level is
// one fused XLA program whose histograms are one-hot matmuls; here each
// level is three launches.
//
// Every float result is bit for bit the plain PyTorch version's
// (delphi_tpu_torch/ops/kernels/gbdt.py), which is the order the JAX
// package's CPU route sums in:
//   K3a gbdt_hist    for each (tree t, node, feature f, bin b, channel c):
//                    0.0f, then + vals[t, row, c] for each row with
//                    node[t, row] == node and bins[m(t), row, f] == b, in
//                    increasing row order (m(t) = t / per_round). The leaf
//                    sums are the same call with one feature and one bin.
//   K3b gbdt_split   for each (t, node): the bin cumsum of every channel in
//                    XLA:CPU's blocked order (sequential in blocks of 16,
//                    the block totals scanned sequentially, each block's
//                    exclusive offset added), the split gain
//                    (GL*GL/(HL+lam) + GR*GR/(HR+lam)) - G*G/(H+lam), the
//                    min_child_weight / min_child_samples masks, -inf on
//                    the last bin, then the first maximum over the
//                    feature-major flattening with torch.argmax's rule (a
//                    NaN is the maximum), best_gain > min_split_gain, and
//                    the sentinel (feature 0, threshold n_bins).
//   K3c gbdt_route   node <- 2 * node + (bins[m(t), row, feat] > thr).
//   K4 gbdt_predict  for each (class tree t, row): base[t], then + the
//                    leaf of each round's tree, round by round (__fadd_rn).
// No float atomics, and every f32 operation is an explicitly rounded
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn): nvcc at -O3
// would otherwise contract a*b+c into one FMA and move the gain by an ulp,
// which flips near-tie splits.
//
// What bounds them on an H100. K3a: by bytes, each input read once
// (T * n * (4C + 4) bytes plus the bins), each output written once; its
// order rule adds a second floor: each bin's sum is a chain of dependent
// adds in row order, so no call is faster than its longest chain (the
// rows of its fullest (tree, node, feature, bin)) times an add's latency.
// Design: one block per (tree, node, feature). The block reads its tree's
// node ids 1,024 a window through a ring of cp.async copies three windows
// ahead, and compacts its node's row indices into a stage in row order
// (a block scan of each thread's four rows). Each stage of up to 2,048
// rows is one round: the rows' bins are copied in; each warp ranks its
// run of rows within their bins (__match_any_sync and the popcount of the
// lower peers, a per-warp count carried from 32 rows to the next); an
// exclusive scan over (bin, warp) gives each warp's offset in each bin;
// each row's channels are copied straight from global memory into its
// place in bin order, one vector a row; and thread b adds bin b's segment
// to its sums in registers, two batches of rows taking turns between
// loading and adding. Every bin's segment keeps row order, so a thread
// walks its own bin's rows only, and the sums carry across rounds in
// shared memory. Grouping features in a block (the node's rows compacted
// once for several features) was measured slower on the main path's own
// calls: a group's skewed bins are walked one feature after another.
// K3b: a block per (tree, node), a thread per (feature, bin) over
// chunks of features: the chunk's histograms staged in shared memory
// (the next chunk's loaded while this one is searched), each thread's
// inner prefix in its block of 16 bins (its loads first, then at most 16
// adds), the block totals scanned by a thread per (feature, channel), the
// gain and masks per (feature, bin), and the first maximum by a reduction
// with a comparison that is a total order (NaN first, then value, then
// lower index), so the tree of the reduction does not change the winner.
// K3c: by bytes on paper (a node id in and out a (tree, row), one bin
// read a row), in practice by the launch and ramp of a grid of rows x
// trees, close to the empty kernel's time at the main path's shapes. A
// thread per (tree, row) (the first design);
// staging the level's splits and the rows' bins in shared memory, reading
// a row's bins into registers beside its node id, and a thread per (row,
// group of trees) each cut its chain of dependent loads and were each
// measured no faster (PERF.md).
// K4: by its instructions (a handful a node visit, R * T * n * depth
// visits); the bytes are a small share of that. A block per (group of class
// trees, share of the row tiles), a thread per row of a tile, one wave of
// resident blocks. A group's trees whose words and leaves fit 32 KB are
// staged once into shared memory, one 32-bit word a node (a depth-5
// tree's 31 words in 31 banks), and the block then walks its tiles with
// no barrier; larger trees come a chunk of rounds at a time, the next
// chunk's splits and leaves copied in by cp.async while this one is
// walked. A row of at most four features whose bins fit a byte holds them
// in one register, picked by prmt, so a node visit reads shared memory
// once (its word); wider rows stage their bins in their own column of
// shared memory. Each thread walks four rounds of a tree at once and adds
// their leaves to the tree's margin in round order (__fadd_rn). The bins
// are the binner's codes, in [0, kMaxBins): a byte, so both routes compare
// them exactly (ops/kernels/gbdt.py predict states that contract).
//
// Each entry point takes a host pointer to its parameter table (mirrored
// by a ctypes.Structure in ops/kernels/gbdt.py) and the stream, launches
// once and returns cudaGetLastError(). Nothing waits for the device.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kHistThreads = 256;              // 8 warps
constexpr int kWarps = kHistThreads / 32;
constexpr int kWindow = 4 * kHistThreads;      // node ids a window scans, 4 a thread
constexpr int kRing = 4;                       // windows of node ids in flight
constexpr int kStage = 2048;                   // rows a round buckets
constexpr int kPieces = kStage / kHistThreads; // 32-row pieces a warp ranks
constexpr int kMaxBins = 256;                  // a thread per bin
constexpr int kSplitThreads = 512;
constexpr int kBlock = 16;                     // XLA:CPU's scan block
constexpr int kMaxChannels = 4;
constexpr size_t kStaticSmem = 48 * 1024;

struct HistParams {
  const float* vals;     // [T, n, C]
  const int32_t* node;   // [T, n]; null: every row at node 0
  const int64_t* bins;   // [models, n, d]; null: d = 1, every row in bin 0
  float* out;            // [T, levels, d, n_bins, C]
  int64_t n;
  int32_t trees;
  int32_t levels;        // nodes of the level
  int32_t d;
  int32_t n_bins;
  int32_t channels;
  int32_t per_round;     // tree t reads model t / per_round
  int32_t models;        // 1: every tree reads model 0
  int32_t pad;
};

struct SplitParams {
  const float* hist;     // [T, levels, d, n_bins, C]
  const float* lam;      // [T] or null: lam_s
  const float* msg;
  const float* mcw;
  const float* mcs;
  int64_t* feat;         // [T, nodes - 1]
  int64_t* thr;
  float lam_s;
  float msg_s;
  float mcw_s;
  float mcs_s;
  int32_t trees;
  int32_t levels;
  int32_t d;
  int32_t n_bins;
  int32_t channels;
  int32_t w_slot;        // -1: no min_child_weight mask
  int32_t c_slot;        // -1: no counts channel
  int32_t width;         // nodes - 1 (the row stride of feat / thr)
};

struct RouteParams {
  const int32_t* node;   // [T, n]; null: every row at node 0
  const int64_t* bins;   // [models, n, d]
  const int64_t* feat;   // [T, width]
  const int64_t* thr;
  int32_t* out;          // [T, n]
  int64_t n;
  int32_t trees;
  int32_t d;
  int32_t offset;        // 2^level - 1
  int32_t width;
  int32_t per_round;
  int32_t models;
};

struct PredictParams {
  const int64_t* bins;   // [n, d]
  const int64_t* feats;  // [R, T, nodes - 1]
  const int64_t* thrs;
  const float* leaves;   // [R, T, nodes]
  const float* base;     // [T]
  float* out;            // [T, n]
  int64_t n;
  int32_t trees;
  int32_t d;
  int32_t rounds;
  int32_t depth;
};

// ---------------------------------------------------------------------------
// K3a
// ---------------------------------------------------------------------------

// A staged row in bin order: its C channels as one vector (3 padded to
// 4), so that the walk loads a row at once.
template <int C>
struct Row {  // 3 or 4 channels
  using T = float4;
  __device__ static void add(float* acc, T v) {
    acc[0] = __fadd_rn(acc[0], v.x);
    acc[1] = __fadd_rn(acc[1], v.y);
    acc[2] = __fadd_rn(acc[2], v.z);
    if (C == 4) acc[3] = __fadd_rn(acc[3], v.w);
  }
};
template <>
struct Row<1> {
  using T = float;
  __device__ static void add(float* acc, T v) { acc[0] = __fadd_rn(acc[0], v); }
};
template <>
struct Row<2> {
  using T = float2;
  __device__ static void add(float* acc, T v) {
    acc[0] = __fadd_rn(acc[0], v.x);
    acc[1] = __fadd_rn(acc[1], v.y);
  }
};

__host__ __device__ constexpr int row_words(int C) { return C == 3 ? 4 : C; }

// The dynamic shared memory of one K3a block in 4-byte words, its 16-byte
// parts first: s_rows [kStage, row_words(C)] (the staged rows' channels in
// bin order), s_ids [kRing, kWindow] (node ids in flight; none at the
// root), s_acc [n_bins, C] (the sums, carried across rounds), s_bin
// [kStage] (the staged rows' bins: the low word of each int64), s_row
// [kStage] (their row indices), s_cnt [kWarps, n_bins] (a warp's rows per
// bin, then its offset in each bin), s_start [n_bins + 1] (each bin's
// segment).
size_t hist_smem(int C, int B, bool ring) {
  return 4 * (static_cast<size_t>(kStage) * row_words(C) + (ring ? kRing * kWindow : 0) +
              B * C + 2 * kStage + kWarps * B + B + 1);
}

#ifdef DELPHI_GBDT_PHASE_CLOCKS
// Measurement builds only (chip_smoke.py --gbdt-probe
// -DDELPHI_GBDT_PHASE_CLOCKS): thread 0's cycles in each phase of the
// slowest block of a launch. Phases: 0 node-id windows, 1 the bins copied
// in, 2 ranking, 3 the scan over (bin, warp), 4 the rows placed in bin
// order, 5 the walk, 6 the output; then the slowest block's total and the
// blocks counted.
constexpr int kPhases = 7;
__device__ unsigned long long g_hist_clocks[kPhases + 2];
__shared__ long long s_clk[kPhases + 1];  // the phases, then the last clock read
__device__ __forceinline__ void phase(int i) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    s_clk[i] += now - s_clk[kPhases];
    s_clk[kPhases] = now;
  }
}
#else
__device__ __forceinline__ void phase(int) {}
#endif

// A copy of 4, 8 or 16 bytes from global to shared memory, left in
// flight (cp.async); wait_copies() waits for every copy of the calling
// thread and makes them visible to it.
template <int Bytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(at), "l"(src), "n"(Bytes)
               : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A row's C channels into its slot of s_rows: one copy when C is 2 or 4
// and the channels are aligned to it (wide), else a copy a channel.
template <int C>
__device__ __forceinline__ void fetch_row(void* dst, const float* src, bool wide) {
  if ((C == 2 || C == 4) && wide) {
    copy_async<4 * C>(dst, src);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) copy_async<4>(static_cast<float*>(dst) + c, src + c);
  }
}

// The exclusive prefix sum of v over the block's threads in thread order,
// and its total in *sum (every thread calls it; s_scan holds kWarps ints
// and is free again after the caller's next __syncthreads()).
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_scan, int* sum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_scan[warp] = x;
  __syncthreads();
  int before = 0;
  int all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = s_scan[w];
    before += w < warp ? t : 0;
    all += t;
  }
  *sum = all;
  return before + x - v;
}

// Adds rows [k0, k1) of v to acc in order. Each add waits on the one
// before it; the loads do not: two batches of rows (48 words or fewer)
// take turns, one added while the other is loaded.
template <int C>
__device__ __forceinline__ void walk(float* acc, const typename Row<C>::T* v, int k0, int k1) {
  constexpr int kWalk = C >= 3 ? 6 : 8;
  using V = typename Row<C>::T;
  int k = k0;
  if (k + 2 * kWalk <= k1) {
    V a[kWalk];
    V b[kWalk];
#pragma unroll
    for (int u = 0; u < kWalk; ++u) a[u] = v[k + u];
#pragma unroll
    for (int u = 0; u < kWalk; ++u) b[u] = v[k + kWalk + u];
    for (k += 2 * kWalk; k + 2 * kWalk <= k1; k += 2 * kWalk) {
#pragma unroll
      for (int u = 0; u < kWalk; ++u) Row<C>::add(acc, a[u]);
#pragma unroll
      for (int u = 0; u < kWalk; ++u) a[u] = v[k + u];
#pragma unroll
      for (int u = 0; u < kWalk; ++u) Row<C>::add(acc, b[u]);
#pragma unroll
      for (int u = 0; u < kWalk; ++u) b[u] = v[k + kWalk + u];
    }
#pragma unroll
    for (int u = 0; u < kWalk; ++u) Row<C>::add(acc, a[u]);
#pragma unroll
    for (int u = 0; u < kWalk; ++u) Row<C>::add(acc, b[u]);
  }
  for (; k < k1; ++k) Row<C>::add(acc, v[k]);
}

// One round of a K3a block over `total` staged rows in row order (rows
// base + i at the root, else s_row[i]): their bins copied in, a stable
// bucketing by bin (each row's rank among the earlier rows of its bin in
// its warp's run from __match_any_sync, each warp's offset in each bin from
// an exclusive scan over (bin, warp)), each row's channels copied straight
// into its place in bin order, and thread b adding bin b's segment, in row
// order, to its sums.
template <int C>
__device__ __forceinline__ void hist_round(const HistParams& p, const float* vals,
                                           const int64_t* bins, bool wide, int64_t base,
                                           int total, float* s_acc, int32_t* s_bin,
                                           const int32_t* s_row, int32_t* s_cnt,
                                           int32_t* s_start, int32_t* s_scan, float* s_rows) {
  using V = typename Row<C>::T;
  const int B = p.n_bins;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  V* rows = reinterpret_cast<V*>(s_rows);
  phase(0);
  if (base < 0) __syncthreads();  // s_row is complete
  if (B == 1) {
    // one bin: the staged rows are its segment, in row order
    for (int i = tid; i < total; i += kHistThreads) {
      fetch_row<C>(rows + i, vals + (base < 0 ? s_row[i] : base + i) * C, wide);
    }
    wait_copies();
    __syncthreads();
    phase(1);
    if (tid == 0) {
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = s_acc[c];
      walk<C>(acc, rows, 0, total);
#pragma unroll
      for (int c = 0; c < C; ++c) s_acc[c] = acc[c];
    }
    __syncthreads();
    phase(5);
    return;
  }
  for (int i = tid; i < total; i += kHistThreads) {
    if (bins == nullptr) {
      s_bin[i] = 0;  // no bins: every row in bin 0
    } else {
      copy_async<4>(s_bin + i, bins + (base < 0 ? s_row[i] : base + i) * p.d);
    }
  }
  for (int i = tid; i < kWarps * B; i += kHistThreads) s_cnt[i] = 0;
  wait_copies();
  __syncthreads();
  phase(1);
  // warp w ranks the staged rows [lo, hi), 32 at a time
  const int chunk = (total + kHistThreads - 1) / kHistThreads * 32;
  const int lo = warp * chunk;
  const int hi = min(total, lo + chunk);
  const unsigned below = (1u << lane) - 1u;
  int rank[kPieces];
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const int i = lo + j * 32 + lane;
    if (lo + j * 32 < hi) {  // warp-uniform
      const bool on = i < hi;
      const int b = on ? s_bin[i] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, b);
      const int before = on ? s_cnt[warp * B + b] : 0;
      __syncwarp();
      if (on && (peers & below) == 0) s_cnt[warp * B + b] = before + __popc(peers);
      __syncwarp();
      rank[j] = before + __popc(peers & below);
    }
  }
  __syncthreads();
  phase(2);
  // each warp's offset in each bin
  int count = 0;
  if (tid < B) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) count += s_cnt[w * B + tid];
  }
  int staged = 0;
  const int start = block_exclusive_scan(count, s_scan, &staged);
  if (tid < B) {
    int run = start;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_cnt[w * B + tid];
      s_cnt[w * B + tid] = run;
      run += c;
    }
    s_start[tid] = start;
    if (tid == B - 1) s_start[B] = run;
  }
  __syncthreads();
  phase(3);
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const int i = lo + j * 32 + lane;
    if (i < hi) {
      fetch_row<C>(rows + s_cnt[warp * B + s_bin[i]] + rank[j],
                   vals + (base < 0 ? s_row[i] : base + i) * C, wide);
    }
  }
  wait_copies();
  __syncthreads();
  phase(4);
  if (tid < B) {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = s_acc[tid * C + c];
    walk<C>(acc, rows, s_start[tid], s_start[tid + 1]);
#pragma unroll
    for (int c = 0; c < C; ++c) s_acc[tid * C + c] = acc[c];
  }
  __syncthreads();  // the stage is free for the next round
  phase(5);
}

template <int C>
__global__ void __launch_bounds__(kHistThreads, 3)
gbdt_hist_kernel(const HistParams p) {
  extern __shared__ __align__(16) unsigned char hist_smem_[];
  __shared__ int32_t s_scan[2 * kWarps];  // block scans, two in turn
  const int B = p.n_bins;
  const int tid = threadIdx.x;
  int64_t task = blockIdx.x;
  const int f = static_cast<int>(task % p.d);
  task /= p.d;
  const int nd = static_cast<int>(task % p.levels);
  const int t = static_cast<int>(task / p.levels);

  float* s_rows = reinterpret_cast<float*>(hist_smem_);
  int32_t* s_ids = reinterpret_cast<int32_t*>(s_rows + kStage * row_words(C));
  float* s_acc = reinterpret_cast<float*>(s_ids + (p.node == nullptr ? 0 : kRing * kWindow));
  int32_t* s_bin = reinterpret_cast<int32_t*>(s_acc + B * C);
  int32_t* s_row = s_bin + kStage;
  int32_t* s_cnt = s_row + kStage;
  int32_t* s_start = s_cnt + kWarps * B;

  for (int i = tid; i < B * C; i += kHistThreads) s_acc[i] = 0.0f;
#ifdef DELPHI_GBDT_PHASE_CLOCKS
  if (tid < kPhases) s_clk[tid] = 0;
  if (tid == 0) s_clk[kPhases] = clock64();
#endif

  const int model = p.models == 1 ? 0 : t / p.per_round;
  // one bin needs no bins: every row is in bin 0
  const int64_t* bins = p.bins == nullptr || B == 1
                            ? nullptr
                            : p.bins + static_cast<int64_t>(model) * p.n * p.d + f;
  const int32_t* node = p.node == nullptr ? nullptr : p.node + static_cast<int64_t>(t) * p.n;
  const float* vals = p.vals + static_cast<int64_t>(t) * p.n * C;
  const bool wide = reinterpret_cast<uintptr_t>(p.vals) % (4 * C) == 0;

  if (node == nullptr) {
    // the root: every row at node 0, a round for each kStage rows
    for (int64_t base = 0; base < p.n; base += kStage) {
      const int64_t left = p.n - base;
      hist_round<C>(p, vals, bins, wide, base, static_cast<int>(left < kStage ? left : kStage),
                    s_acc, s_bin, s_row, s_cnt, s_start, s_scan, s_rows);
    }
  } else {
    // window w's node ids go to ring slot w % kRing, kRing - 1 windows
    // ahead; a thread copies (and alone reads) rows base + 4 t .. + 3
    const bool ids16 = reinterpret_cast<uintptr_t>(node) % 16 == 0;
    const int64_t windows = (p.n + kWindow - 1) / kWindow;
    auto fetch_ids = [&](int64_t w) {
      if (w < windows) {
        const int64_t row = w * kWindow + 4 * tid;
        int32_t* dst = s_ids + (w % kRing) * kWindow + 4 * tid;
        if (ids16 && row + 4 <= p.n) {
          copy_async<16>(dst, node + row);
        } else {
          for (int j = 0; j < 4 && row + j < p.n; ++j) copy_async<4>(dst + j, node + row + j);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    for (int w = 0; w < kRing - 1; ++w) fetch_ids(w);
    int total = 0;  // rows staged for the next round (the same in every thread)
    for (int64_t w = 0; w < windows; ++w) {
      fetch_ids(w + kRing - 1);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
      const int64_t base = w * kWindow + 4 * tid;
      const int32_t* ids = s_ids + (w % kRing) * kWindow + 4 * tid;
      // the window's rows of the node, appended to the stage in row order
      unsigned in = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (base + j < p.n && ids[j] == nd) in |= 1u << j;
      }
      int count = 0;
      int at = total + block_exclusive_scan(__popc(in), s_scan + (w & 1) * kWarps, &count);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (in & (1u << j)) s_row[at++] = static_cast<int32_t>(base + j);
      }
      total += count;
      if (total > kStage - kWindow || (w + 1 == windows && total > 0)) {
        hist_round<C>(p, vals, bins, wide, -1, total, s_acc, s_bin, s_row, s_cnt, s_start, s_scan,
                      s_rows);
        total = 0;
      }
    }
  }
  phase(0);
  __syncthreads();
  float* out = p.out + ((static_cast<int64_t>(t) * p.levels + nd) * p.d + f) * B * C;
  for (int i = tid; i < B * C; i += kHistThreads) out[i] = s_acc[i];
#ifdef DELPHI_GBDT_PHASE_CLOCKS
  phase(6);
  if (tid == 0) {
    unsigned long long all = 0;
    for (int i = 0; i < kPhases; ++i) all += s_clk[i];
    if (all > atomicMax(&g_hist_clocks[kPhases], all)) {
      for (int i = 0; i < kPhases; ++i) {
        atomicExch(&g_hist_clocks[i], static_cast<unsigned long long>(s_clk[i]));
      }
    }
    atomicAdd(&g_hist_clocks[kPhases + 1], 1ull);
  }
#endif
}

// ---------------------------------------------------------------------------
// K3b
// ---------------------------------------------------------------------------

__device__ __forceinline__ float hyper(const float* v, float s, int t) {
  return v == nullptr ? s : v[t];
}

// torch.argmax's order: a NaN beats every number (the lower index among
// NaNs), else the larger value, ties to the lower index.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  if (isnan(b)) return false;
  return a == b ? ia < ib : a > b;
}

// The bin cumsums follow _blocked_cumsum of the plain version: n <= 16
// bins is one sequential scan from x[0] + 0; past it the row is padded
// with zeros to whole blocks of 16, each block scanned from its first
// element + 0, the block totals scanned the same way, and each prefix is
// its block's prefix + the earlier blocks' total (0 for the first block).
// Thread (f, j) of a chunk computes bin j's inner prefix in its block
// (at most 16 adds a channel); a thread per (f, channel) scans the at
// most 16 block totals, the padding of a partial last block included.
__global__ void __launch_bounds__(kSplitThreads)
gbdt_split_kernel(const SplitParams p) {
  __shared__ float s_h[kSplitThreads * kMaxChannels];     // histograms, then inner prefixes
  __shared__ float s_excl[kSplitThreads * kMaxChannels];  // each block's exclusive offset
  __shared__ float s_tot[kSplitThreads * kMaxChannels];   // each feature's totals
  __shared__ float s_gain[kSplitThreads / 32];
  __shared__ int s_idx[kSplitThreads / 32];
  const int nd = blockIdx.x % p.levels;
  const int t = blockIdx.x / p.levels;
  const int B = p.n_bins;
  const int C = p.channels;
  const int per = blockDim.x / B;             // features a chunk
  const int m = (B + kBlock - 1) / kBlock;    // blocks of 16 bins
  const int fl = threadIdx.x / B;
  const int j = threadIdx.x % B;
  const int blk = j / kBlock;
  const float lam = hyper(p.lam, p.lam_s, t);
  const float mcw = hyper(p.mcw, p.mcw_s, t);
  const float mcs = hyper(p.mcs, p.mcs_s, t);
  const float neg_inf = -CUDART_INF_F;
  const int ws = p.w_slot < 0 ? 0 : p.w_slot;
  const int cs = p.c_slot < 0 ? 0 : p.c_slot;
  const float* hist = p.hist + (static_cast<int64_t>(t) * p.levels + nd) * p.d * B * C;

  // a thread's share of a chunk's histograms: at most kMaxChannels values
  // (a chunk is at most blockDim.x / B features of B * C values)
  float next[kMaxChannels];
  auto load = [&](int f0) {
    const int len = min(per, p.d - f0) * B * C;
    const float* h = hist + static_cast<int64_t>(f0) * B * C;
#pragma unroll
    for (int q = 0; q < kMaxChannels; ++q) {
      const int e = q * blockDim.x + threadIdx.x;
      next[q] = e < len ? h[e] : 0.0f;
    }
  };
  load(0);
  float best = neg_inf;
  int best_i = 0x7fffffff;
  for (int f0 = 0; f0 < p.d; f0 += per) {
    const int fc = min(per, p.d - f0);
    const bool on = fl < fc;
#pragma unroll
    for (int q = 0; q < kMaxChannels; ++q) s_h[q * blockDim.x + threadIdx.x] = next[q];
    if (f0 + per < p.d) load(f0 + per);  // in flight while this chunk is searched
    __syncthreads();
    float v[kMaxChannels];
    if (on) {
      // bin j's prefix in its block of 16: its loads first, then the adds
      const float* x = s_h + (fl * B + blk * kBlock) * C;
      const int jj = j - blk * kBlock;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        v[c] = 0.0f;
        if (c < C) {
          float xs[kBlock];
#pragma unroll
          for (int u = 0; u < kBlock; ++u) xs[u] = u <= jj ? x[u * C + c] : 0.0f;
          float acc = __fadd_rn(xs[0], 0.0f);
#pragma unroll
          for (int u = 1; u < kBlock; ++u) {
            if (u <= jj) acc = __fadd_rn(acc, xs[u]);
          }
          v[c] = acc;
        }
      }
    }
    __syncthreads();
    if (on) {
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c < C) s_h[(fl * B + j) * C + c] = v[c];
      }
    }
    __syncthreads();
    if (B > kBlock && threadIdx.x < fc * C) {
      const int ff = threadIdx.x / C;
      const int c = threadIdx.x % C;
      const float* inner = s_h + ff * B * C + c;
      float outer = 0.0f;
      for (int i = 0; i < m; ++i) {
        const int last = i * kBlock + kBlock - 1;
        const float tot = last < B ? inner[last * C] : __fadd_rn(inner[(B - 1) * C], 0.0f);
        s_excl[(ff * m + i) * C + c] = outer;
        outer = i == 0 ? __fadd_rn(tot, 0.0f) : __fadd_rn(outer, tot);
      }
    }
    __syncthreads();
    if (on) {
      if (B > kBlock) {
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c) {
          if (c < C) v[c] = __fadd_rn(v[c], s_excl[(fl * m + blk) * C + c]);
        }
      }
      if (j == B - 1) {
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c) {
          if (c < C) s_tot[fl * C + c] = v[c];
        }
      }
    }
    __syncthreads();
    if (on) {
      const float* tot = s_tot + fl * C;
      const float G = tot[0], H = tot[1], W = tot[ws], Ct = tot[cs];
      const float parent = __fdiv_rn(__fmul_rn(G, G), __fadd_rn(H, lam));
      const float gL = v[0], hL = v[1];
      const float gR = __fsub_rn(G, gL), hR = __fsub_rn(H, hL);
      float gain = __fsub_rn(
          __fadd_rn(__fdiv_rn(__fmul_rn(gL, gL), __fadd_rn(hL, lam)),
                    __fdiv_rn(__fmul_rn(gR, gR), __fadd_rn(hR, lam))),
          parent);
      bool ok = true;
      if (p.w_slot >= 0) {
        const float wL = v[ws], wR = __fsub_rn(W, wL);
        ok = wL >= mcw && wR >= mcw;
      }
      if (p.c_slot >= 0) {
        const float cL = v[cs], cR = __fsub_rn(Ct, cL);
        ok = ok && cL >= mcs && cR >= mcs;
      }
      if (!ok || j == B - 1) gain = neg_inf;
      const int idx = (f0 + fl) * B + j;
      if (better(gain, idx, best, best_i)) {
        best = gain;
        best_i = idx;
      }
    }
    __syncthreads();  // the chunk's shared memory is free
  }
  // the block's first maximum
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(og, oi, best, best_i)) {
      best = og;
      best_i = oi;
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_gain[warp] = best;
    s_idx[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w) {
      if (better(s_gain[w], s_idx[w], best, best_i)) {
        best = s_gain[w];
        best_i = s_idx[w];
      }
    }
    const bool split = best > hyper(p.msg, p.msg_s, t);
    const int64_t at = static_cast<int64_t>(t) * p.width + (p.levels - 1) + nd;
    p.feat[at] = split ? best_i / B : 0;
    p.thr[at] = split ? best_i % B : B;
  }
}

// ---------------------------------------------------------------------------
// K3c
// ---------------------------------------------------------------------------

constexpr int kRouteThreads = 256;

// A thread per (tree, row): the node id, then the node's split, then the
// bin at its feature, three dependent loads through L1. Staging the level's
// splits and the rows' bins in shared memory behind one barrier, reading a
// row's bins into registers beside its node id, and a thread per (row,
// group of trees) were each measured no faster at the main path's shapes
// (a call is the launch and ramp of a grid of rows x trees, not its chain
// of loads; PERF.md).
__global__ void __launch_bounds__(kRouteThreads)
gbdt_route_kernel(const RouteParams p) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= p.n) return;
  const int t = blockIdx.y;
  const int64_t at = static_cast<int64_t>(t) * p.n + row;
  const int32_t nd = p.node == nullptr ? 0 : p.node[at];
  const int model = p.models == 1 ? 0 : t / p.per_round;
  const int64_t k = static_cast<int64_t>(t) * p.width + p.offset + nd;
  const int64_t f = __ldg(p.feat + k);
  const int64_t b = __ldg(p.bins + (static_cast<int64_t>(model) * p.n + row) * p.d + f);
  p.out[at] = 2 * nd + (b > __ldg(p.thr + k) ? 1 : 0);
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

constexpr int kPredictThreads = 256;       // rows of a K4 tile, a thread each
constexpr int kPredictGroup = 8;           // most class trees of a block
constexpr int kResidentBytes = 32 * 1024;  // a group's trees staged once when they fit
constexpr int kNodeBudget = 1024;          // else split words a chunk of rounds stages
constexpr int kBinsBudget = 8192;          // staged bins of a tile past one warp's rows
constexpr int kWalk = 4;                   // traversals a thread walks at once
constexpr int kMaxDepth = 10;
constexpr int kMaxPredictFeatures = 1024;

// A split as one 32-bit word, t << 16 | where. t = clamp(thr + 1, 0,
// 65535): for a bin b in [0, kMaxBins), b >= t exactly when b > thr,
// whatever the int64 thr. where: the prmt selector 0x6054 | f << 8 of the row's
// bins as bytes (bytes), or the feature's offset f * tile in the staged
// bins. A feature outside [0, d) is clamped into it (the plain version
// raises on one).
__device__ __forceinline__ uint32_t predict_word(int64_t f, int64_t thr, int d, int tile,
                                                 bool bytes) {
  const uint32_t fc = static_cast<uint32_t>(f < 0 ? 0 : (f < d ? f : d - 1));
  const uint32_t t = thr < 0 ? 0u : (thr >= 65535 ? 65535u : static_cast<uint32_t>(thr + 1));
  return (t << 16) | (bytes ? 0x6054u | fc << 8 : fc * static_cast<uint32_t>(tile));
}

// The dynamic shared memory of one K4 block in bytes: the split words of
// a chunk of rc rounds [rc, group, W] (first, at a fixed address); when
// the rounds come in several chunks, the raw int64 splits of one
// (features, then thresholds) and two leaf buffers [rc, group, W + 1],
// else one; the rows' staged bins [d, tile] (not when the bins are bytes
// in a register) and the margins [group, tile].
size_t predict_smem(int rc, int group, int W, int d, int tile, bool resident, bool bytes) {
  const size_t cap = static_cast<size_t>(rc) * group * W;
  const size_t lcap = static_cast<size_t>(rc) * group * (W + 1);
  return ((4 * cap + 15) & ~static_cast<size_t>(15)) + (resident ? 0 : 16 * cap) +
         (resident ? 4 : 8) * lcap + (bytes ? 0 : 4 * static_cast<size_t>(d) * tile) +
         4 * static_cast<size_t>(group) * tile;
}

// A word of the split table read at a byte offset (the table sits at the
// start of the dynamic shared memory).
__device__ __forceinline__ uint32_t word_at(const unsigned char* words, uint32_t at) {
  return *reinterpret_cast<const uint32_t*>(words + at);
}

// The bytes of {b, a} that `sel`'s four low nibbles pick (prmt.b32; the
// nibbles here are all below 8, and the high half of sel is not read).
__device__ __forceinline__ uint32_t byte_pick(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// N traversals of one tree by one thread, interleaved: the tree's items
// (rounds) r0 .. r0 + N - 1 of a staged chunk, r * tg + u, whose leaves are
// added to acc in round order. A traversal holds the byte offset of its
// node's word, at = 4 * (first + k) for node k of the item's tree, so a
// level is: the word (t << 16 | where), the row's bin at `where` as b << 16
// | 0xffff, one unsigned compare of the two, which is b >= t, and the
// child's offset 2 * at + 4 - 4 * first (+ 4 to the right). Bytes: the
// row's (at most four) bins are the bytes of `packed`, and `where` is the
// prmt selector that makes b << 16 | 0xffff of them; else `where` is the
// feature's offset in the staged bins (s_row, the row's column).
template <int N, bool Bytes>
__device__ __forceinline__ float walk_rounds(const unsigned char* words, const float* leaves,
                                             const uint32_t* s_row, uint32_t packed, float acc,
                                             int r0, int tg, int u, int W, int depth) {
  uint32_t at[N];
  uint32_t left[N];   // 4 - 4 * first: the left child is 2 * at + left
  uint32_t right[N];  // and the right one 2 * at + left + 4
#pragma unroll
  for (int q = 0; q < N; ++q) {
    at[q] = 4u * static_cast<uint32_t>(((r0 + q) * tg + u) * W);
    left[q] = 4u - at[q];
    right[q] = 8u - at[q];
  }
  for (int level = 0; level < depth; ++level) {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const uint32_t w = word_at(words, at[q]);
      const uint32_t b = Bytes ? byte_pick(packed, 0xffffu, w) : s_row[w & 0xffffu];
      at[q] = 2u * at[q] + (b >= w ? right[q] : left[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    // node k = at / 4 - item * W of the tree; its leaf k - W, at
    // item * (W + 1) + k - W = item + at / 4 - W
    acc = __fadd_rn(acc, leaves[(r0 + q) * tg + u + static_cast<int>(at[q] / 4u) - W]);
  }
  return acc;
}

// One thread's walks through a staged chunk of nr rounds of its block's
// tg class trees ([r, u] items): tree by tree, kWalk rounds at a time and
// the rest one by one, each leaf added to the tree's margin (s_acc[u *
// tile]) in round order.
template <bool Bytes>
__device__ __forceinline__ void walk_chunk(const unsigned char* words, const float* leaves,
                                           const uint32_t* s_row, uint32_t packed, float* s_acc,
                                           int tile, int tg, int nr, int W, int depth) {
  for (int u = 0; u < tg; ++u) {
    float acc = s_acc[u * tile];
    int r = 0;
    for (; r + kWalk <= nr; r += kWalk) {
      acc = walk_rounds<kWalk, Bytes>(words, leaves, s_row, packed, acc, r, tg, u, W, depth);
    }
    for (; r < nr; ++r) {
      acc = walk_rounds<1, Bytes>(words, leaves, s_row, packed, acc, r, tg, u, W, depth);
    }
    s_acc[u * tile] = acc;
  }
}

// A block per (group of class trees, share of the row tiles); a thread per
// row of a tile. A group's trees whose words and leaves fit kResidentBytes
// are staged once, packed straight from global memory, and the block then
// walks its tiles with no barrier; larger trees come through shared memory
// a chunk of rc rounds at a time (the next chunk's int64 splits and f32
// leaves copied in by cp.async while this one is walked, then packed), a
// tile at a time. A depth-5 tree's 31 words sit in 31 banks. Bytes (at
// most four features): the row's bins are the bytes of one register, so a
// level reads shared memory once; else they go to the row's column of
// shared memory ([feature, row]: a warp's 32 rows sit in 32 banks whatever
// features their nodes pick) as b << 16 | 0xffff.
//
// The bounds ask for one block an SM: ptxas then keeps the walk in 80
// registers; without the second bound it chose 48 and spilled, which
// measured slower.
template <bool Bytes>
__global__ void __launch_bounds__(kPredictThreads, 1)
gbdt_predict_kernel(const PredictParams p, const int group, const int rc) {
  extern __shared__ __align__(16) unsigned char predict_smem_[];
  const int tile = blockDim.x;
  const int tid = threadIdx.x;
  const int W = (1 << p.depth) - 1;
  const int t0 = blockIdx.y * group;
  const int tg = min(group, p.trees - t0);
  const int chunks = (p.rounds + rc - 1) / rc;
  const bool resident = chunks <= 1;
  const int cap = rc * group * W;
  const int lcap = rc * group * (W + 1);
  uint32_t* words = reinterpret_cast<uint32_t*>(predict_smem_);
  int64_t* raw_f = reinterpret_cast<int64_t*>(predict_smem_ + ((4 * cap + 15) & ~15));
  int64_t* raw_t = raw_f + (resident ? 0 : cap);
  float* leaves = reinterpret_cast<float*>(raw_t + (resident ? 0 : cap));
  uint32_t* s_bins = reinterpret_cast<uint32_t*>(leaves + (resident ? 1 : 2) * lcap);
  float* s_acc = reinterpret_cast<float*>(s_bins + (Bytes ? 0 : p.d * tile));

  // the splits of chunk c: raw (cp.async) or, resident, packed from global
  // memory; element i is (round r, place j of the tg trees' run), (r, j)
  // advancing by (tile / per, tile % per) with a carry
  auto splits = [&](int c, bool direct) {
    const int nr = min(rc, p.rounds - c * rc);
    const int per = tg * W;
    if (per == 0) return;
    const int64_t first = static_cast<int64_t>(c) * rc * p.trees + t0;
    const int64_t* feats = p.feats + first * W;
    const int64_t* thrs = p.thrs + first * W;
    const int dr = tile / per;
    const int dj = tile - dr * per;
    int r = tid / per;
    int j = tid - r * per;
#pragma unroll 4
    for (int i = tid; i < nr * per; i += tile) {
      const int64_t src = static_cast<int64_t>(r) * p.trees * W + j;
      if (direct) {
        words[i] = predict_word(feats[src], thrs[src], p.d, tile, Bytes);
      } else {
        copy_async<8>(raw_f + i, feats + src);
        copy_async<8>(raw_t + i, thrs + src);
      }
      r += dr;
      j += dj;
      if (j >= per) {
        j -= per;
        ++r;
      }
    }
  };
  // the leaves of chunk c into buffer c & 1 (cp.async)
  auto leaf_copies = [&](int c) {
    const int nr = min(rc, p.rounds - c * rc);
    const int per = tg * (W + 1);
    const float* lv = p.leaves + (static_cast<int64_t>(c) * rc * p.trees + t0) * (W + 1);
    float* dst = leaves + (c & 1) * lcap;
    const int dr = tile / per;
    const int dj = tile - dr * per;
    int r = tid / per;
    int j = tid - r * per;
    for (int i = tid; i < nr * per; i += tile) {
      copy_async<4>(dst + i, lv + static_cast<int64_t>(r) * p.trees * (W + 1) + j);
      r += dr;
      j += dj;
      if (j >= per) {
        j -= per;
        ++r;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto stage = [&](int c) {
    splits(c, false);
    leaf_copies(c);
  };
  auto pack = [&](int c) {
    const int n_words = min(rc, p.rounds - c * rc) * tg * W;
    for (int i = tid; i < n_words; i += tile) {
      words[i] = predict_word(raw_f[i], raw_t[i], p.d, tile, Bytes);
    }
  };

  if (resident && chunks > 0) {
    leaf_copies(0);
    splits(0, true);
    wait_copies();
    __syncthreads();
  }
  const int64_t tiles = (p.n + tile - 1) / tile;
  for (int64_t tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
    const int64_t row = tl * tile + tid;
    const bool on = row < p.n;
    uint32_t packed = 0;  // the row's bins, a byte each (Bytes)
    if (on) {
      const int64_t* b = p.bins + row * p.d;
#pragma unroll 4
      for (int f = 0; f < p.d; ++f) {
        const uint32_t v = static_cast<uint32_t>(b[f]);
        if (Bytes) {
          packed |= (v & 0xffu) << (8 * f);
        } else {
          s_bins[f * tile + tid] = (v << 16) | 0xffffu;
        }
      }
    }
    for (int u = 0; u < tg; ++u) s_acc[u * tile + tid] = __ldg(p.base + t0 + u);
    if (resident) {
      if (on && chunks > 0) {
        walk_chunk<Bytes>(reinterpret_cast<const unsigned char*>(words), leaves, s_bins + tid,
                          packed, s_acc + tid, tile, tg, p.rounds, W, p.depth);
      }
    } else {
      stage(0);
      wait_copies();
      __syncthreads();
      pack(0);
      __syncthreads();
      for (int c = 0; c < chunks; ++c) {
        if (c + 1 < chunks) stage(c + 1);
        if (on) {
          walk_chunk<Bytes>(reinterpret_cast<const unsigned char*>(words), leaves + (c & 1) * lcap,
                            s_bins + tid, packed, s_acc + tid, tile, tg,
                            min(rc, p.rounds - c * rc), W, p.depth);
        }
        if (c + 1 < chunks) {
          wait_copies();
          __syncthreads();
          pack(c + 1);
          __syncthreads();
        }
      }
      __syncthreads();  // the last chunk's walks are done before the next tile's copies
    }
    if (on) {
      for (int u = 0; u < tg; ++u) {
        p.out[static_cast<int64_t>(t0 + u) * p.n + row] = s_acc[u * tile + tid];
      }
    }
  }
}

// The SMs of the current device (cached per device).
int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || v < 1) {
      v = 132;
    }
    cached[dev] = v;
  }
  return cached[dev];
}

unsigned row_blocks(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

template <int C>
cudaError_t launch_hist(const HistParams& p, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(static_cast<int64_t>(p.trees) * p.levels * p.d);
  const size_t smem = hist_smem(C, p.n_bins, p.node != nullptr);
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        gbdt_hist_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gbdt_hist_kernel<C><<<grid, kHistThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <bool Bytes>
cudaError_t launch_predict(const PredictParams& p, cudaStream_t s) {
  const int W = (1 << p.depth) - 1;
  const int sms = sm_count();
  // a group's trees (words and leaves of every round) staged once when
  // they fit, of at most 8 trees; else chunks of rounds, the group no
  // larger than leaves a chunk kWalk rounds
  auto resident_bytes = [&](int g) {
    return 4 * static_cast<int64_t>(std::max(p.rounds, 1)) * g * (2 * W + 1);
  };
  int group = std::min(p.trees, kPredictGroup);
  while (group > 1 && resident_bytes(group) > kResidentBytes) group = (group + 1) / 2;
  int rc = std::max(p.rounds, 1);
  const bool resident = resident_bytes(group) <= kResidentBytes;
  if (!resident) {
    group = std::min(std::min(p.trees, kPredictGroup),
                     std::max(1, kNodeBudget / (kWalk * std::max(W, 1))));
    rc = std::max(1, std::min(p.rounds, kNodeBudget / std::max(group * W, 1)));
  }
  const int groups = (p.trees + group - 1) / group;
  // rows a tile: fewer as the rows widen (one warp's at the least)
  int tile = kPredictThreads;
  while (tile > 32 && static_cast<int64_t>(p.d) * tile > kBinsBudget) tile /= 2;
  const size_t smem = predict_smem(rc, group, W, p.d, tile, resident, Bytes);
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        gbdt_predict_kernel<Bytes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gbdt_predict_kernel<Bytes>, tile, smem);
  if (err != cudaSuccess) return err;
  // one wave of resident blocks, every SM holding as many, a group's
  // blocks taking its row tiles in turn
  const int64_t tiles = (p.n + tile - 1) / tile;
  const int64_t wave = std::max<int64_t>(1, static_cast<int64_t>(std::max(per_sm, 1)) * sms / groups);
  const dim3 grid(static_cast<unsigned>(std::min(tiles, wave)), static_cast<unsigned>(groups));
  gbdt_predict_kernel<Bytes><<<grid, tile, smem, s>>>(p, group, rc);
  return cudaGetLastError();
}

}  // namespace

extern "C" int delphi_gbdt_hist(const void* params, void* stream) {
  const HistParams& p = *static_cast<const HistParams*>(params);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.n_bins < 1 || p.n_bins > kMaxBins || p.d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (p.channels) {
    case 1: return static_cast<int>(launch_hist<1>(p, s));
    case 2: return static_cast<int>(launch_hist<2>(p, s));
    case 3: return static_cast<int>(launch_hist<3>(p, s));
    case 4: return static_cast<int>(launch_hist<4>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef DELPHI_GBDT_PHASE_CLOCKS
// Copies the clocks since the last call into out[kPhases + 2] and resets
// them (waits for the device).
extern "C" int delphi_gbdt_hist_clocks(unsigned long long* out) {
  unsigned long long zero[kPhases + 2] = {0};
  cudaError_t err = cudaMemcpyFromSymbol(out, g_hist_clocks, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_hist_clocks, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

extern "C" int delphi_gbdt_split(const void* params, void* stream) {
  const SplitParams& p = *static_cast<const SplitParams*>(params);
  if (p.n_bins < 1 || p.n_bins > kMaxBins || p.channels < 2 || p.channels > kMaxChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>(p.trees * p.levels);
  // a thread per (feature, bin), whole warps, at most kSplitThreads
  const int64_t want = (static_cast<int64_t>(p.d) * p.n_bins + 31) / 32 * 32;
  const int threads = static_cast<int>(want < kSplitThreads ? want : kSplitThreads);
  gbdt_split_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int delphi_gbdt_route(const void* params, void* stream) {
  const RouteParams& p = *static_cast<const RouteParams*>(params);
  const dim3 grid(row_blocks(p.n, kRouteThreads), static_cast<unsigned>(p.trees));
  gbdt_route_kernel<<<grid, kRouteThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int delphi_gbdt_predict(const void* params, void* stream) {
  const PredictParams& p = *static_cast<const PredictParams*>(params);
  if (p.d < 1 || p.d > kMaxPredictFeatures || p.depth < 0 || p.depth > kMaxDepth || p.trees < 1 ||
      p.rounds < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p.d <= 4 ? launch_predict<true>(p, s) : launch_predict<false>(p, s));
}
