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
//                    leaf of each round's tree, round by round.
// No float atomics, and every f32 operation is an explicitly rounded
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn): nvcc at -O3
// would otherwise contract a*b+c into one FMA and move the gain by an ulp,
// which flips near-tie splits.
//
// What bounds them on an H100. K3a: by bytes, each input read once
// (T * n * (4C + 4) bytes plus the bins), each output written once; its
// order constraint makes it latency bound instead: each bin's sum is a
// chain of dependent adds in row order. Design: one block per (t, node,
// f); the block scans its tree's node ids 1,024 rows a step, compacts the
// rows of its node in row order into shared memory (their bin and
// channel values), and warp w then walks the staged rows in order with
// lane l owning bin 32 w + l, its C sums in registers. Every block rescans
// its tree's node ids (4 bytes a row, from L2); that is the price of not
// partitioning the rows by node. K3b reads each histogram twice (the
// totals, then the gains) from L2: a thread per feature, a block per
// (t, node), the block's first maximum by a comparison that is a total
// order (NaN first, then value, then lower index). K3c and K4 are a thread
// per (tree, row) and read each row's bins where the traversal leads.
//
// Each entry point takes a host pointer to its parameter table (mirrored
// by a ctypes.Structure in ops/kernels/gbdt.py) and the stream, launches
// once and returns cudaGetLastError(). Nothing waits for the device.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kHistThreads = 256;              // 8 warps: 8 windows of 32 bins
constexpr int kRowsPerThread = 4;              // rows a thread stages a step
constexpr int kStage = kHistThreads * kRowsPerThread;
constexpr int kWarps = kHistThreads / 32;
constexpr int kMaxBins = 32 * kWarps;          // 256
constexpr int kSplitThreads = 128;
constexpr int kRowThreads = 256;
constexpr int kBlock = 16;                     // XLA:CPU's scan block
constexpr int kMaxChannels = 4;

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

template <int C>
__global__ void __launch_bounds__(kHistThreads)
gbdt_hist_kernel(const HistParams p) {
  __shared__ int32_t s_bin[kStage];
  __shared__ float s_val[kStage * C];
  __shared__ int32_t s_count[kRowsPerThread * kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t task = blockIdx.x;
  const int f = static_cast<int>(task % p.d);
  task /= p.d;
  const int nd = static_cast<int>(task % p.levels);
  const int t = static_cast<int>(task / p.levels);

  const int my_bin = warp * 32 + lane;
  const bool owner = my_bin < p.n_bins;
  const int model = p.models == 1 ? 0 : t / p.per_round;
  const int64_t* bins =
      p.bins == nullptr ? nullptr : p.bins + static_cast<int64_t>(model) * p.n * p.d + f;
  const int32_t* node = p.node == nullptr ? nullptr : p.node + static_cast<int64_t>(t) * p.n;
  const float* vals = p.vals + static_cast<int64_t>(t) * p.n * C;

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  for (int64_t base = 0; base < p.n; base += kStage) {
    // which of this thread's rows belong to the node, and their ranks in
    // row order: sub-step k holds rows base + k * 256 + threadIdx.x
    bool in[kRowsPerThread];
    unsigned ballot[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int64_t row = base + k * kHistThreads + threadIdx.x;
      in[k] = row < p.n && (node == nullptr || __ldg(node + row) == nd);
      ballot[k] = __ballot_sync(0xffffffffu, in[k]);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) s_count[k * kWarps + warp] = __popc(ballot[k]);
    }
    __syncthreads();
    int total = 0;
    int before[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      for (int w = 0; w < kWarps; ++w) {
        if (w == warp) before[k] = total;
        total += s_count[k * kWarps + w];
      }
    }
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      if (in[k]) {
        const int64_t row = base + k * kHistThreads + threadIdx.x;
        const int pos = before[k] + __popc(ballot[k] & below);
        s_bin[pos] = bins == nullptr ? 0 : static_cast<int32_t>(__ldg(bins + row * p.d));
#pragma unroll
        for (int c = 0; c < C; ++c) s_val[pos * C + c] = __ldg(vals + row * C + c);
      }
    }
    __syncthreads();
    if (warp * 32 < p.n_bins) {
      // the staged rows in row order; each lane adds its bin's
#pragma unroll 4
      for (int i = 0; i < total; ++i) {
        if (s_bin[i] == my_bin) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], s_val[i * C + c]);
        }
      }
    }
    __syncthreads();
  }
  if (owner) {
    float* out = p.out +
        ((static_cast<int64_t>(t) * p.levels + nd) * p.d + f) * p.n_bins * C +
        static_cast<int64_t>(my_bin) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = acc[c];
  }
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

// The inclusive cumsum over the bins of every channel of one feature's
// histogram h[n][C] (n <= 256, C <= 4) in XLA:CPU's blocked order,
// channels in lockstep: visit(j, v) gets bin j's prefix of channel c in
// v[c], bins in increasing order. Mirrors _blocked_cumsum of the plain
// version: n <= 16 is one sequential scan from x[0] + 0; past it the row
// is padded with zeros to whole blocks of 16, each block scanned from its
// first element + 0, the block totals scanned the same way, and each
// prefix is its block's prefix + the earlier blocks' total (0 for the
// first block).
template <typename Visit>
__device__ __forceinline__ void blocked_cumsum(const float* h, int n, int C,
                                               Visit visit) {
  float acc[kMaxChannels];
  if (n <= kBlock) {
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) acc[c] = c < C ? __fadd_rn(h[c], 0.0f) : 0.0f;
    visit(0, acc);
    for (int j = 1; j < n; ++j) {
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c < C) acc[c] = __fadd_rn(acc[c], h[j * C + c]);
      }
      visit(j, acc);
    }
    return;
  }
  const int m = (n + kBlock - 1) / kBlock;
  float inner[kMaxChannels];
  float excl[kMaxChannels];   // the block's exclusive offset
  float outer[kMaxChannels];  // the block totals' running sum
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) excl[c] = outer[c] = 0.0f;
  for (int i = 0; i < m; ++i) {
    for (int jj = 0; jj < kBlock; ++jj) {
      const int j = i * kBlock + jj;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c < C) {
          const float x = j < n ? h[j * C + c] : 0.0f;
          inner[c] = jj == 0 ? __fadd_rn(x, 0.0f) : __fadd_rn(inner[c], x);
          acc[c] = __fadd_rn(inner[c], excl[c]);
        }
      }
      if (j < n) visit(j, acc);
    }
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c < C) {
        outer[c] = i == 0 ? __fadd_rn(inner[c], 0.0f) : __fadd_rn(outer[c], inner[c]);
        excl[c] = outer[c];
      }
    }
  }
}

__global__ void __launch_bounds__(kSplitThreads)
gbdt_split_kernel(const SplitParams p) {
  __shared__ float s_gain[kSplitThreads / 32];
  __shared__ int s_idx[kSplitThreads / 32];
  const int nd = blockIdx.x % p.levels;
  const int t = blockIdx.x / p.levels;
  const int B = p.n_bins;
  const int C = p.channels;
  const float lam = hyper(p.lam, p.lam_s, t);
  const float mcw = hyper(p.mcw, p.mcw_s, t);
  const float mcs = hyper(p.mcs, p.mcs_s, t);
  const float neg_inf = -CUDART_INF_F;
  const int ws = p.w_slot < 0 ? 0 : p.w_slot;
  const int cs = p.c_slot < 0 ? 0 : p.c_slot;

  float best = neg_inf;
  int best_i = 0x7fffffff;
  for (int f = threadIdx.x; f < p.d; f += blockDim.x) {
    const float* h = p.hist + ((static_cast<int64_t>(t) * p.levels + nd) * p.d + f) * B * C;
    // the totals: every channel's last prefix
    float tot[kMaxChannels];
    blocked_cumsum(h, B, C, [&](int, const float* v) {
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) tot[c] = v[c];
    });
    const float G = tot[0], H = tot[1], W = tot[ws], Ct = tot[cs];
    const float parent = __fdiv_rn(__fmul_rn(G, G), __fadd_rn(H, lam));
    blocked_cumsum(h, B, C, [&](int j, const float* v) {
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
      const int idx = f * B + j;
      if (better(gain, idx, best, best_i)) {
        best = gain;
        best_i = idx;
      }
    });
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
    for (int w = 1; w < kSplitThreads / 32; ++w) {
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

__global__ void __launch_bounds__(kRowThreads)
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

__global__ void __launch_bounds__(kRowThreads)
gbdt_predict_kernel(const PredictParams p) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= p.n) return;
  const int t = blockIdx.y;
  const int width = (1 << p.depth) - 1;
  const int64_t* bins = p.bins + row * p.d;
  float acc = __ldg(p.base + t);
  for (int r = 0; r < p.rounds; ++r) {
    const int64_t tree = static_cast<int64_t>(r) * p.trees + t;
    const int64_t* feat = p.feats + tree * width;
    const int64_t* thr = p.thrs + tree * width;
    int nd = 0;
    for (int level = 0; level < p.depth; ++level) {
      const int k = (1 << level) - 1 + nd;
      nd = 2 * nd + (__ldg(bins + __ldg(feat + k)) > __ldg(thr + k) ? 1 : 0);
    }
    acc = __fadd_rn(acc, __ldg(p.leaves + tree * (width + 1) + nd));
  }
  p.out[static_cast<int64_t>(t) * p.n + row] = acc;
}

unsigned row_blocks(int64_t n) {
  return static_cast<unsigned>((n + kRowThreads - 1) / kRowThreads);
}

}  // namespace

extern "C" int delphi_gbdt_hist(const void* params, void* stream) {
  const HistParams& p = *static_cast<const HistParams*>(params);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(
      static_cast<int64_t>(p.trees) * p.levels * p.d);
  if (p.n_bins > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  switch (p.channels) {
    case 1: gbdt_hist_kernel<1><<<grid, kHistThreads, 0, s>>>(p); break;
    case 2: gbdt_hist_kernel<2><<<grid, kHistThreads, 0, s>>>(p); break;
    case 3: gbdt_hist_kernel<3><<<grid, kHistThreads, 0, s>>>(p); break;
    case 4: gbdt_hist_kernel<4><<<grid, kHistThreads, 0, s>>>(p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int delphi_gbdt_split(const void* params, void* stream) {
  const SplitParams& p = *static_cast<const SplitParams*>(params);
  const unsigned grid = static_cast<unsigned>(p.trees * p.levels);
  gbdt_split_kernel<<<grid, kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int delphi_gbdt_route(const void* params, void* stream) {
  const RouteParams& p = *static_cast<const RouteParams*>(params);
  const dim3 grid(row_blocks(p.n), static_cast<unsigned>(p.trees));
  gbdt_route_kernel<<<grid, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int delphi_gbdt_predict(const void* params, void* stream) {
  const PredictParams& p = *static_cast<const PredictParams*>(params);
  const dim3 grid(row_blocks(p.n), static_cast<unsigned>(p.trees));
  gbdt_predict_kernel<<<grid, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
