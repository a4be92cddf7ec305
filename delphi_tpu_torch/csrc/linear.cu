// K10: the logistic head's gather route (forward and backward) and the
// Adam step.
//
// Replace the jitted XLA program of delphi_tpu/models/linear.py (not
// Pallas): the loss of _fit_logreg_gather (:118, its loss_fn :137-143),
// the loss's jax.value_and_grad (:155) and optax.adam's update (:133,
// :156-157; also :63 and :206, the dense and MLP fits). On the TPU a
// whole fit is one lax.while_loop; here each step of the gather route is
// three launches (K10a, K10b, K10c) and one readback of the loss, which
// the host's exit test reads.
//
// Every float result is bit for bit the plain PyTorch version's
// (delphi_tpu_torch/ops/kernels/linear.py):
//   K10a logreg_forward   per row r: logit_c = Wcat[gid[r,0],c] + ...
//                         + Wcat[gid[r,F-1],c], then + cont[r,j] *
//                         Wcont[j,c] for j = 0..C-1, then + b[c]; m their
//                         maximum; e_c = (float)exp((double)(logit_c - m));
//                         Z the adjacent-pair tree of the e_c padded with
//                         zeros to a power of two; the row's loss w_r *
//                         ((float)log((double)Z) - (logit_y - m)); dlogits
//                         = (w_r / denom) * (e_c / Z - [c == y]). The loss
//                         is tree(row losses) / denom + l2 * (tree(Wcat^2)
//                         + tree(Wcont^2)), tree the halving tree in tiles
//                         of 32 (a warp's shuffle tree), level by level.
//   K10b logreg_backward  gWcat[v] = 0.0f, + dlogits of v's occurrences in
//                         row-major order (the JAX package's scatter-add
//                         order), then + (t + t), t = l2 * Wcat[v];
//                         gWcont[j] = the sum over rows of cont[r,j] *
//                         dlogits[r] + (t + t); gb = the sum over rows of
//                         dlogits[r]; both row sums in XLA:CPU's order
//                         (windows of 32 rows summed in order from 0.0,
//                         half the padding in front, level by level, the
//                         last at most 32 sums in order).
//   K10c adam_step        mu = fma(c1, g, b1*mu); nu = fma(c2, g*g,
//                         b2*nu); p = fma(mu / (bc1 * (sqrt(nu / bc2) +
//                         eps)), -lr, p): optax's update as XLA:CPU compiles
//                         it (the JAX package's bits).
// No float atomics, and every f32 operation is an explicitly rounded
// intrinsic: nvcc at -O3 would otherwise contract a*b+c into one FMA
// where the plain version has two roundings (and K10c's FMAs are
// written out).
//
// What bounds them on an H100. At the main path's shapes (10,000 rows,
// 3 categorical features, 1 continuous, 40 classes) each moves a few MB
// at most, about a microsecond of HBM time, so the launch and the chains
// of dependent loads and reductions bound them, and the step as a whole
// is bound by the host's loop (three launches and one readback). Design,
// the simple first one: K10a a warp per row, its lanes over 32 classes at
// a time (coalesced rows of Wcat and dlogits), three passes over the row
// (logits and their maximum, the exponentials and the class tree, the
// gradient), dlogits holding the intermediate values; 32 rows a block,
// whose losses a warp sums into the block's tile; other blocks square 1,024
// weights each (two levels of the tree); the last block to finish (a
// ticket taken after a __threadfence, reset to 0 by that block) sums the
// tiles' partials level by level and writes the loss. K10b a block per
// vocabulary id, a thread per class, walking the id's occurrences in
// order, its rows staged in shared memory 1,024 at a time and its values
// loaded 32 at a time a batch ahead of the adds (an id's chain of adds,
// 5,000 long for a binary feature at 10,000 rows, is K10b's floor; staging
// the values with every thread of the block was slower on an H100); and a
// block per window of 32 rows, a thread per (column, class) summing the
// window in order; the last of those blocks sums the windows level by
// level. K10c a thread per element.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;             // the tree's fan-in: one warp
constexpr int kRowWarps = 32;         // K10a: rows (warps) a block
constexpr int kWeightBlock = kTile * kTile;
constexpr int kForwardThreads = kRowWarps * 32;
constexpr int kMaxStack = 12;         // class chunks up to 2^11
constexpr int kMaxClasses = 1 << 16;  // checked by the wrapper too
constexpr int kBackwardThreads = 256;  // at most: 255 registers a thread
constexpr int kOccBatch = 32;         // K10b: an id's occurrences loaded at once
constexpr int kOccStage = 1024;       // K10b: an id's occurrence rows staged at once
constexpr int kAdamThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct ForwardParams {
  const int64_t* gid;     // [n, f] global vocabulary ids
  const float* cont;      // [n, c]
  const int64_t* y;       // [n]
  const float* sample_w;  // [n]
  const float* wcat;      // [vocab, k]
  const float* wcont;     // [c, k]
  const float* b;         // [k]
  float* loss;            // [1]
  float* dlogits;         // [n, k]
  float* partials;        // row tiles, then Wcat's and Wcont's blocks
  int* ticket;            // 0 before and after a launch
  int64_t n;
  int64_t n_cat;          // vocab * k
  int64_t n_cont;         // c * k
  int32_t f;
  int32_t c;
  int32_t k;
  float denom;
  float l2;
  int32_t pad;
};
static_assert(sizeof(ForwardParams) == 136, "ForwardParams layout");

struct BackwardParams {
  const float* dlogits;   // [n, k]
  const float* cont;      // [n, c]
  const int64_t* rows;    // [n * f] occurrence rows, ids ascending
  const int64_t* offsets; // [vocab + 1]
  const float* wcat;      // [vocab, k]
  const float* wcont;     // [c, k]
  float* gwcat;           // [vocab, k]
  float* gwcont;          // [c, k]
  float* gb;              // [k]
  float* partials;        // [ceil(n / 32), c + 1, k]
  int* ticket;            // 0 before and after a launch
  int64_t n;
  int32_t vocab;
  int32_t c;
  int32_t k;
  float l2;
};
static_assert(sizeof(BackwardParams) == 112, "BackwardParams layout");

struct AdamParams {
  float* p;
  const float* g;
  float* mu;
  float* nu;
  int64_t n;
  float c1, b1, c2, b2, bc1, bc2, eps, neg_lr;
};
static_assert(sizeof(AdamParams) == 72, "AdamParams layout");

// lane i < s gets x[i] + x[i + s], s = 16, 8, 4, 2, 1: lane 0 holds the
// halving tree of the warp's 32 values
__device__ __forceinline__ float warp_halving(float x) {
#pragma unroll
  for (int s = kTile / 2; s > 0; s >>= 1) x = __fadd_rn(x, __shfl_down_sync(kFull, x, s));
  return x;
}

// every lane gets the adjacent-pair tree of the warp's 32 values
__device__ __forceinline__ float warp_pairwise(float x) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, s));
  return x;
}

// torch.amax's maximum: a NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || isnan(b)) ? b : a;
}

// The levels of tree_sum above the values v[0, count) (each already a tile
// sum), in place, by the whole block: each round a warp halves one tile of
// 32 values, the block reads every tile of the round before any writes.
// Returns the last value (count 0: +0.0).
__device__ float block_tail(float* v, int64_t count) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  if (count == 0) return 0.0f;
  while (count > 1) {
    const int64_t tiles = (count + kTile - 1) / kTile;
    for (int64_t base = 0; base < tiles; base += warps) {
      const int64_t q = base + warp;
      float x = 0.0f;
      if (q < tiles) {
        const int64_t i = q * kTile + lane;
        x = warp_halving(i < count ? __ldcg(v + i) : 0.0f);
      }
      __syncthreads();
      if (q < tiles && lane == 0) v[q] = x;
      __syncthreads();
    }
    count = tiles;
  }
  return __ldcg(v);
}

// One row's logits, exponentials and gradient (a warp, lanes over
// classes); returns w_r * nll_r on every lane.
__device__ float forward_row(const ForwardParams& p, int64_t r, int lane) {
  const int k = p.k;
  const int64_t* g = p.gid + r * p.f;
  const float* x = p.cont + r * p.c;
  float* out = p.dlogits + r * k;
  const int64_t yr = p.y[r];

  float m = -INFINITY;
  for (int c0 = 0; c0 < k; c0 += 32) {
    const int c = c0 + lane;
    if (c < k) {
      float acc = p.wcat[g[0] * k + c];
      for (int f = 1; f < p.f; ++f) acc = __fadd_rn(acc, p.wcat[g[f] * k + c]);
      for (int j = 0; j < p.c; ++j) acc = __fadd_rn(acc, __fmul_rn(x[j], p.wcont[j * k + c]));
      acc = __fadd_rn(acc, p.b[c]);
      out[c] = acc;
      m = nan_max(m, acc);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) m = nan_max(m, __shfl_xor_sync(kFull, m, s));

  // the exponentials, each 32-class chunk's pair tree, and the chunks'
  // sums combined as one pair tree over chunks (a stack of subtrees)
  float stack[kMaxStack];
  int top = 0, chunks = 0;
  float dy = 0.0f;
  for (int c0 = 0; c0 < k; c0 += 32) {
    const int c = c0 + lane;
    float e = 0.0f;
    if (c < k) {
      const float d = __fsub_rn(out[c], m);
      e = static_cast<float>(exp(static_cast<double>(d)));
      out[c] = e;
      if (c == yr) dy = d;
    }
    float v = warp_pairwise(e);
    for (int j = chunks; j & 1; j >>= 1) v = __fadd_rn(stack[--top], v);
    stack[top++] = v;
    ++chunks;
  }
  float Z = stack[--top];
  while (top > 0) Z = __fadd_rn(stack[--top], Z);
  dy = __shfl_sync(kFull, dy, static_cast<int>(yr % 32));

  const float logz = static_cast<float>(log(static_cast<double>(Z)));
  const float w = p.sample_w[r];
  const float scale = __fdiv_rn(w, p.denom);
  for (int c0 = 0; c0 < k; c0 += 32) {
    const int c = c0 + lane;
    if (c < k) {
      float q = __fdiv_rn(out[c], Z);
      if (c == yr) q = __fsub_rn(q, 1.0f);
      out[c] = __fmul_rn(scale, q);
    }
  }
  return __fmul_rn(w, __fsub_rn(logz, dy));
}

__global__ void __launch_bounds__(kForwardThreads) logreg_forward_kernel(const ForwardParams p) {
  __shared__ float warp_sums[kRowWarps];
  __shared__ bool last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row_blocks = (p.n + kRowWarps - 1) / kRowWarps;
  const int64_t cat_blocks = (p.n_cat + kWeightBlock - 1) / kWeightBlock;
  const int64_t cont_blocks = (p.n_cont + kWeightBlock - 1) / kWeightBlock;
  const int64_t bid = blockIdx.x;

  if (bid < row_blocks) {
    const int64_t r = bid * kRowWarps + warp;
    const float loss = r < p.n ? forward_row(p, r, lane) : 0.0f;
    if (lane == 0) warp_sums[warp] = loss;
  } else {
    // 1,024 squared weights: a level-1 tile a warp, the block's 32 tiles
    // one level-2 tile
    const bool cat = bid < row_blocks + cat_blocks;
    const float* w = cat ? p.wcat : p.wcont;
    const int64_t len = cat ? p.n_cat : p.n_cont;
    const int64_t i = (bid - row_blocks - (cat ? 0 : cat_blocks)) * kWeightBlock + threadIdx.x;
    const float v = i < len ? w[i] : 0.0f;
    const float s = warp_halving(__fmul_rn(v, v));
    if (lane == 0) warp_sums[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const float s = warp_halving(warp_sums[lane]);
    if (lane == 0) p.partials[bid] = s;
  }

  // the last block to finish sums every tile's partial
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float rows = block_tail(p.partials, row_blocks);
  const float sq_cat = block_tail(p.partials + row_blocks, cat_blocks);
  const float sq_cont = block_tail(p.partials + row_blocks + cat_blocks, cont_blocks);
  if (threadIdx.x == 0) {
    *p.loss = __fadd_rn(__fdiv_rn(rows, p.denom), __fmul_rn(p.l2, __fadd_rn(sq_cat, sq_cont)));
    *p.ticket = 0;
  }
}

// the sum of one (column j, class c) output over rows r of a window:
// cont[r, j] * dlogits[r, c], or dlogits[r, c] itself for the bias
__device__ __forceinline__ float row_value(const BackwardParams& p, int64_t r, int j, int c) {
  const float v = p.dlogits[r * p.k + c];
  return j < p.c ? __fmul_rn(p.cont[r * p.c + j], v) : v;
}

__global__ void __launch_bounds__(kBackwardThreads) logreg_backward_kernel(const BackwardParams p) {
  __shared__ int64_t stage[kOccStage];
  __shared__ bool last;
  const int k = p.k;
  const int64_t bid = blockIdx.x;
  if (bid < p.vocab) {
    // a vocabulary id: its occurrences one after the other, their rows
    // staged in shared memory and their values loaded kOccBatch at a time,
    // a batch ahead of the chain of adds
    const int64_t lo = p.offsets[bid], hi = p.offsets[bid + 1];
    for (int c0 = 0; c0 < k; c0 += blockDim.x) {
      const int c = c0 + threadIdx.x;
      const float* col = p.dlogits + c;
      float acc = 0.0f;
      for (int64_t s0 = lo; s0 < hi; s0 += kOccStage) {
        const int m = static_cast<int>(hi - s0 < kOccStage ? hi - s0 : kOccStage);
        __syncthreads();
        for (int i = threadIdx.x; i < m; i += blockDim.x) stage[i] = p.rows[s0 + i] * k;
        __syncthreads();
        if (c < k) {
          float v[kOccBatch];
#pragma unroll
          for (int j = 0; j < kOccBatch; ++j) v[j] = j < m ? col[stage[j]] : 0.0f;
          for (int i = 0; i < m; i += kOccBatch) {
            float next[kOccBatch];
#pragma unroll
            for (int j = 0; j < kOccBatch; ++j) {
              const int at = i + kOccBatch + j;
              next[j] = at < m ? col[stage[at]] : 0.0f;
            }
#pragma unroll
            for (int j = 0; j < kOccBatch; ++j) {
              if (i + j < m) acc = __fadd_rn(acc, v[j]);
            }
#pragma unroll
            for (int j = 0; j < kOccBatch; ++j) v[j] = next[j];
          }
        }
      }
      if (c < k) {
        const float t = __fmul_rn(p.l2, p.wcat[bid * k + c]);
        p.gwcat[bid * k + c] = __fadd_rn(acc, __fadd_rn(t, t));
      }
    }
    return;
  }

  // a window of 32 rows (XLA:CPU's first level: the rows padded to whole
  // windows, half the padding in front), each (column, class) output's
  // window summed in row order from 0.0; with at most 32 rows, the whole
  // sum
  const int64_t tile = bid - p.vocab;
  const bool windowed = p.n > kTile;
  const int64_t tiles = windowed ? (p.n + kTile - 1) / kTile : 1;
  const int64_t front = windowed ? (tiles * kTile - p.n) / 2 : 0;
  const int outs = (p.c + 1) * k;
  for (int o = threadIdx.x; o < outs; o += blockDim.x) {
    const int j = o / k, c = o % k;
    float x[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int64_t r = tile * kTile + i - front;
      x[i] = r >= 0 && r < p.n ? row_value(p, r, j, c) : 0.0f;
    }
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int64_t r = tile * kTile + i - front;
      if (r >= 0 && r < p.n) acc = __fadd_rn(acc, x[i]);
    }
    p.partials[tile * outs + o] = acc;
  }

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.ticket, 1) == static_cast<int>(tiles) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // XLA:CPU's levels above the windows, every output at once: a warp
  // sums one window of 32 window sums for 32 outputs (lanes over
  // outputs); a round reads before it writes, and a write at window q
  // never meets a later read (windows from 32 q - 15 on, or other
  // outputs). Then the last at most 32 sums in order.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int out_chunks = (outs + 31) / 32;
  int64_t count = tiles;
  while (count > kTile) {
    const int64_t groups = (count + kTile - 1) / kTile;
    const int64_t lead = (groups * kTile - count) / 2;
    const int64_t items = groups * out_chunks;
    for (int64_t base = 0; base < items; base += warps) {
      const int64_t item = base + warp;
      const int64_t q = item / out_chunks;
      const int o = static_cast<int>(item % out_chunks) * 32 + lane;
      const bool mine = item < items && o < outs;
      float acc = 0.0f;
      if (mine) {
        for (int i = 0; i < kTile; ++i) {
          const int64_t t = q * kTile + i - lead;
          if (t >= 0 && t < count) acc = __fadd_rn(acc, __ldcg(p.partials + t * outs + o));
        }
      }
      __syncthreads();
      if (mine) p.partials[q * outs + o] = acc;
      __syncthreads();
    }
    count = groups;
  }
  for (int o = threadIdx.x; o < outs; o += blockDim.x) {
    const int j = o / k, c = o % k;
    float s = __ldcg(p.partials + o);
    if (windowed) {
      s = 0.0f;
      for (int64_t t = 0; t < count; ++t) s = __fadd_rn(s, __ldcg(p.partials + t * outs + o));
    }
    if (j < p.c) {
      const float t = __fmul_rn(p.l2, p.wcont[j * k + c]);
      p.gwcont[j * k + c] = __fadd_rn(s, __fadd_rn(t, t));
    } else {
      p.gb[c] = s;
    }
  }
  if (threadIdx.x == 0) *p.ticket = 0;
}

__global__ void adam_step_kernel(const AdamParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const float g = p.g[i];
  const float m = __fmaf_rn(p.c1, g, __fmul_rn(p.b1, p.mu[i]));
  const float v = __fmaf_rn(p.c2, __fmul_rn(g, g), __fmul_rn(p.b2, p.nu[i]));
  p.mu[i] = m;
  p.nu[i] = v;
  const float den = __fmul_rn(p.bc1, __fadd_rn(__fsqrt_rn(__fdiv_rn(v, p.bc2)), p.eps));
  p.p[i] = __fmaf_rn(__fdiv_rn(m, den), p.neg_lr, p.p[i]);
}

}  // namespace

extern "C" int delphi_logreg_forward(const void* params, void* stream) {
  const ForwardParams& p = *static_cast<const ForwardParams*>(params);
  if (p.n < 1 || p.f < 1 || p.c < 0 || p.k < 1 || p.k > kMaxClasses || p.n_cat < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t grid = (p.n + kRowWarps - 1) / kRowWarps + (p.n_cat + kWeightBlock - 1) / kWeightBlock +
                       (p.n_cont + kWeightBlock - 1) / kWeightBlock;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  logreg_forward_kernel<<<static_cast<unsigned>(grid), kForwardThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int delphi_logreg_backward(const void* params, void* stream) {
  const BackwardParams& p = *static_cast<const BackwardParams*>(params);
  if (p.n < 1 || p.vocab < 1 || p.c < 0 || p.k < 1 || p.k > kMaxClasses) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t grid = p.vocab + (p.n + kTile - 1) / kTile;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  logreg_backward_kernel<<<static_cast<unsigned>(grid), kBackwardThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int delphi_adam_step(const void* params, void* stream) {
  const AdamParams& p = *static_cast<const AdamParams*>(params);
  const int64_t grid = (p.n + kAdamThreads - 1) / kAdamThreads;
  if (p.n < 1 || grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  adam_step_kernel<<<static_cast<unsigned>(grid), kAdamThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
