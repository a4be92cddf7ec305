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
// at most, about a microsecond of HBM time: K10a is bound by the issue of
// its rows' instructions (about 400 a row, every SM busy), K10b by its
// longest chain of dependent adds, K10c by the launch.
//
// K10a up to 64 classes, and up to 256 with the weights staged: one wave
// of blocks (the SM count times the blocks an SM holds), each taking
// items in turn: a tile of 32 rows (tree_sum's first tile), a row a warp
// at a time with the next row's ids, label, weight and continuous values
// loaded before the current row's math, lanes over classes; or 1,024
// squared weights. The row's logits and exponentials stay in registers
// (2 or 8 chunks of 32 classes), dlogits is written once, and Wcat, Wcont
// and b are staged in shared memory when they fit (kWeightSmem). Each
// chunk's butterfly sum is kept by a lane and their butterfly is the
// class sum: no stack in local memory, and no shuffle inside a branch
// (the compiler wraps such a shuffle in a loop). The last block (a
// ticket after a __threadfence) sums the three sets of tiles in
// parallel, a group of warps each. Other rows take the rows kernel: a
// block per tile, a warp a row, three passes through dlogits, the chunks'
// sums combined on a stack; the last block sums the tiles' partials. It
// was faster than the wave there (dlogits rows of 1,024 to 33,000
// classes, and 200 classes whose weights were not staged).
//
// K10b below 64 classes: a block per (vocabulary id, group of 8 classes:
// one 32-byte sector of a row), so an id's bytes spread over SMs, the
// group's chains of adds each in row order (the longest, a binary
// feature's 5,000 occurrences at 10,000 rows, is K10b's floor). A
// producer warp keeps a ring of kStages stages of 8 KB in shared memory
// filled ahead of the adders by cp.async gathers of each occurrence's
// classes of the group from dlogits (the occurrence rows loaded a stage
// ahead), one mbarrier a stage each way, no __syncthreads between stages.
// The adder warp (a lane a class) adds a full stage as straight-line
// code, its shared memory reads free to run ahead of the chain, and
// releases it. (A sector copy of dlogits that K10a wrote in occurrence
// order, moved a stage at a time by the bulk copy engine, was no faster
// here and cost K10a its writes; so was a class-major ring read four
// values a load; blocks taking items in turn needed 185 registers.) From
// 64 classes on, a block per id, a thread per class (256 at a time), its
// occurrence rows staged in shared memory 1,024 at a time and its values
// loaded 32 at a time a batch ahead of the adds: there an id's row is
// several sectors wide, and groups of 32 classes on the ring were slower
// (1,920 short blocks at 1,024 classes). And a block per window of 32
// rows, a thread per (column, class) summing the window in order; the
// last of those blocks sums the windows level by level. K10c a thread per
// element.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;             // the tree's fan-in: one warp
constexpr int kWeightBlock = kTile * kTile;
constexpr int kWeightSmem = 44 * 1024;  // K10a: weights staged up to this
constexpr int kRowWarps = 32;         // K10a's rows kernel: rows (warps) a block
constexpr int kMaxStack = 12;         // its class tree's stack: chunks up to 2^11
constexpr int kMaxClasses = 1 << 16;  // checked by the wrapper too
constexpr int kGroup = 8;             // K10b: a ring block's classes (32 bytes)
constexpr int kStageFloats = 2048;    // K10b: a ring stage (8 KB)
constexpr int kStages = 4;            // K10b: ring stages (32 KB)
constexpr int kOcc = kStageFloats / kGroup;  // occurrences a ring stage
constexpr int kWideClasses = 64;      // K10b: from here a block an id
constexpr int kOccBatch = 32;         // K10b wide: values loaded at once
constexpr int kOccStage = 1024;       // K10b wide: occurrence rows staged at once
constexpr int kBackwardThreads = 256;  // at most: 255 registers a thread
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

__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The levels of tree_sum above the values v[0, count) (each already a tile
// sum), in place, by a group of `warps` warps (this one its warp `gw`)
// that meets at named barrier `bar`: each round a warp halves one tile of
// 32 values, the group reads every tile of the round before any writes;
// the last round's one tile is the group's first warp's, whose lane 0
// returns the sum (count 0: +0.0).
__device__ float group_tail(float* v, int64_t count, int gw, int warps, int bar) {
  const int lane = threadIdx.x % 32;
  if (count <= 1) return count == 0 ? 0.0f : __ldcg(v);
  while (true) {
    const int64_t tiles = (count + kTile - 1) / kTile;
    if (tiles == 1) return gw == 0 ? warp_halving(lane < count ? __ldcg(v + lane) : 0.0f) : 0.0f;
    for (int64_t base = 0; base < tiles; base += warps) {
      const int64_t q = base + gw;
      float x = 0.0f;
      if (q < tiles) {
        const int64_t i = q * kTile + lane;
        x = warp_halving(i < count ? __ldcg(v + i) : 0.0f);
      }
      group_barrier(bar, warps * 32);
      if (q < tiles && lane == 0) v[q] = x;
      group_barrier(bar, warps * 32);
    }
    count = tiles;
  }
}

// ---------------------------------------------------------------------------
// K10a
// ---------------------------------------------------------------------------

// A row's inputs, loaded ahead: lane i holds the row's i-th id and its
// i-th continuous value (i < 32; the rest are read where used), every
// lane its label and weight.
struct RowIn {
  int gid, y;
  float x, w;
};

__device__ __forceinline__ RowIn load_row(const ForwardParams& p, int64_t r, int lane) {
  RowIn in{0, 0, 0.0f, 0.0f};
  if (r >= p.n) return in;
  if (lane < p.f) in.gid = static_cast<int>(__ldg(p.gid + r * p.f + lane));
  if (lane < p.c) in.x = __ldg(p.cont + r * p.c + lane);
  in.y = static_cast<int>(__ldg(p.y + r));
  in.w = __ldg(p.sample_w + r);
  return in;
}

// (the shuffles outside any branch: a shuffle the compiler cannot prove
// convergent is wrapped in a loop over the warp's groups)
__device__ __forceinline__ int row_gid(const ForwardParams& p, const RowIn& in, int64_t r, int f) {
  const int g = __shfl_sync(kFull, in.gid, f & 31);
  return f < 32 ? g : static_cast<int>(__ldg(p.gid + r * p.f + f));
}

__device__ __forceinline__ float row_cont(const ForwardParams& p, const RowIn& in, int64_t r, int j) {
  const float x = __shfl_sync(kFull, in.x, j & 31);
  return j < 32 ? x : __ldg(p.cont + r * p.c + j);
}

struct Weights {
  const float* cat;
  const float* cont;
  const float* b;
};

// One row's logits, exponentials and gradient (a warp, lanes over
// classes, R register chunks of 32 classes); returns w_r * nll_r on every
// lane.
template <int R>
__device__ float forward_row(const ForwardParams& p, const Weights& w, const RowIn& in, int64_t r,
                             int lane) {
  const int k = p.k;
  const int chunks = (k + 31) / 32;
  float* out = p.dlogits + r * k;
  float v[R];

  // feature by feature, the row's chunks loaded together
  float m = -INFINITY;
  {
    const float* row = w.cat + static_cast<int64_t>(row_gid(p, in, r, 0)) * k + lane;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j < chunks && j * 32 + lane < k) v[j] = row[j * 32];
    }
  }
#pragma unroll 4
  for (int f = 1; f < p.f; ++f) {
    const float* row = w.cat + static_cast<int64_t>(row_gid(p, in, r, f)) * k + lane;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j < chunks && j * 32 + lane < k) v[j] = __fadd_rn(v[j], row[j * 32]);
    }
  }
  for (int jc = 0; jc < p.c; ++jc) {
    const float x = row_cont(p, in, r, jc);
    const float* row = w.cont + jc * k + lane;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j < chunks && j * 32 + lane < k) v[j] = __fadd_rn(v[j], __fmul_rn(x, row[j * 32]));
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (j < chunks && j * 32 + lane < k) {
      v[j] = __fadd_rn(v[j], w.b[j * 32 + lane]);
      m = nan_max(m, v[j]);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) m = nan_max(m, __shfl_xor_sync(kFull, m, s));

  // the exponentials and the class tree: each chunk's butterfly kept by
  // lane j, their butterfly the sum (lanes past the row's chunks hold
  // +0.0, so it is the pair tree of the chunks padded to a power of two);
  // every shuffle outside a branch
  const int yr = in.y;
  float dy = 0.0f, sums = 0.0f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int c = j * 32 + lane;
    float e = 0.0f;
    if (j < chunks && c < k) {
      const float d = __fsub_rn(v[j], m);
      e = static_cast<float>(exp(static_cast<double>(d)));
      v[j] = e;
      if (c == yr) dy = d;
    }
    const float sum = warp_pairwise(e);
    if (lane == j) sums = sum;
  }
  const float Z = warp_pairwise(sums);
  dy = __shfl_sync(kFull, dy, yr % 32);

  const float logz = static_cast<float>(log(static_cast<double>(Z)));
  const float scale = __fdiv_rn(in.w, p.denom);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int c = j * 32 + lane;
    if (j < chunks && c < k) {
      float q = __fdiv_rn(v[j], Z);
      if (c == yr) q = __fsub_rn(q, 1.0f);
      out[c] = __fmul_rn(scale, q);
    }
  }
  return __fmul_rn(in.w, __fsub_rn(logz, dy));
}

// R register chunks of 32 classes a row, W warps, the weights Staged in
// shared memory (else read from global memory)
template <int R, int W, bool Staged>
__global__ void __launch_bounds__(W * 32) logreg_forward_kernel(const ForwardParams p) {
  extern __shared__ float4 staged_weights[];
  __shared__ float sums[kTile];
  __shared__ float tails[3];
  __shared__ bool last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t tiles = (p.n + kTile - 1) / kTile;
  const int64_t cat_blocks = (p.n_cat + kWeightBlock - 1) / kWeightBlock;
  const int64_t cont_blocks = (p.n_cont + kWeightBlock - 1) / kWeightBlock;
  const int64_t items = tiles + cat_blocks + cont_blocks;

  Weights w{p.wcat, p.wcont, p.b};
  if constexpr (Staged) {
    float* s = reinterpret_cast<float*>(staged_weights);
    for (int64_t i = threadIdx.x; i < p.n_cat; i += blockDim.x) s[i] = __ldg(p.wcat + i);
    for (int64_t i = threadIdx.x; i < p.n_cont; i += blockDim.x) s[p.n_cat + i] = __ldg(p.wcont + i);
    for (int i = threadIdx.x; i < p.k; i += blockDim.x) s[p.n_cat + p.n_cont + i] = __ldg(p.b + i);
    w = Weights{s, s + p.n_cat, s + p.n_cat + p.n_cont};
  }
  // this block's first row, loaded while the weights arrive
  RowIn in = load_row(p, static_cast<int64_t>(blockIdx.x) * kTile + warp, lane);
  __syncthreads();

  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    if (item < tiles) {
      // rows item * 32 + warp + W i: each row's loss into its slot
#pragma unroll
      for (int i = 0; i < kTile / W; ++i) {
        const int at = warp + i * W;
        const int64_t r = item * kTile + at;
        const int64_t next = i + 1 < kTile / W ? r + W : (item + gridDim.x) * kTile + warp;
        const RowIn ahead = load_row(p, next, lane);
        const float loss = r < p.n ? forward_row<R>(p, w, in, r, lane) : 0.0f;
        if (lane == 0) sums[at] = loss;
        in = ahead;
      }
    } else {
      // 1,024 squared weights: a level-1 tile a warp at a time, the
      // block's 32 tiles one level-2 tile
      const bool cat = item < tiles + cat_blocks;
      const float* src = cat ? p.wcat : p.wcont;
      const int64_t len = cat ? p.n_cat : p.n_cont;
      const int64_t base = (item - tiles - (cat ? 0 : cat_blocks)) * kWeightBlock;
      for (int t = warp; t < kTile; t += W) {
        const int64_t i = base + t * kTile + lane;
        const float x = i < len ? __ldg(src + i) : 0.0f;
        const float s = warp_halving(__fmul_rn(x, x));
        if (lane == 0) sums[t] = s;
      }
    }
    __syncthreads();
    if (warp == 0) {
      const float s = warp_halving(sums[lane]);
      if (lane == 0) p.partials[item] = s;
    }
    __syncthreads();
  }

  // the last block to finish sums every tile's partial: the rows' with
  // three quarters of its warps, Wcat's and Wcont's with an eighth each
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int kRows = W - W / 4, kEighth = W / 8;
  if (warp < kRows) {
    const float s = group_tail(p.partials, tiles, warp, kRows, 1);
    if (threadIdx.x == 0) tails[0] = s;
  } else if (warp < kRows + kEighth) {
    const float s = group_tail(p.partials + tiles, cat_blocks, warp - kRows, kEighth, 2);
    if (warp == kRows && lane == 0) tails[1] = s;
  } else {
    const float s = group_tail(p.partials + tiles + cat_blocks, cont_blocks, warp - kRows - kEighth,
                               kEighth, 3);
    if (warp == kRows + kEighth && lane == 0) tails[2] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    *p.loss = __fadd_rn(__fdiv_rn(tails[0], p.denom), __fmul_rn(p.l2, __fadd_rn(tails[1], tails[2])));
    *p.ticket = 0;
  }
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

// One row of the rows kernel: its logits, exponentials and gradient
// through dlogits (a warp, lanes over classes); returns w_r * nll_r on
// every lane.
__device__ float dlogits_row(const ForwardParams& p, int64_t r, int lane) {
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

// The rows kernel: a block per tile of 32 rows, a warp a row, then a block
// per 1,024 weights; the last block to finish sums every tile's partial.
__global__ void __launch_bounds__(kRowWarps * 32) logreg_forward_rows_kernel(const ForwardParams p) {
  __shared__ float warp_sums[kRowWarps];
  __shared__ bool last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row_blocks = (p.n + kRowWarps - 1) / kRowWarps;
  const int64_t cat_blocks = (p.n_cat + kWeightBlock - 1) / kWeightBlock;
  const int64_t cont_blocks = (p.n_cont + kWeightBlock - 1) / kWeightBlock;
  const int64_t bid = blockIdx.x;

  if (bid < row_blocks) {
    const int64_t r = bid * kRowWarps + warp;
    const float loss = r < p.n ? dlogits_row(p, r, lane) : 0.0f;
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

// ---------------------------------------------------------------------------
// K10b
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_at(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_at(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_at(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_at(bar)) : "memory");
}

template <int Bytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_at(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_at(dst)), "l"(src) : "memory");
  }
}

// one arrival on `bar` once this thread's earlier cp.async copies land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_at(bar)) : "memory");
}

// One (vocabulary id, group of kGroup classes): warp 0 fills the ring
// (stages of kOcc occurrences), warp 1 adds (a lane a class), the other
// warps leave after the barriers' set-up.
__device__ __forceinline__ void id_group_sums(const BackwardParams& p, int64_t item, float* ring, uint64_t* full,
                                              uint64_t* empty) {
  const int k = p.k;
  const int groups = (k + kGroup - 1) / kGroup;
  const int64_t v = item / groups;
  const int g0 = static_cast<int>(item % groups) * kGroup;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 1);
    }
  }
  __syncthreads();
  if (warp > 1) return;
  const int64_t lo = __ldg(p.offsets + v), len = __ldg(p.offsets + v + 1) - lo;
  const int64_t stages = (len + kOcc - 1) / kOcc;

  if (warp == 0) {
    // gathers of each occurrence's classes of the group, lanes over
    // occurrences, the next stage's rows loaded before this stage's copies
    constexpr int kPerLane = kOcc / 32;
    const int width = k - g0 < kGroup ? k - g0 : kGroup;  // the group's classes
    // 16-byte copies when rows are: the group's width is then 4 or 8
    const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(p.dlogits) % 16 == 0;
    const float* col = p.dlogits + g0;
    int64_t rows[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int64_t i = lane + 32 * j;
      rows[j] = i < len ? __ldg(p.rows + lo + i) : 0;
    }
    for (int64_t st = 0; st < stages; ++st) {
      const int s = static_cast<int>(st % kStages);
      const int64_t m = len - st * kOcc < kOcc ? len - st * kOcc : kOcc;
      int64_t cur[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        cur[j] = rows[j];
        const int64_t i = (st + 1) * kOcc + lane + 32 * j;
        rows[j] = i < len ? __ldg(p.rows + lo + i) : 0;
      }
      if (st >= kStages) mbar_wait(empty + s, ((st / kStages) & 1) ^ 1);
      float* stage = ring + s * kStageFloats;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int i = lane + 32 * j;
        if (i < m) {
          const float* src = col + cur[j] * k;
          float* dst = stage + i * kGroup;
          if (vec) {
            // two copies written out: a loop here slows the producer
            // below the adders' pace (measured)
            cp_async<16>(dst, src);
            if (width == 8) cp_async<16>(dst + 4, src + 4);
          } else {
            for (int c = 0; c < width; ++c) cp_async<4>(dst + c, src + c);
          }
        }
      }
      cp_async_arrive(full + s);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    // the producer leaves once the adders have released its last stages
    if (lane == 0) {
      for (int64_t st = stages > kStages ? stages - kStages : 0; st < stages; ++st) {
        mbar_wait(empty + st % kStages, (st / kStages) & 1);
      }
    }
    return;
  }

  // the adders: a whole stage as straight-line code (its shared reads at
  // fixed offsets, free to run ahead of the chain of adds), the last,
  // partial stage 16 at a time
  const int c = g0 + lane % kGroup;
  float acc = 0.0f;
  for (int64_t st = 0; st < stages; ++st) {
    const int s = static_cast<int>(st % kStages);
    mbar_wait(full + s, (st / kStages) & 1);
    const int64_t left = len - st * kOcc;
    const float* src = ring + s * kStageFloats + lane % kGroup;
    if (left >= kOcc) {
#pragma unroll
      for (int i = 0; i < kOcc; ++i) acc = __fadd_rn(acc, src[i * kGroup]);
    } else {
      const int m = static_cast<int>(left);
#pragma unroll 16
      for (int i = 0; i < m; ++i) acc = __fadd_rn(acc, src[i * kGroup]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }
  if (lane < kGroup && c < k) {
    const float t = __fmul_rn(p.l2, p.wcat[v * k + c]);
    p.gwcat[v * k + c] = __fadd_rn(acc, __fadd_rn(t, t));
  }
}

// One vocabulary id of a wide target: its occurrences one after the
// other, their rows staged in shared memory and their values loaded
// kOccBatch at a time, a batch ahead of the chain of adds (a thread a
// class, the block's threads over the classes in turn).
__device__ __forceinline__ void id_sums(const BackwardParams& p, int64_t v, int64_t* stage) {
  const int k = p.k;
  const int64_t lo = p.offsets[v], hi = p.offsets[v + 1];
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
        float x[kOccBatch];
#pragma unroll
        for (int j = 0; j < kOccBatch; ++j) x[j] = j < m ? col[stage[j]] : 0.0f;
        for (int i = 0; i < m; i += kOccBatch) {
          float next[kOccBatch];
#pragma unroll
          for (int j = 0; j < kOccBatch; ++j) {
            const int at = i + kOccBatch + j;
            next[j] = at < m ? col[stage[at]] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < kOccBatch; ++j) {
            if (i + j < m) acc = __fadd_rn(acc, x[j]);
          }
#pragma unroll
          for (int j = 0; j < kOccBatch; ++j) x[j] = next[j];
        }
      }
    }
    if (c < k) {
      const float t = __fmul_rn(p.l2, p.wcat[v * k + c]);
      p.gwcat[v * k + c] = __fadd_rn(acc, __fadd_rn(t, t));
    }
  }
}

// the sum of one (column j, class c) output over rows r of a window:
// cont[r, j] * dlogits[r, c], or dlogits[r, c] itself for the bias
__device__ __forceinline__ float row_value(const BackwardParams& p, int64_t r, int j, int c) {
  const float v = p.dlogits[r * p.k + c];
  return j < p.c ? __fmul_rn(p.cont[r * p.c + j], v) : v;
}

// a block per (id, group of kGroup classes) (Ring) or per id, then one
// per window of rows
template <bool Ring>
__global__ void __launch_bounds__(kBackwardThreads) logreg_backward_kernel(const BackwardParams p) {
  __shared__ __align__(128) float ring[Ring ? kStages * kStageFloats : 1];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ int64_t stage[Ring ? 1 : kOccStage];
  __shared__ bool last;
  const int k = p.k;
  const int64_t id_blocks = static_cast<int64_t>(p.vocab) * (Ring ? (k + kGroup - 1) / kGroup : 1);
  const int64_t bid = blockIdx.x;
  if (bid < id_blocks) {
    if constexpr (Ring) {
      id_group_sums(p, bid, ring, full, empty);
    } else {
      id_sums(p, bid, stage);
    }
    return;
  }

  // a window of 32 rows (XLA:CPU's first level: the rows padded to whole
  // windows, half the padding in front), each (column, class) output's
  // window summed in row order from 0.0; with at most 32 rows, the whole
  // sum
  const int64_t tile = bid - id_blocks;
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

// The blocks of one K10a instantiation that an SM holds with `smem` bytes
// of staged weights: the last answer kept per device (a fit launches
// with one size every step).
template <int R, int W, bool Staged>
cudaError_t forward_blocks_per_sm(size_t smem, int* out) {
  static size_t cached_smem[64];
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < 64;
  if (keep && cached[dev] > 0 && cached_smem[dev] == smem) {
    *out = cached[dev];
    return cudaSuccess;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, logreg_forward_kernel<R, W, Staged>, W * 32, smem);
  if (err == cudaSuccess && keep && *out > 0) {
    cached_smem[dev] = smem;
    cached[dev] = *out;
  }
  return err;
}

// one wave of K10a's blocks: as many as every SM holds, at most one an item
template <int R, int W, bool Staged>
cudaError_t launch_forward(const ForwardParams& p, cudaStream_t s) {
  const size_t smem = Staged ? static_cast<size_t>(p.n_cat + p.n_cont + p.k) * sizeof(float) : 0;
  int per_sm = 0;
  const cudaError_t err = forward_blocks_per_sm<R, W, Staged>(smem, &per_sm);
  if (err != cudaSuccess) return err;
  const int64_t items = (p.n + kTile - 1) / kTile + (p.n_cat + kWeightBlock - 1) / kWeightBlock +
                        (p.n_cont + kWeightBlock - 1) / kWeightBlock;
  const int64_t wave = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sm_count();
  const unsigned grid = static_cast<unsigned>(items < wave ? items : wave);
  logreg_forward_kernel<R, W, Staged><<<grid, W * 32, smem, s>>>(p);
  return cudaGetLastError();
}

template <bool Ring>
cudaError_t launch_backward(const BackwardParams& p, cudaStream_t s) {
  const int64_t grid =
      static_cast<int64_t>(p.vocab) * (Ring ? (p.k + kGroup - 1) / kGroup : 1) + (p.n + kTile - 1) / kTile;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  logreg_backward_kernel<Ring><<<static_cast<unsigned>(grid), kBackwardThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int delphi_logreg_forward(const void* params, void* stream) {
  const ForwardParams& p = *static_cast<const ForwardParams*>(params);
  if (p.n < 1 || p.f < 1 || p.c < 0 || p.k < 1 || p.k > kMaxClasses || p.n_cat < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Up to 64 classes the wave's kernel, 16 warps a block, the weights
  // staged when they fit; up to 256 classes with the weights staged, 8
  // warps, whose 8 chunks of logits take a row's registers; else the
  // rows kernel (a warp a row, the logits in dlogits), which was faster
  // there
  const int chunks = (p.k + 31) / 32;
  const bool staged = (p.n_cat + p.n_cont + p.k) * static_cast<int64_t>(sizeof(float)) <= kWeightSmem;
  cudaError_t err;
  if (chunks <= 2) {
    err = staged ? launch_forward<2, 16, true>(p, s) : launch_forward<2, 16, false>(p, s);
  } else if (chunks <= 8 && staged) {
    err = launch_forward<8, 8, true>(p, s);
  } else {
    const int64_t grid = (p.n + kRowWarps - 1) / kRowWarps + (p.n_cat + kWeightBlock - 1) / kWeightBlock +
                         (p.n_cont + kWeightBlock - 1) / kWeightBlock;
    if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    logreg_forward_rows_kernel<<<static_cast<unsigned>(grid), kRowWarps * 32, 0, s>>>(p);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

extern "C" int delphi_logreg_backward(const void* params, void* stream) {
  const BackwardParams& p = *static_cast<const BackwardParams*>(params);
  if (p.n < 1 || p.vocab < 1 || p.c < 0 || p.k < 1 || p.k > kMaxClasses) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p.k < kWideClasses ? launch_backward<true>(p, s) : launch_backward<false>(p, s));
}

extern "C" int delphi_adam_step(const void* params, void* stream) {
  const AdamParams& p = *static_cast<const AdamParams*>(params);
  const int64_t grid = (p.n + kAdamThreads - 1) / kAdamThreads;
  if (p.n < 1 || grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  adam_step_kernel<<<static_cast<unsigned>(grid), kAdamThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
