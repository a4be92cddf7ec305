// K5 domain_scores: the bucketed domain route's gather-reduce and, in its
// weak-label mode, the f64 epilogue that picks each cell's top value.
//
// Replaces delphi_tpu/ops/domain.py::_jit_bucket_kernel (a vmap over the
// pieces of one launch), which XLA jits in two modes:
//   integer mode (:764-772, _int_score_body :432), for each error cell and
//   each candidate value v of its target attribute, over the k correlates:
//     code  = codes[col_idx[p, c], row]               (NULL = -1)
//     g     = tables[p, c, code + 1, 1 + v]           (the pair count)
//     active  iff  code != NULL && g > taus[p, c] && g > 0 && hs[p, v]
//     big   = sum over active c of (g - 1 if g >= 2 else 0)   int32
//     tiny  = #(active c with g == 1)                          int32
//     contributed = any active c                               uint8
//   fused mode (:774-793), per cell, in f64:
//     score_v = (big_v + 0.1 * tiny_v) / n_rows
//     denom   = sum of score over the piece's v_a real values
//     prob_v  = denom > 0 ? score_v / denom : 0
//     keep_v  = contributed_v && prob_v > beta
//     best    = max of prob_v over the kept values
//     has_domain = best > -inf
//     top     = the slot of least vocab rank among the values whose
//               masked prob equals best (all values when none is kept)
// The integer mode serves runs with a provenance ledger, which record each
// cell's domain size on the host; the weak-label mode every other run.
// Unlike XLA's fused mode, the epilogue here is bit for bit the host numpy
// route's (domain.py::_combine_scores and the pick after it): every f64
// operation is an explicitly rounded intrinsic (never contracted into an
// FMA), and denom is numpy's pairwise_sum over the row:
//   n < 8:       res = -0.0, then add the elements in order;
//   8 <= n <= 128: eight accumulators r[j] = a[j], r[j] += a[i + j] for
//                i = 8, 16, ... < n - n % 8, then
//                ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)), then
//                the remaining n % 8 elements in order;
//   n > 128:     n2 = n / 2 - (n / 2) % 8; sum(a[:n2]) + sum(a[n2:]).
// contributed_v is exactly score_v > 0 (an active correlate adds at least
// 0.1 / n_rows), so the epilogue needs no flag.
//
// What bounds it on an H100: by count, the bytes. Per cell it reads one
// row index and k codes and writes 5 bytes (weak-label mode; 9 per cell
// and value in integer mode); the pair tables are small and read from
// shared memory or L2. Its f64 work is a division per active value and a
// few operations per value. Measured, it runs well above that bound,
// held by the instructions each cell's walk issues (PERF.md).
//
// Design:
// * Operands are compact: a piece's cells are rows[cell_off[p] :
//   cell_off[p + 1]], and its outputs sit at the same cell offsets, so
//   nothing is padded and only real cells are written.
// * Grid (x, b): blockIdx.y is the piece, so no index is divided per
//   element. Each block stages its piece's column indices, taus, table
//   extents, has-single flags and vocab ranks in shared memory and, when
//   the launch's tables fit the budget (the wrapper decides per launch:
//   pieces of one launch share their padded extents), the real rows of
//   its k pair tables (a cooperative loop of __ldg loads, each row at an
//   odd pitch so that the gathers of a warp's cells spread over the
//   banks); otherwise it reads them through __ldg and L2.
// * One thread per cell, the block striding over its piece's cells: a
//   thread reads its cell's row index and k codes once (coalesced across
//   the warp), keeps each code's table-row offset in shared memory and
//   walks the values. The integer mode writes its sums
//   value-major ([va, cells]), so a warp's stores are coalesced.
// * The weak-label mode walks the values in numpy's summation order,
//   computing each score on the fly (a division only where a correlate is
//   active: an inactive value scores +0), and keeps the largest active
//   numerator x = big + 0.1 * tiny. Correct rounding is monotone, so the
//   top probability belongs to the values of that x; numerators of
//   distinct integer sums differ by about 0.1, far above the roundings,
//   but sums of 10 or more tinies can meet within an ulp, so when another
//   numerator lies within 2^-40 (relative) of the largest, a second walk
//   compares the exact probabilities of all such values.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLeaf = 128;  // numpy's PW_BLOCKSIZE

// Mirrored by ops/kernels/domain_scores.py::DomainTable (ctypes); 136
// bytes, passed to the kernel by value.
//    0 codes        const int32*  [n_cols, codes_stride], NULL = -1
//    8 col_idx      const int32*  [b, k]
//   16 taus         const int32*  [b, k]
//   24 vcs          const int32*  [b, k]  real rows of each pair table
//   32 hs           const int32*  [b, va] 0 or 1, 0 past the piece's v_a
//   40 rank         const int32*  [b, va] vocab rank of each value
//   48 cell_off     const int32*  [b + 1]
//   56 piece_va     const int32*  [b]
//   64 rows         const int32*  [cells]
//   72 tables       const int32*  [b, k, vc_pad, va + 1]
//   80 out          uint8*        weak: top int32 [cells], has_domain
//                                 uint8 [cells]; integer: big int32
//                                 [va, cells], tiny int32 [va, cells],
//                                 contributed uint8 [va, cells]
//   88 beta, 96 n_rows            double
//  104 codes_stride               int64
//  112 k, va, vc_pad, cells, weak, shared   int32 each
struct DomainTable {
  const int32_t* codes;
  const int32_t* col_idx;
  const int32_t* taus;
  const int32_t* vcs;
  const int32_t* hs;
  const int32_t* rank;
  const int32_t* cell_off;
  const int32_t* piece_va;
  const int32_t* rows;
  const int32_t* tables;
  uint8_t* out;
  double beta;
  double n_rows;
  int64_t codes_stride;
  int32_t k;
  int32_t va;
  int32_t vc_pad;
  int32_t cells;
  int32_t weak;
  int32_t shared;
};

static_assert(sizeof(DomainTable) == 136, "DomainTable layout");

// What one thread needs to score its cell's values: per correlate, the
// offset of its code's table row (-1 for a NULL code), a column of the
// block's strip; the piece's taus and flags; the tables (shared or
// global). Every function below is inlined, so this stays in registers.
struct Cell {
  const int32_t* rowoff;  // rowoff[c * kThreads]
  const int32_t* taus;
  const int32_t* hs;
  const int32_t* rank;
  const int32_t* tab;
  int k;
};

// A value's tie-break key: its vocab rank, then its slot.
__device__ __forceinline__ unsigned long long rank_key(const Cell& cl,
                                                       int v) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(cl.rank[v]))
          << 32) | static_cast<uint32_t>(v);
}

// The integer sums of value v (the JAX package's _int_score_body).
template <bool kShared>
__device__ __forceinline__ void gather(const Cell& cl, int v, int32_t& big,
                                       int32_t& tiny) {
  big = 0;
  tiny = 0;
  if (cl.hs[v] == 0) return;
  for (int c = 0; c < cl.k; ++c) {
    const int off = cl.rowoff[c * kThreads];
    if (off >= 0) {
      const int32_t g = kShared ? cl.tab[off + v] : __ldg(cl.tab + off + v);
      if (g > cl.taus[c] && g > 0) {
        if (g >= 2) {
          big += g - 1;
        } else {
          tiny += 1;
        }
      }
    }
  }
}

// x = big + 0.1 * tiny, rounded as numpy rounds it; 0 for an inactive
// value (x > 0 exactly when a correlate is active).
template <bool kShared>
__device__ __forceinline__ double numerator(const Cell& cl, int v) {
  int32_t big, tiny;
  gather<kShared>(cl, v, big, tiny);
  return __dadd_rn(static_cast<double>(big),
                   __dmul_rn(0.1, static_cast<double>(tiny)));
}

// The weak-label walk's state: the largest numerator, the least key of
// the values that reach it, and the largest numerator below it.
struct Walk {
  double n_rows;
  double x_max;
  double x_next;
  unsigned long long key_max;
};

// score_v = x / n_rows, numpy's rounding; +0 without a division when x is
// 0. Records v in the walk.
template <bool kShared>
__device__ __forceinline__ double score(const Cell& cl, Walk& w, int v) {
  const double x = numerator<kShared>(cl, v);
  if (x > w.x_max) {
    w.x_next = w.x_max;
    w.x_max = x;
    w.key_max = rank_key(cl, v);
  } else if (x == w.x_max && x > 0.0) {
    const unsigned long long kv = rank_key(cl, v);
    w.key_max = kv < w.key_max ? kv : w.key_max;
  } else if (x > w.x_next) {
    w.x_next = x;
  }
  return x > 0.0 ? __ddiv_rn(x, w.n_rows) : 0.0;
}

// numpy's pairwise_sum of the scores of values lo .. lo + n - 1, n <= 128.
template <bool kShared>
__device__ __forceinline__ double leaf_sum(const Cell& cl, Walk& w, int lo,
                                           int n) {
  if (n < 8) {
    double res = -0.0;
    for (int i = 0; i < n; ++i) res = __dadd_rn(res, score<kShared>(cl, w, lo + i));
    return res;
  }
  double r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = score<kShared>(cl, w, lo + j);
  const int body = n - (n & 7);
  int i = 8;
  for (; i < body; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      r[j] = __dadd_rn(r[j], score<kShared>(cl, w, lo + i + j));
    }
  }
  double res = __dadd_rn(__dadd_rn(__dadd_rn(r[0], r[1]), __dadd_rn(r[2], r[3])),
                         __dadd_rn(__dadd_rn(r[4], r[5]), __dadd_rn(r[6], r[7])));
  for (; i < n; ++i) res = __dadd_rn(res, score<kShared>(cl, w, lo + i));
  return res;
}

// numpy's pairwise_sum of all n scores: one leaf up to 128 values, else
// its halving recursion (halves cut at a multiple of 8), walked with an
// explicit stack of frames.
template <bool kShared>
__device__ __forceinline__ double row_sum(const Cell& cl, Walk& w, int n) {
  if (n <= kLeaf) return leaf_sum<kShared>(cl, w, 0, n);
  constexpr int kDepth = 32;  // halvings of n < 2^31 down to 128 values
  int lo_s[kDepth];
  int n_s[kDepth];
  double left_s[kDepth];  // a frame's left half, once summed
  bool has_left[kDepth];
  int top = 0;
  lo_s[0] = 0;
  n_s[0] = n;
  has_left[0] = false;
  for (;;) {
    while (n_s[top] > kLeaf) {  // down to the leftmost leaf
      int n2 = n_s[top] / 2;
      n2 -= n2 % 8;
      lo_s[top + 1] = lo_s[top];
      n_s[top + 1] = n2;
      has_left[top + 1] = false;
      ++top;
    }
    double ret = leaf_sum<kShared>(cl, w, lo_s[top], n_s[top]);
    for (;;) {  // up: ret is frame top's sum
      if (top == 0) return ret;
      --top;
      if (!has_left[top]) {  // it was the left half: now the right one
        left_s[top] = ret;
        has_left[top] = true;
        int n2 = n_s[top] / 2;
        n2 -= n2 % 8;
        lo_s[top + 1] = lo_s[top] + n2;
        n_s[top + 1] = n_s[top] - n2;
        has_left[top + 1] = false;
        ++top;
        break;
      }
      ret = __dadd_rn(left_s[top], ret);
    }
  }
}

// Scores one cell and writes its outputs at slot `at`: the integer sums
// of every value of the launch, or has_domain and top (`key_any`: the
// least key of the piece's values, the top of a cell with nothing kept,
// as numpy's argmin over ties at -inf).
template <bool kWeak, bool kShared>
__device__ __forceinline__ void score_cell(const DomainTable& t,
                                           const Cell& cl, int64_t at,
                                           int va_p,
                                           unsigned long long key_any) {
  const int va = t.va;
  const int64_t cells = t.cells;
  if (!kWeak) {
    int32_t* big_out = reinterpret_cast<int32_t*>(t.out);
    int32_t* tiny_out = big_out + static_cast<int64_t>(va) * cells;
    uint8_t* con_out =
        reinterpret_cast<uint8_t*>(tiny_out + static_cast<int64_t>(va) * cells);
    for (int v = 0; v < va; ++v) {
      int32_t big, tiny;
      gather<kShared>(cl, v, big, tiny);
      const int64_t o = v * cells + at;
      big_out[o] = big;
      tiny_out[o] = tiny;
      con_out[o] = (big | tiny) != 0 ? 1 : 0;
    }
    return;
  }
  Walk w{t.n_rows, 0.0, 0.0, ~0ull};
  const double denom = row_sum<kShared>(cl, w, va_p);
  // The pick. Probabilities rise with x, so the top one is x_max's, and
  // when no other numerator lies within 2^-40 of x_max only the values
  // of x_max tie with it. Otherwise a second walk compares the exact
  // probabilities of every value within 2^-40 of x_max.
  bool has = false;
  unsigned long long key = ~0ull;
  if (w.x_max > 0.0) {
    const double floor_x = w.x_max - w.x_max * 0x1p-40;
    if (w.x_next < floor_x) {
      has = __ddiv_rn(__ddiv_rn(w.x_max, t.n_rows), denom) > t.beta;
      key = w.key_max;
    } else {
      double best = -CUDART_INF;
      for (int v = 0; v < va_p; ++v) {
        const double x = numerator<kShared>(cl, v);
        if (x < floor_x) continue;
        const double prob = __ddiv_rn(__ddiv_rn(x, t.n_rows), denom);
        const unsigned long long kv = rank_key(cl, v);
        if (prob > t.beta && (prob > best || (prob == best && kv < key))) {
          best = prob;
          key = kv;
        }
      }
      has = best > -CUDART_INF;
    }
  }
  const unsigned long long pick = has ? key : key_any;
  reinterpret_cast<int32_t*>(t.out)[at] =
      pick == ~0ull ? 0 : static_cast<int32_t>(pick & 0xffffffffu);
  t.out[4 * cells + at] = has ? 1 : 0;
}

template <bool kWeak, bool kShared>
__global__ void __launch_bounds__(kThreads)
domain_kernel(const DomainTable t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockIdx.y;
  const int lo = t.cell_off[p];
  const int m = t.cell_off[p + 1] - lo;
  // a block without a cell of its piece leaves at once (uniformly)
  if (static_cast<int>(blockIdx.x) * kThreads >= m) return;

  const int k = t.k;
  const int va = t.va;
  const int width = va + 1;
  const int pitch = kShared ? (width | 1) : width;
  const int tab_elems = t.vc_pad * pitch;  // one correlate's table
  const int va_p = t.piece_va[p];
  const int32_t* gtab =
      t.tables + static_cast<int64_t>(p) * k * t.vc_pad * width;

  // shared memory: the row-offset strip, the per-piece operands, the
  // tables
  int32_t* rowoff_s = reinterpret_cast<int32_t*>(smem);
  int32_t* cols_s = rowoff_s + k * kThreads;
  int32_t* taus_s = cols_s + k;
  int32_t* vcs_s = taus_s + k;
  int32_t* hs_s = vcs_s + k;
  int32_t* rank_s = hs_s + va;
  int32_t* tab_s = rank_s + (kWeak ? va : 0);

  for (int i = threadIdx.x; i < k; i += kThreads) {
    cols_s[i] = t.col_idx[p * k + i];
    taus_s[i] = t.taus[p * k + i];
    vcs_s[i] = t.vcs[p * k + i];
  }
  for (int v = threadIdx.x; v < va; v += kThreads) {
    hs_s[v] = v < va_p ? t.hs[p * va + v] : 0;
    if (kWeak) rank_s[v] = t.rank[p * va + v];
  }
  if (kShared) {
    // a warp per table row, its lanes along the row
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int c = 0; c < k; ++c) {
      const int rows_c = t.vcs[p * k + c];
      for (int r = warp; r < rows_c; r += kThreads / 32) {
        const int32_t* src =
            gtab + (static_cast<int64_t>(c) * t.vc_pad + r) * width;
        int32_t* dst = tab_s + c * tab_elems + r * pitch;
        for (int i = lane; i < width; i += 32) dst[i] = __ldg(src + i);
      }
    }
  }
  __syncthreads();

  Cell cl;
  cl.rowoff = rowoff_s + threadIdx.x;
  cl.taus = taus_s;
  cl.hs = hs_s;
  cl.rank = rank_s;
  cl.tab = kShared ? tab_s : gtab;
  cl.k = k;
  unsigned long long key_any = ~0ull;
  for (int v = 0; kWeak && v < va_p; ++v) {
    const unsigned long long kv = rank_key(cl, v);
    key_any = kv < key_any ? kv : key_any;
  }

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < m;
       i += gridDim.x * kThreads) {
    const int row = t.rows[lo + i];
    for (int c = 0; c < k; ++c) {
      const int code = __ldg(t.codes + cols_s[c] * t.codes_stride + row);
      rowoff_s[c * kThreads + threadIdx.x] =
          code >= 0 && code + 1 < vcs_s[c]
              ? c * tab_elems + (code + 1) * pitch + 1
              : -1;
    }
    score_cell<kWeak, kShared>(t, cl, lo + i, va_p, key_any);
  }
}

template <bool kWeak, bool kShared>
int launch(const DomainTable& t, int grid_x, int grid_y, int smem,
           cudaStream_t stream) {
  auto kernel = domain_kernel<kWeak, kShared>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(grid_x, grid_y), kThreads, smem, stream>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Enqueues one launch on `stream`; returns the first CUDA error.
extern "C" int delphi_domain_scores(const void* table, int grid_x, int grid_y,
                                    int smem, void* stream) {
  const DomainTable& t = *static_cast<const DomainTable*>(table);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t.weak) {
    return t.shared ? launch<true, true>(t, grid_x, grid_y, smem, s)
                    : launch<true, false>(t, grid_x, grid_y, smem, s);
  }
  return t.shared ? launch<false, true>(t, grid_x, grid_y, smem, s)
                  : launch<false, false>(t, grid_x, grid_y, smem, s);
}
