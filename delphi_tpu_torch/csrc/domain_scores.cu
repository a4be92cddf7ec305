// K5 domain_scores: the bucketed domain route's gather-reduce.
//
// Replaces the integer mode of delphi_tpu/ops/domain.py::_jit_bucket_kernel
// (a vmap over the pieces of one launch of _int_score_body), which XLA
// jits. For each piece p of a launch, each of its padded rows r and each
// candidate value v of its target attribute:
//   row   = row_idx[p, r]                       (the sentinel row: all NULL)
//   code  = codes[col_idx[p, c], row]           for each correlate c < k
//   g     = tables[p, c, code + 1, 1 + v]       (the pair count)
//   active  iff  code != NULL && g > taus[p, c] && g > 0 && hs[p, v]
//   big   = sum over active c of (g - 1 if g >= 2 else 0)
//   tiny  = #(active c with g == 1)
//   contributed = any active c
// all in int32: the caller only sends groups whose k * max pair count stays
// under 2^31 (the JAX package's 2^31 guard). The f64 recombination, the
// beta mask and the rank tie-break stay on the host, bit for bit the host
// numpy route's.
//
// What bounds it on an H100: the bytes. Every output cell writes 9 bytes
// (two int32 sums and a flag) and reads one pair count per correlate; the
// gathered codes and the tables are small beside that. Its operations are
// a handful of integer compares per correlate.
//
// Design (simple first): one thread per (piece, row, value), in a
// grid-stride loop over the flattened [b, rows_pad, va_pad] output, looping
// over the k correlates. va_pad is the launch's value width (the widest
// piece's values, no padding): a warp covers consecutive values of one or
// a few (piece, row)s, so its code loads touch a few addresses, its
// pair-count loads runs of consecutive elements of a few table rows, and
// its stores 32 consecutive output elements.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Mirrored by ops/kernels/domain_scores.py::DomainTable (ctypes); 104
// bytes, passed to the kernel by value.
//    0 codes        const int32*  [n_cols, codes_stride], NULL = -1
//    8 col_idx      const int32*  [b, k]
//   16 taus         const int32*  [b, k]
//   24 hs           const int32*  [b, va_pad], 0 or 1
//   32 row_idx      const int32*  [b, rows_pad]
//   40 tables       const int32*  [b, k, vc_pad, va_pad + 1]
//   48 big          int32*        [b, rows_pad, va_pad]
//   56 tiny         int32*        [b, rows_pad, va_pad]
//   64 contributed  uint8*        [b, rows_pad, va_pad]
//   72 codes_stride int64
//   80 b, k, va_pad, vc_pad, rows_pad, pad   int32 each
struct DomainTable {
  const int32_t* codes;
  const int32_t* col_idx;
  const int32_t* taus;
  const int32_t* hs;
  const int32_t* row_idx;
  const int32_t* tables;
  int32_t* big;
  int32_t* tiny;
  uint8_t* contributed;
  int64_t codes_stride;
  int32_t b;
  int32_t k;
  int32_t va_pad;
  int32_t vc_pad;
  int32_t rows_pad;
  int32_t pad;
};

static_assert(sizeof(DomainTable) == 104, "DomainTable layout");

__global__ void __launch_bounds__(kThreads)
domain_scores_kernel(const DomainTable t) {
  const int64_t total = static_cast<int64_t>(t.b) * t.rows_pad * t.va_pad;
  const int64_t width = static_cast<int64_t>(t.va_pad) + 1;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += step) {
    const int v = static_cast<int>(i % t.va_pad);
    const int64_t pr = i / t.va_pad;
    const int p = static_cast<int>(pr / t.rows_pad);
    int32_t big = 0;
    int32_t tiny = 0;
    bool any = false;
    if (t.hs[static_cast<int64_t>(p) * t.va_pad + v] != 0) {
      const int64_t row = t.row_idx[pr];
      const int32_t* cols = t.col_idx + static_cast<int64_t>(p) * t.k;
      const int32_t* taus = t.taus + static_cast<int64_t>(p) * t.k;
      const int32_t* tab = t.tables +
          static_cast<int64_t>(p) * t.k * t.vc_pad * width + 1 + v;
      for (int c = 0; c < t.k; ++c) {
        const int32_t code = t.codes[cols[c] * t.codes_stride + row];
        if (code >= 0) {
          const int32_t g =
              tab[(static_cast<int64_t>(c) * t.vc_pad + code + 1) * width];
          if (g > taus[c] && g > 0) {
            any = true;
            if (g >= 2) {
              big += g - 1;
            } else {
              tiny += 1;
            }
          }
        }
      }
    }
    t.big[i] = big;
    t.tiny[i] = tiny;
    t.contributed[i] = any ? 1 : 0;
  }
}

}  // namespace

// Enqueues one launch on `stream`; returns the first CUDA error.
extern "C" int delphi_domain_scores(const void* table, int grid,
                                    void* stream) {
  const DomainTable& t = *static_cast<const DomainTable*>(table);
  domain_scores_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
