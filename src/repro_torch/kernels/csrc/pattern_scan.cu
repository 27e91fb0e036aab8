// Masked packed suffix-vs-pattern compare for Hopper, and the batched
// binary search built on it.
//
// Replaces the TPU kernel repro/kernels/pattern_scan.py::
// pattern_compare_pallas (one search round) and, through
// bounded_search, the round loop of repro/core/query.py::
// _bounded_search that drives it.
//
// The mask, text word and compare live in search.cuh.
//
// Bound: the compare entry point is bytes (2W words in, 3 bytes out per
// query).  The search is latency: each of its ceil(log2(n+1)) rounds
// is a dependent gather of sa[mid] and two text words.  Design: one
// thread per (query, bound); both bounds of all queries run all rounds
// in one launch, and a thread stops at the first differing word and
// once its interval is empty.
#include "search.cuh"

__global__ void pattern_compare_kernel(const uint32_t* __restrict__ win,
                                       const uint32_t* __restrict__ patt,
                                       const int32_t* __restrict__ plen,
                                       const int32_t* __restrict__ pos,
                                       long long n_real, int B, int W,
                                       int8_t* __restrict__ lt_out,
                                       int8_t* __restrict__ le_out,
                                       int8_t* __restrict__ eq_out) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;
  const uint32_t* row = win + (long long)q * W;
  bool lt, eq;
  compare([row](int w) { return row[w]; }, patt + (long long)q * W, W,
          plen[q], (long long)pos[q], n_real, lt, eq);
  lt_out[q] = lt;
  le_out[q] = lt || eq;
  eq_out[q] = eq;
}

__global__ void bounded_search_kernel(const int32_t* __restrict__ sa,
                                      int n_rows,
                                      const uint32_t* __restrict__ text,
                                      long long n_words, long long n_real,
                                      const uint32_t* __restrict__ patt,
                                      const int32_t* __restrict__ plen,
                                      int B, int W, int steps,
                                      int32_t* __restrict__ lb,
                                      int32_t* __restrict__ ub) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * B) return;
  int q = t >> 1;
  bool upper = t & 1;  // 0: pred = lt (lower bound), 1: lt | eq
  const uint32_t* p = patt + (long long)q * W;
  int L = plen[q];
  int lo = 0, hi = n_rows;
  for (int s = 0; s < steps && lo < hi; ++s) {
    int mid = (lo + hi) / 2;
    int row = mid < n_rows - 1 ? mid : n_rows - 1;
    long long pos = sa[row];
    bool lt, eq;
    compare([=](int w) { return text_word(text, n_words, pos, w); }, p, W,
            L, pos, n_real, lt, eq);
    bool pred = upper ? (lt || eq) : lt;
    if (pred) lo = mid + 1; else hi = mid;
  }
  if (upper) ub[q] = lo; else lb[q] = lo;
}

extern "C" int pattern_compare_launch(const uint32_t* win,
                                      const uint32_t* patt,
                                      const int32_t* plen,
                                      const int32_t* pos, long long n_real,
                                      int B, int W, int8_t* lt, int8_t* le,
                                      int8_t* eq, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  pattern_compare_kernel<<<(B + threads - 1) / threads, threads, 0,
                           stream>>>(win, patt, plen, pos, n_real, B, W, lt,
                                     le, eq);
  return (int)cudaGetLastError();
}

extern "C" int bounded_search_launch(const int32_t* sa, int n_rows,
                                     const uint32_t* text, long long n_words,
                                     long long n_real, const uint32_t* patt,
                                     const int32_t* plen, int B, int W,
                                     int steps, int32_t* lb, int32_t* ub,
                                     cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  int total = 2 * B;
  bounded_search_kernel<<<(total + threads - 1) / threads, threads, 0,
                          stream>>>(sa, n_rows, text, n_words, n_real, patt,
                                    plen, B, W, steps, lb, ub);
  return (int)cudaGetLastError();
}
