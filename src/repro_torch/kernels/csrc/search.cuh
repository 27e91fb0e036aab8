// Device helpers shared by the scan kernels (pattern_scan.cu,
// tablet_scan.cu, tier_scan.cu): the per-word pattern mask, the
// funnel-shifted text word, the early-exit masked compare, and the
// 17-ary two-bound warp search over sorted rows.  fm_scan.cu includes
// it for the width limit alone.
//
// Words are big-endian 2-bit DNA (16 bases per uint32), so an unsigned
// word compare is a 16-base lexicographic compare.  Word w of a query
// keeps its first clamp(plen - 16w, 0, 16) bases; the shift by 32 that
// r == 0 would need is undefined in C, hence the guard in word_mask.  A
// suffix shorter than the pattern (pos + plen > n_real) is "less",
// never "equal".
//
// Pattern widths: a warp stages its query's W pattern words in dynamic
// shared memory (stage_pattern), W <= MAX_PATTERN_WORDS = 256 (4096
// bases), so a block of 4 warps holds at most 4 KB.  The wrappers raise
// for a wider batch; nothing is truncated.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define BIG (1 << 30)    // "no match" sentinel of first_row / first_g
#define FULL_MASK 0xFFFFFFFFu
#define MAX_PATTERN_WORDS 256  // widest batch the searches take (W)
#define CHUNK_WORDS 16   // words a compare loads before comparing any
#define ARITY 17         // 16 splitters cut an interval into 17 parts

// One warp copies its query's W pattern words (stride ``stride``
// between words, 1 for a (B, W) batch, B for a (W, B) one) into ``dst``.
// For W <= 32 this is one load a lane.
__device__ __forceinline__ void stage_pattern(uint32_t* dst,
                                              const uint32_t* __restrict__ src,
                                              long long stride, int W) {
  for (int w = threadIdx.x & 31; w < W; w += 32) dst[w] = src[w * stride];
  __syncwarp();
}

__device__ __forceinline__ uint32_t word_mask(int plen, int w) {
  int r = plen - w * 16;
  r = r < 0 ? 0 : (r > 16 ? 16 : r);
  if (r == 0) return 0u;
  if (r == 16) return 0xFFFFFFFFu;
  return ~((1u << (32 - 2 * r)) - 1u);
}

// Word w of the suffix starting at base pos, funnel-shifted out of the
// packed text; words past the end read 0 (codec.extract_window).
__device__ __forceinline__ uint32_t text_word(const uint32_t* __restrict__ t,
                                              long long n_words,
                                              long long pos, int w) {
  long long idx = (pos >> 4) + w;
  uint32_t sh = 2u * (uint32_t)(pos & 15);
  uint32_t hi = idx < n_words ? t[idx] : 0u;
  if (sh == 0) return hi;
  uint32_t lo = idx + 1 < n_words ? t[idx + 1] : 0u;
  return (hi << sh) | (lo >> (32u - sh));
}

// lt / eq of a suffix window against a pattern at depth plen.
template <typename Window>
__device__ __forceinline__ void compare(Window win,
                                        const uint32_t* __restrict__ patt,
                                        int W, int plen, long long pos,
                                        long long n_real, bool& lt,
                                        bool& eq) {
  bool pe = true;
  lt = false;
  for (int w = 0; w < W; ++w) {
    uint32_t m = word_mask(plen, w);
    if (m == 0u) break;  // this and every later word is masked out
    uint32_t a = win(w) & m;
    uint32_t b = patt[w] & m;
    if (a != b) {
      lt = a < b;
      pe = false;
      break;
    }
  }
  bool truncated = pos + (long long)plen > n_real;
  eq = pe && !truncated;
  lt = lt || (pe && truncated);
}

// Splitter j (0..15) of the interval [lo, lo + n): row lo + (j+1)n / 17.
// For n >= 1 every splitter lies in [lo, lo + n); below 17 rows they
// repeat, which changes nothing (a repeated row gives the same answer).
__device__ __forceinline__ int splitter(int lo, int n, int j) {
  return lo + (int)(((long long)(j + 1) * n) / ARITY);
}

// Both bounds of one query over sorted rows [0, n_rows), by one whole
// warp: lanes 0-15 search the lower bound (first row where pred = lt is
// false), lanes 16-31 the upper bound (pred = lt || eq).  Over sorted
// rows pred is true on a prefix, so the ballot's set bits in a half are
// its first c splitters and the bound lies in (splitter c-1, splitter c].
// Each round cuts an interval of n rows to at most n / 17, so a search
// takes floor(log17 n) + 1 rounds at most; both halves loop until empty.
// The result is the exact partition point, as the plain binary
// search's (query.search_bounds_plain) is.  probe(row, upper) returns
// pred for one row.
template <typename Probe>
__device__ __forceinline__ void warp_kary_bounds(int n_rows, Probe probe,
                                                int& lb, int& ub) {
  const int lane = threadIdx.x & 31;
  const int j = lane & 15;
  const bool upper = lane >= 16;
  int lo = 0, hi = n_rows;
  while (__any_sync(FULL_MASK, lo < hi)) {
    int n = hi - lo;
    bool pred = n > 0 && probe(splitter(lo, n, j), upper);
    unsigned bal = __ballot_sync(FULL_MASK, pred);
    int c = __popc(upper ? bal >> 16 : bal & 0xFFFFu);
    if (n > 0) {
      int nlo = c > 0 ? splitter(lo, n, c - 1) + 1 : lo;
      hi = c < 16 ? splitter(lo, n, c) : hi;
      lo = nlo;
    }
  }
  lb = __shfl_sync(FULL_MASK, lo, 0);
  ub = __shfl_sync(FULL_MASK, lo, 16);
}
