// Masked packed suffix-vs-pattern compare for Hopper, and the batched
// two-bound search of the base suffix array built on it.
//
// Replaces the TPU kernel repro/kernels/pattern_scan.py::
// pattern_compare_pallas (one search round) and, through
// bounded_search, the round loop of repro/core/query.py::
// _bounded_search that drives it.
//
// The mask, text word, compare and 17-ary warp search live in
// search.cuh.
//
// Bound: the compare entry point is bytes (2W words in, 3 bytes out per
// query).  The search is latency: each round is a gather of sa[row]
// and then of the text words at that position, and the next round
// needs the result.  Design: search.cuh's warp_kary_bounds over rows
// [0, n_rows), one warp per query (lanes 0-15 the lower bound, pred =
// lt; lanes 16-31 the upper, pred = lt || eq), 16 splitter rows per
// bound per round: floor(log17 n_rows) + 1 rounds, 7 at 2**26 rows
// where the binary search needs 27.  The pattern is staged per warp in
// shared memory.  A probe reads sa[row], then issues the loads of every
// text word its compare may need (ceil(plen / 16) words, one more when
// the position is not word aligned) before comparing any, and
// funnel-shifts the window out of them: two round trips per round.
// Widths: W <= 256 words (search.cuh).  The compare takes 16 words at a
// time (compare_text: 17 independent loads, then 16 compares); a pattern
// past 16 words takes the next 16 only while its prefix still compares
// equal.  Batches with W <= 16 launch the one-chunk instance
// (bounded_search_kernel<false>), whose code is the single-chunk compare
// with no loop around it; wider batches the chunked one.  One kernel
// for every width, with the chunk loop or with the first chunk peeled
// out of it, took 12% more device time at W = 8 on an H100 (PERF.md).
// Blocks of 4 warps; lane 0 writes both bounds.  The result is the
// exact partition point, the binary search's (query.
// search_bounds_plain): pad rows sort first and are truncated, so the
// predicates stay monotone.
//
// pattern_compare on the serving path is an epilogue of the same
// launch: lane 0 of the warp that found (lb, ub) compares the staged
// pattern with the suffix at sa[lb] (compare_text) and writes query.
// MatchResult's four fields (found, count, first_rank, first_pos), so
// no window tensor, second launch or host-side result assembly is left
// (bounded_match_cuda).  The search alone (bounded_search_cuda, the
// compaction merge's insertion search) passes null epilogue outputs.  ptxas (-Xptxas -v, sm_90a): registers,
// shared memory and spills are printed by chip_smoke.py ([ptxas] line)
// and recorded in PERF.md.
#include "search.cuh"

#define WARPS 4

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

// lt / eq of the suffix at text position pos against a pattern of
// plen bases (W words at patt), as compare(), 16 words at a time: every
// text word a chunk's compares may read is loaded first, all independent
// of each other, and the window words are funnel-shifted out of them
// (words past the end of the text read 0, as text_word).  The next
// chunk is taken only while the prefix still compares equal; LONG =
// false (W <= 16) compiles the first chunk alone.
template <bool LONG>
__device__ __forceinline__ void compare_text(const uint32_t* __restrict__ t,
                                             long long n_words,
                                             long long pos,
                                             const uint32_t* patt, int W,
                                             int plen, long long n_real,
                                             bool& lt, bool& eq) {
  int used = (plen + 15) >> 4;        // words the masks keep
  used = used < 0 ? 0 : (used > W ? W : used);
  const long long idx = pos >> 4;
  const uint32_t sh = 2u * (uint32_t)(pos & 15);
  bool pe = true;
  lt = false;
  for (int w0 = 0; w0 < used && pe; w0 += CHUNK_WORDS) {
    const int cu = used - w0 < CHUNK_WORDS ? used - w0 : CHUNK_WORDS;
    const int need = cu + (sh != 0 ? 1 : 0);
    const long long base = idx + w0;
    uint32_t tw[CHUNK_WORDS + 1];
#pragma unroll
    for (int k = 0; k <= CHUNK_WORDS; ++k)
      tw[k] = k < need && base + k < n_words ? __ldg(t + base + k) : 0u;
#pragma unroll
    for (int w = 0; w < CHUNK_WORDS; ++w) {
      if (w < cu && pe) {
        const uint32_t m = word_mask(plen, w0 + w);
        // (tw[w] << sh) | (tw[w + 1] >> (32 - sh)), and tw[w] for sh == 0
        const uint32_t a = __funnelshift_l(tw[w + 1], tw[w], sh) & m;
        const uint32_t b = patt[w0 + w] & m;
        if (a != b) {
          lt = a < b;
          pe = false;
        }
      }
    }
    if (!LONG) break;
  }
  const bool truncated = pos + (long long)plen > n_real;
  eq = pe && !truncated;
  lt = lt || (pe && truncated);
}

template <bool LONG>
__global__ void __launch_bounds__(WARPS * 32)
bounded_search_kernel(const int32_t* __restrict__ sa, int n_rows,
                      const uint32_t* __restrict__ text, long long n_words,
                      long long n_real,
                      const uint32_t* __restrict__ patt,  // (B, W)
                      const int32_t* __restrict__ plen,   // (B,)
                      int B, int W, int pad_count,
                      int32_t* __restrict__ lb_out,   // (B,) or null
                      int32_t* __restrict__ ub_out,   // (B,) or null
                      uint8_t* __restrict__ found_out,  // (B,) or null
                      int32_t* __restrict__ count_out,
                      int32_t* __restrict__ rank_out,
                      int32_t* __restrict__ pos_out) {
  extern __shared__ uint32_t s_patt[];  // (WARPS, W)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= B) return;  // uniform per warp; no block barrier follows
  uint32_t* p = s_patt + warp * W;
  stage_pattern(p, patt + (long long)q * W, 1, W);
  const int L = plen[q];
  int lb, ub;
  warp_kary_bounds(n_rows, [&](int row, bool upper) {
    bool lt, eq;
    compare_text<LONG>(text, n_words, (long long)__ldg(sa + row), p, W, L,
                       n_real, lt, eq);
    return upper ? (lt || eq) : lt;
  }, lb, ub);
  if (lane != 0) return;
  if (lb_out != nullptr) {
    lb_out[q] = lb;
    ub_out[q] = ub;
  }
  if (found_out != nullptr) {
    // the rows [lb, ub) are exactly the matching rows, so the row the
    // result reports matches iff the suffix at sa[lb] equals the pattern
    bool lt = false, eq = false;
    int pos = -1;
    if (lb < n_rows) {
      pos = __ldg(sa + lb);
      compare_text<LONG>(text, n_words, (long long)pos, p, W, L, n_real, lt,
                         eq);
    }
    found_out[q] = eq ? 1 : 0;
    count_out[q] = ub - lb;
    rank_out[q] = eq ? lb - pad_count : -1;
    pos_out[q] = eq ? pos : -1;
  }
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

// lb/ub and the epilogue outputs (found .. pos) may each be null
// (both of a group together); the epilogue runs when found is not.
extern "C" int bounded_search_launch(const int32_t* sa, int n_rows,
                                     const uint32_t* text, long long n_words,
                                     long long n_real, const uint32_t* patt,
                                     const int32_t* plen, int B, int W,
                                     int pad_count, int32_t* lb, int32_t* ub,
                                     uint8_t* found, int32_t* count,
                                     int32_t* rank, int32_t* pos,
                                     cudaStream_t stream) {
  if (B <= 0) return 0;
  if (W < 0 || W > MAX_PATTERN_WORDS) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
  const size_t smem = (size_t)WARPS * W * sizeof(uint32_t);
  if (W <= CHUNK_WORDS)
    bounded_search_kernel<false><<<grid, block, smem, stream>>>(
        sa, n_rows, text, n_words, n_real, patt, plen, B, W, pad_count, lb,
        ub, found, count, rank, pos);
  else
    bounded_search_kernel<true><<<grid, block, smem, stream>>>(
        sa, n_rows, text, n_words, n_real, patt, plen, B, W, pad_count, lb,
        ub, found, count, rank, pos);
  return (int)cudaGetLastError();
}
