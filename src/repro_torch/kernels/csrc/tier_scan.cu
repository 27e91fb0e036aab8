// Multi-tier scan for Hopper: every pattern against every delta tier
// (sealed runs + memtable), by a 17-ary search per (query, tier) over
// the tier's sorted rows, then the straddle rule over the match run.
//
// Replaces the TPU kernel repro/kernels/tier_scan.py::tier_scan_pallas.
//
// Per tier t (meta row [n_real, n_rows, offset, lo, hi, 0, 0, 0]) and
// query q, over rows r < n_rows:
//   eq     = the suffix at sa[t, r] prefix-equals the pattern to depth
//            plen and is not shorter than it (sa + plen <= n_real)
//   lt     = suffix < pattern, or prefix-equal but truncated
//   g      = sa + offset (global start), e = g + plen
//   owned  = eq && lo < e <= hi                  (the straddle rule)
//   count  = #owned, less = #lt, matches = #eq, first_g = min owned g
// first_g is 2**30 when the tier owns no match.
//
// Contract: each tier's rows [0, n_rows) are sorted suffix rows (rows
// past n_rows are bucket padding, not sorted, and never read).  Over
// sorted rows "row < pattern" is monotone (a truncated prefix-equal row
// counts as less; pad rows sort first and are truncated), so less = lb,
// the first row where lt is false, matches = ub - lb with ub the first
// row where lt || eq is false, and the rows [lb, ub) are exactly the
// eq rows: count and first_g need only those.
//
// Padding: rows whose position lies at or past the tier's own text (sa
// >= hi - offset: the bucket padding of symbol 0 and the store's pad
// rows) are never owned (e > hi).  pad_cnt[t, r] counts them among rows
// [0, r).  Padding with the smallest symbol sorts every such row first
// (a suffix 0^j lies before every suffix holding another symbol), so
// when pad_cnt[t, n] == n for n = pad_cnt[t, R], rows [0, n) are all
// padding and the sweep starts at max(lb, n).
//
// Bound: latency.  Each search round is two dependent gathers (sa at
// the splitter row, then the text words at that position); the bytes
// are those of the probed rows and the match runs.  Design:
//   1. one warp per (query, tier), blocks of 4 warps, each staging its
//      query's pattern in shared memory (W <= 256 words, search.cuh; the
//      compare walks the words with an early exit); lanes 0-15 and
//      16-31 search the two bounds (search.cuh warp_kary_bounds), 16
//      splitters per round: 5 rounds for a 2**19-row tier where a binary
//      search needs 20.  Probes read sa and the stacked packed text
//      directly (text_word), so no (T, W, R) window tensor is built.
//   2. the straddle rule over the match runs only, their padding
//      skipped, by the whole block: after the searches its 128 threads
//      sweep each of its 4 runs in turn (coalesced loads of sa, 16
//      independent loads in flight per thread), count by warp sums and
//      first_g by warp minimums into shared memory.  The launch lasts
//      as long as the block with the longest run takes: a 1-base
//      pattern's run holds a quarter of a tier's real rows, and at the
//      main path's shape also 262,017 rows of padding, which it skips.
//   3. the warp that searched a run reduces the block's 4 partials and
//      lane 0 writes its four outputs: no atomics and no preset outputs.
// ptxas (-Xptxas -v, sm_90a): registers, shared memory and spills are
// printed by chip_smoke.py ([ptxas] line) and recorded in PERF.md.
#include "search.cuh"

#define WARPS 4    // warps per block: one (query, tier) each
#define UNROLL 16  // independent sa loads in flight per thread in a sweep

__global__ void __launch_bounds__(WARPS * 32)
tier_scan_kernel(const uint32_t* __restrict__ patt,   // (W, B)
                 const int32_t* __restrict__ plen,    // (B,)
                 const uint32_t* __restrict__ text,   // (T, n_words)
                 long long n_words,
                 const int32_t* __restrict__ sa,      // (T, R)
                 const int32_t* __restrict__ pad_cnt, // (T, R + 1)
                 const int32_t* __restrict__ meta,    // (T, 8)
                 int T, int B, int W, int R,
                 int32_t* __restrict__ count,         // (T, B)
                 int32_t* __restrict__ less,
                 int32_t* __restrict__ matches,
                 int32_t* __restrict__ first) {
  extern __shared__ uint32_t s_patt[];                  // (WARPS, W)
  __shared__ int s_start[WARPS], s_len[WARPS];          // this block's runs
  __shared__ int s_cnt[WARPS][WARPS], s_min[WARPS][WARPS];  // [run][warp]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n_items = (long long)T * B;
  const long long item0 = (long long)blockIdx.x * WARPS;
  const long long item = item0 + warp;  // t * B + q

  // 1. the two bounds of this warp's (query, tier), and the sweep's start
  int lb = 0, ub = 0, start = 0;
  if (item < n_items) {  // uniform per warp
    const int t = (int)(item / B), q = (int)(item % B);
    const int32_t* m = meta + 8 * t;
    const long long n_real = m[0];
    const int n_rows = max(0, min(m[1], R));  // rows past R do not exist
    uint32_t* p = s_patt + warp * W;
    stage_pattern(p, patt + q, B, W);
    const int L = plen[q];
    const uint32_t* text_t = text + (long long)t * n_words;
    const int32_t* sa_t = sa + (long long)t * R;
    const int32_t* pc = pad_cnt + (long long)t * (R + 1);
    const int n_pads = pc[R];
    warp_kary_bounds(n_rows, [&](int row, bool upper) {
      long long pos = sa_t[row];
      bool lt, eq;
      compare([=](int w) { return text_word(text_t, n_words, pos, w); }, p,
              W, L, pos, n_real, lt, eq);
      return upper ? (lt || eq) : lt;
    }, lb, ub);
    const int skip = pc[n_pads] == n_pads ? n_pads : 0;  // rows [0, skip)
    start = min(max(lb, skip), ub);
  }
  if (lane == 0) {
    s_start[warp] = start;
    s_len[warp] = ub - start;
  }
  __syncthreads();

  // 2. the straddle rule over each run of the block, by all its threads
  const int stride = WARPS * 32;
  for (int k = 0; k < WARPS; ++k) {
    const int len = s_len[k];
    int cnt = 0, mn = BIG;
    if (len > 0) {  // uniform per block
      const long long it = item0 + k;
      const int t = (int)(it / B), q = (int)(it % B);
      const int32_t* m = meta + 8 * t;
      const long long offset = m[2], lo_b = m[3], hi_b = m[4];
      const long long L = plen[q];
      const int32_t* run = sa + (long long)t * R + s_start[k];
      for (int r0 = threadIdx.x; r0 < len; r0 += stride * UNROLL) {
        int v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          int r = r0 + u * stride;
          v[u] = r < len ? __ldg(run + r) : 0;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          long long g = v[u] + offset, e = g + L;
          if (r0 + u * stride < len && e > lo_b && e <= hi_b) {
            ++cnt;
            mn = min(mn, (int)g);  // owned: g < hi <= 2**30
          }
        }
      }
    }
    cnt = __reduce_add_sync(FULL_MASK, cnt);
    mn = __reduce_min_sync(FULL_MASK, mn);
    if (lane == 0) {
      s_cnt[k][warp] = cnt;
      s_min[k][warp] = mn;
    }
  }
  __syncthreads();

  // 3. each warp reduces its run's partials, lane 0 writes the outputs
  if (item < n_items) {
    int c = lane < WARPS ? s_cnt[warp][lane] : 0;
    int f = lane < WARPS ? s_min[warp][lane] : BIG;
    c = __reduce_add_sync(FULL_MASK, c);
    f = __reduce_min_sync(FULL_MASK, f);
    if (lane == 0) {
      count[item] = c;
      less[item] = lb;
      matches[item] = ub - lb;
      first[item] = f;
    }
  }
}

extern "C" int tier_scan_launch(const uint32_t* patt, const int32_t* plen,
                                const uint32_t* text, long long n_words,
                                const int32_t* sa, const int32_t* pad_cnt,
                                const int32_t* meta,
                                int T, int B, int W, int R, int32_t* count,
                                int32_t* less, int32_t* matches,
                                int32_t* first, cudaStream_t stream) {
  long long n_items = (long long)T * B;
  if (n_items <= 0) return 0;
  if (W < 0 || W > MAX_PATTERN_WORDS) return (int)cudaErrorInvalidValue;
  tier_scan_kernel<<<(unsigned)((n_items + WARPS - 1) / WARPS), WARPS * 32,
                     (size_t)WARPS * W * sizeof(uint32_t), stream>>>(
      patt, plen, text, n_words, sa, pad_cnt, meta, T, B, W, R, count, less,
      matches, first);
  return (int)cudaGetLastError();
}
