// Tablet range scan for Hopper: every pattern against a block of
// consecutive sorted suffix rows, answered by a 17-ary search.
//
// Replaces the TPU kernel repro/kernels/tablet_scan.py::
// tablet_scan_pallas.
//
// Per query q, over the R rows of the windows:
//   eq    = window prefix-equals the pattern to depth plen and the suffix
//           is not shorter than the pattern (pos + plen <= n_real)
//   lt    = window < pattern, or prefix-equal but truncated
//   count = #eq, less = #lt, first_row = min r with eq (2**30 when none)
//
// Contract: the rows are consecutive sorted suffix rows, as the TPU
// kernel's docstring requires.  Over them "row < pattern" is monotone (a
// truncated prefix-equal row counts as less; pad rows sort first and
// are truncated), so less is the first row where lt is false, count is
// ub - less with ub the first row where lt || eq is false, and first_row
// is less when count > 0.
//
// Bound: latency.  The bytes the search needs are a few per probed row
// (its position and the window words the early-exit compare reads), far
// below the card's rate; each of its floor(log17 R) + 1 rounds is one
// dependent gather.  Design: one warp per query (search.cuh
// warp_kary_bounds), 16 lanes per bound probing 16 splitter rows per
// round: 7 rounds for 2**26 rows where a binary search needs 27.  A
// probe reads pos[row] and the words win[w * R + row] it compares, both
// independent of each other.  Blocks of 4 warps; the pattern is staged
// in shared memory per warp (W <= 256 words, search.cuh; the compare
// walks the words with an early exit, so a wide pattern costs words
// only while its prefix compares equal).  Lane 0 writes the three outputs: no
// atomics and no preset outputs.  ptxas (-Xptxas -v, sm_90a): registers,
// shared memory and spills are printed by chip_smoke.py ([ptxas] line)
// and recorded in PERF.md.
#include "search.cuh"

#define WARPS 4

__global__ void __launch_bounds__(WARPS * 32)
tablet_scan_kernel(const uint32_t* __restrict__ patt,  // (W, B)
                   const int32_t* __restrict__ plen,   // (B,)
                   const uint32_t* __restrict__ win,   // (W, R)
                   const int32_t* __restrict__ pos,    // (R,)
                   long long n_real, int B, int W, int R,
                   int32_t* __restrict__ count,        // (B,)
                   int32_t* __restrict__ less,
                   int32_t* __restrict__ first) {
  extern __shared__ uint32_t s_patt[];  // (WARPS, W)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= B) return;  // uniform per warp; no block barrier follows
  uint32_t* p = s_patt + warp * W;
  stage_pattern(p, patt + q, B, W);
  const int L = plen[q];
  int lb, ub;
  warp_kary_bounds(R, [&](int row, bool upper) {
    bool lt, eq;
    compare([=](int w) { return win[(long long)w * R + row]; }, p, W, L,
            (long long)pos[row], n_real, lt, eq);
    return upper ? (lt || eq) : lt;
  }, lb, ub);
  if (lane == 0) {
    count[q] = ub - lb;
    less[q] = lb;
    first[q] = ub > lb ? lb : BIG;
  }
}

extern "C" int tablet_scan_launch(const uint32_t* patt, const int32_t* plen,
                                  const uint32_t* win, const int32_t* pos,
                                  long long n_real, int B, int W, int R,
                                  int32_t* count, int32_t* less,
                                  int32_t* first, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (W < 0 || W > MAX_PATTERN_WORDS) return (int)cudaErrorInvalidValue;
  tablet_scan_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32,
                       (size_t)WARPS * W * sizeof(uint32_t), stream>>>(
      patt, plen, win, pos, n_real, B, W, R, count, less, first);
  return (int)cudaGetLastError();
}
