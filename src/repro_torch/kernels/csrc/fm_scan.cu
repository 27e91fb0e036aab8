// FM-index backward search for Hopper over a 2-bit packed BWT.
//
// Replaces the TPU kernel repro/kernels/fm_scan.py::fm_scan_pallas.
//
// Inputs: syms (steps, B) int32, the backward-order symbol plan (step t
// holds pattern position plen - 1 - t; -1 = inactive); bwt (Wb,) uint32
// packed BWT over T$ (base s of a word at bit 30 - 2s, the sentinel row
// holding dummy symbol 0); occ (nblk + 1, 4) int32 exclusive checkpoint
// counts every SB = 64 rows; meta (8,) int32 [C0..C3, sent_row, rows,
// 0, 0].  Output: (lo, hi) int32 rows of SA$ per query; the pattern
// occupies rows [lo, hi).
//
// Per active step with symbol c:
//   lo = C[c] + rank(c, lo),  hi = C[c] + rank(c, hi)
//   rank(c, i) = occ[i / 64][c] + #{slots < i % 64 of block i / 64
//                equal to c}  - (c == 0 && sent_row < i)
// The in-block count is a popcount: x = word ^ (c * 0x55555555) is 00 in
// every matching slot, so ~x & (~x >> 1) & 0x55555555 has one bit per
// match, and 0x55555555 << 2 * (16 - v) keeps the first v slots (v in
// 1..16, so the shift stays below 32).
//
// Bound: latency.  Each step is two dependent gathers (a checkpoint and
// up to 4 words), and the next step needs their result; the bytes and
// operations the search needs are small (2 ranks x sum(plen) x 20 B).
// Design: one thread per query, reading the BWT and the checkpoints
// straight from global memory (at 2**26 rows the two total ~32 MB, which
// stays in the 50 MB L2).  The two ranks of a step are independent, so
// their gathers overlap; once lo == hi the run is empty and only one
// rank is taken (hi follows lo).  When rows is a multiple of 64,
// rank(c, rows) reaches one block past the BWT; a word is read only for
// slots in range, and its index is clamped all the same.
#include <cstdint>
#include <cuda_runtime.h>

#define SB 64
#define WPB 4
#define EVEN 0x55555555u

__device__ __forceinline__ int rank_packed(const uint32_t* __restrict__ bwt,
                                           int n_words,
                                           const int32_t* __restrict__ occ,
                                           int sent_row, int c, int i) {
  const int blk = i / SB;
  const int rem = i - blk * SB;
  const uint32_t pat = (uint32_t)c * EVEN;
  int cnt = occ[blk * 4 + c];
#pragma unroll
  for (int j = 0; j < WPB; ++j) {
    int v = rem - 16 * j;
    if (v <= 0) break;                 // no slot of this word (or later)
    v = v > 16 ? 16 : v;
    int wi = blk * WPB + j;
    wi = wi < n_words ? wi : n_words - 1;
    const uint32_t nx = ~(__ldg(bwt + wi) ^ pat);
    const uint32_t y = nx & (nx >> 1) & EVEN;
    cnt += __popc(y & (EVEN << (2 * (16 - v))));
  }
  return cnt - ((c == 0 && sent_row < i) ? 1 : 0);
}

__global__ void fm_scan_kernel(const int32_t* __restrict__ syms,  // (steps, B)
                               const uint32_t* __restrict__ bwt,  // (Wb,)
                               int n_words,
                               const int32_t* __restrict__ occ,   // (nblk+1, 4)
                               const int32_t* __restrict__ meta,  // (8,)
                               int steps, int B,
                               int32_t* __restrict__ lo_out,
                               int32_t* __restrict__ hi_out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;
  const int cc[4] = {meta[0], meta[1], meta[2], meta[3]};
  const int sent_row = meta[4];
  int lo = 0, hi = meta[5];
  for (int t = 0; t < steps; ++t) {
    const int s = syms[(long long)t * B + q];
    if (s < 0) continue;
    const int c = s > 3 ? 3 : s;
    const int lo2 = cc[c] + rank_packed(bwt, n_words, occ, sent_row, c, lo);
    const int hi2 = hi == lo
                        ? lo2
                        : cc[c] + rank_packed(bwt, n_words, occ, sent_row, c,
                                              hi);
    lo = lo2;
    hi = hi2;
  }
  lo_out[q] = lo;
  hi_out[q] = hi;
}

extern "C" int fm_scan_launch(const int32_t* syms, const uint32_t* bwt,
                              int n_words, const int32_t* occ,
                              const int32_t* meta, int steps, int B,
                              int32_t* lo, int32_t* hi, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = 64;   // small blocks spread a 512-query batch over SMs
  fm_scan_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      syms, bwt, n_words, occ, meta, steps, B, lo, hi);
  return (int)cudaGetLastError();
}
