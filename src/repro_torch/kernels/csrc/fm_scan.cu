// FM-index backward search for Hopper over a 2-bit packed BWT.
//
// Replaces the TPU kernel repro/kernels/fm_scan.py::fm_scan_pallas.
//
// Inputs: patt (B, W) uint32 packed patterns (base s of a word at bit
// 30 - 2s) and plen (B,) int32; bwt (4 * nblk,) uint32 packed BWT over
// T$ (the sentinel row holding dummy symbol 0), read as nblk 16-byte
// blocks; occ (nblk + 1, 4) int32 exclusive checkpoint counts every SB =
// 64 rows; meta (8,) int32 [C0..C3, sent_row, rows, 0, 0].  Output: (lo,
// hi) int32 rows of SA$ per query; the pattern occupies rows [lo, hi).
//
// The schedule is the TPU kernel's plan, fm_scan.syms_from_packed(patt,
// plen, 16 W), taken from the packed words in the kernel: step t < 16 W
// takes the symbol at position min(plen - 1 - t, 16 W - 1) and is
// inactive when plen - 1 - t < 0, so a query runs min(plen, 16 W) steps.
// Per step with symbol c:
//   lo = C[c] + rank(c, lo),  hi = C[c] + rank(c, hi)
//   rank(c, i) = occ[i / 64][c] + #{slots < i % 64 of block i / 64
//                equal to c}  - (c == 0 && sent_row < i)
// The in-block count is a popcount: x = word ^ (c * 0x55555555) is 00 in
// every matching slot, so ~x & (~x >> 1) & 0x55555555 has one bit per
// match, and 0x55555555 << 2 * (16 - v) keeps the first v slots (v in
// 1..16, so the shift stays below 32).  When rows is a multiple of 64,
// rank(c, rows) reaches block nblk, which has no word; its block index
// is clamped to nblk - 1, where no slot is in range (i % 64 == 0).  A
// run that empties keeps stepping: lo is the pattern's lower-bound rank
// and must equal the TPU kernel's, found or not.
//
// Bound: latency.  Step t + 1 needs step t's (lo, hi), so a query is a
// chain of up to 16 W dependent memory round trips; the bytes and
// operations are small (per rank one Occ entry and one 16-byte block,
// ~40 operations).  Design, one round trip per step:
// - the pattern's words are staged once per block in shared memory
//   (s_patt[w][thread], conflict-free), and the next step's symbol is
//   taken from them by shift and mask while this step's loads are in
//   flight: no load of the schedule sits in the chain;
// - both ranks' addresses are formed first, then all four loads issue
//   (two checkpoints, two blocks of 4 BWT words, each one 16-byte
//   vector load) before any is consumed; the hi loads are predicated
//   off once lo == hi (hi follows lo);
// - one warp of 32 queries per block, so a 512-query batch is 16
//   blocks on 16 of the 132 SMs: each SM has one warp to issue and
//   every thread runs only its active steps.
// At 2**26 rows the BWT (16 MB) and the checkpoints (16 MB) stay in the
// 50 MB L2 across batches.  ptxas (-Xptxas -v, sm_90a): registers,
// shared memory and spills are printed by chip_smoke.py ([ptxas] line)
// and recorded in PERF.md.
#include <cstdint>
#include <cuda_runtime.h>

#define SB 64
#define EVEN 0x55555555u
#define THREADS 32       // queries per block
#define MAX_WORDS 16     // pattern words staged per query

// Issue the loads of rank(c, i): the checkpoint and the row's block.
__device__ __forceinline__ void rank_load(const uint4* __restrict__ bwt4,
                                          int nblk,
                                          const int32_t* __restrict__ occ,
                                          int c, int i, int& base,
                                          uint4& block) {
  const int blk = i / SB;
  base = __ldg(occ + blk * 4 + c);
  block = __ldg(bwt4 + (blk < nblk ? blk : nblk - 1));
}

// Finish rank(c, i) from its loads.
__device__ __forceinline__ int rank_finish(int base, uint4 block, int c,
                                           int i, int sent_row) {
  const uint32_t pat = (uint32_t)c * EVEN;
  const uint32_t words[4] = {block.x, block.y, block.z, block.w};
  const int rem = i % SB;
  int cnt = base;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int v = rem - 16 * j;               // slots of word j below i
    v = v < 0 ? 0 : (v > 16 ? 16 : v);
    const uint32_t nx = ~(words[j] ^ pat);
    const uint32_t y = nx & (nx >> 1) & EVEN;
    const uint32_t keep = v > 0 ? EVEN << (2 * (16 - v)) : 0u;
    cnt += __popc(y & keep);
  }
  return cnt - ((c == 0 && sent_row < i) ? 1 : 0);
}

__global__ void __launch_bounds__(THREADS)
fm_scan_kernel(const uint32_t* __restrict__ patt,  // (B, W)
               const int32_t* __restrict__ plen,   // (B,)
               const uint4* __restrict__ bwt4,     // (nblk,) blocks
               int nblk,
               const int32_t* __restrict__ occ,    // (nblk + 1, 4)
               const int32_t* __restrict__ meta,   // (8,)
               int B, int W,
               int32_t* __restrict__ lo_out,
               int32_t* __restrict__ hi_out) {
  __shared__ uint32_t s_patt[MAX_WORDS][THREADS];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * THREADS;
  const int nq = B - q0 < THREADS ? B - q0 : THREADS;
  // the block's nq x W words are contiguous: read them coalesced
  for (int k = tid; k < nq * W; k += THREADS)
    s_patt[k % W][k / W] = patt[(long long)q0 * W + k];
  __syncwarp();  // the block is one warp; no barrier follows
  const int q = q0 + tid;
  if (q >= B) return;
  const int cc0 = meta[0], cc1 = meta[1], cc2 = meta[2], cc3 = meta[3];
  const int sent_row = meta[4];
  const int L = plen[q];
  const int last = 16 * W - 1;
  const int steps = L < 16 * W ? L : 16 * W;   // active steps
  auto sym = [&](int t) {
    int p = L - 1 - t;
    p = p < last ? p : last;
    return (int)((s_patt[p >> 4][tid] >> (30 - 2 * (p & 15))) & 3u);
  };
  int lo = 0, hi = meta[5];
  int c = steps > 0 ? sym(0) : 0;
  for (int t = 0; t < steps; ++t) {
    int base_lo, base_hi = 0;
    uint4 blk_lo, blk_hi = make_uint4(0u, 0u, 0u, 0u);
    const bool two = hi != lo;
    rank_load(bwt4, nblk, occ, c, lo, base_lo, blk_lo);
    if (two) rank_load(bwt4, nblk, occ, c, hi, base_hi, blk_hi);
    const int c_next = t + 1 < steps ? sym(t + 1) : 0;
    const int cb = c == 0 ? cc0 : c == 1 ? cc1 : c == 2 ? cc2 : cc3;
    const int lo2 = cb + rank_finish(base_lo, blk_lo, c, lo, sent_row);
    hi = two ? cb + rank_finish(base_hi, blk_hi, c, hi, sent_row) : lo2;
    lo = lo2;
    c = c_next;
  }
  lo_out[q] = lo;
  hi_out[q] = hi;
}

extern "C" int fm_scan_launch(const uint32_t* patt, const int32_t* plen,
                              const uint32_t* bwt, int nblk,
                              const int32_t* occ, const int32_t* meta, int B,
                              int W, int32_t* lo, int32_t* hi,
                              cudaStream_t stream) {
  if (B <= 0) return 0;
  fm_scan_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      patt, plen, reinterpret_cast<const uint4*>(bwt), nblk, occ, meta, B,
      W, lo, hi);
  return (int)cudaGetLastError();
}
