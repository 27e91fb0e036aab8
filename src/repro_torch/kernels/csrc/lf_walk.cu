// LF walks of FM-index rows back to text positions for Hopper, over a
// 2-bit packed BWT.
//
// Replaces no TPU kernel: src/repro/kernels/fm_scan.py:195 walks with a
// jnp loop.  Added because the plain walk (fm_scan.lf_walk, this kernel's
// twin and the CPU path) runs up to sample_rate + 1 eager steps a call,
// each a host sync and some 30 small launches, whatever the row count.
//
// Inputs: bwt (4 * nblk,) uint32 packed BWT over T$ (the sentinel row
// holding dummy symbol 0), read as nblk 16-byte blocks; occ (nblk + 1, 4)
// int32 exclusive checkpoint counts every SB = 64 rows, read as one
// 16-byte row; marked (Wm,) uint32 bitvector of the rows whose SA$ value
// is a multiple of sample_rate, marked_rank (Wm,) int32 its set bits
// before each word, samples (S,) int32 the marked rows' SA$ values in
// row order; meta (8,) int32 [C0..C3, sent_row, rows, 0, 0]
// (fm_scan.fm_meta).  Per row r and step k = 0, 1, ..., sample_rate:
//   if r is marked: SA$[row] = samples[marked_rank[r / 32]
//                              + popcount(marked[r / 32] below bit r % 32)] + k
//   else (k < sample_rate): c = BWT[r], r = C[c] + rank(c, r)
// exactly fm_scan.lf_walk's result: a walk that finds no marked row
// within sample_rate steps (only on a corrupt index) reports -1, and so
// does a row outside [0, rows), where the plain walk would index out of
// range.  rank(c, r) is fm_scan.cu's rank_finish (copied below; that
// source is not shared so its kernel stays as it is measured).  A walk
// never steps from the sentinel row: its SA$ value 0 is marked.
//
// Two entry points: lf_walk_rows_launch writes pos[k] = SA$[rows[k]];
// lf_walk_min_launch takes segments of rows as bounds (2, S) int64 (row 0
// the first SA$ row of each segment, row 1 the exclusive prefix sums of
// their lengths, so segment s owns flat indices [ends[s - 1], ends[s])),
// one thread per flat index, a binary search over the ends for its
// segment, and reduces into out[s] (filled with INT64_MAX by the
// wrapper): lanes of a warp in one segment take their minimum with
// __reduce_min_sync, and one lane issues a 64-bit atomicMin.  The
// order of the atomics cannot change a minimum, so the result is exact.
//
// Bound: latency.  A walk is a chain of up to sample_rate dependent
// round trips into an index that, at chr1 scale (218 MB), is four times
// the 50 MB L2.  The bytes are few: at the frozen bulk cell's shape
// (~1,270 rows a batch in ~6 segments, ~16 steps a row, three 32-byte
// sectors a step) about 2 MB, 0.6 us at 3.35 TB/s, against about
// 32 x 0.7 us = 25 us of chained DRAM round trips.  Design, one round
// trip per step: every address of a step depends only on r, so the
// marked word (r / 32), the BWT block (r / 64, one uint4) and the Occ
// row (r / 64, all four counts as one int4) are loaded together before
// any is consumed; the mark test, the symbol and the rank are then
// register arithmetic.  marked_rank and samples are read once, at the
// marked row.  Blocks of 64 threads spread a small batch over the SMs
// and still fill an SM (32 blocks) on a large one; a grid-stride loop
// takes any row count.  ptxas (-Xptxas -v, sm_90a): registers, shared
// memory and spills are printed by chip_smoke.py ([ptxas] line) and
// recorded in PERF.md.
#include <cstdint>
#include <cuda_runtime.h>

#define SB 64
#define EVEN 0x55555555u
#define THREADS 64       // rows per block
#define MAX_BLOCKS 65536 // grid cap; the grid-stride loop takes the rest

struct Index {
  const uint4* __restrict__ bwt4;       // (nblk,) blocks of 4 words
  const int4* __restrict__ occ4;        // (nblk + 1,) rows of 4 counts
  const uint32_t* __restrict__ marked;  // (Wm,)
  const int32_t* __restrict__ marked_rank;
  const int32_t* __restrict__ samples;
  int rows;
  int sample_rate;
};

// rank(c, i) from its checkpoint and block: fm_scan.cu's rank_finish.
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

// The C$ array and the sentinel row, from meta.
struct Consts {
  int c0, c1, c2, c3, sent_row;
  __device__ explicit Consts(const int32_t* __restrict__ meta)
      : c0(__ldg(meta)), c1(__ldg(meta + 1)), c2(__ldg(meta + 2)),
        c3(__ldg(meta + 3)), sent_row(__ldg(meta + 4)) {}
  __device__ int cc(int c) const {
    return c == 0 ? c0 : c == 1 ? c1 : c == 2 ? c2 : c3;
  }
};

// SA$[row] by an LF walk to the nearest marked row; -1 as documented
// above.
__device__ __forceinline__ long long walk(const Index& ix, const Consts& m,
                                          long long row) {
  if (row < 0 || row >= ix.rows) return -1;
  int r = (int)row;
  for (int k = 0;; ++k) {
    // the step's three loads, issued before any is consumed
    const uint32_t mw = __ldg(ix.marked + (r >> 5));
    const uint4 blk = __ldg(ix.bwt4 + (r >> 6));
    const int4 oc = __ldg(ix.occ4 + (r >> 6));
    const int bit = r & 31;
    if ((mw >> bit) & 1u) {
      const int idx = __ldg(ix.marked_rank + (r >> 5)) +
                      __popc(mw & ((1u << bit) - 1u));
      return (long long)__ldg(ix.samples + idx) + k;
    }
    if (k == ix.sample_rate) return -1;
    const int slot = r & 63;
    const uint32_t w = slot < 16 ? blk.x : slot < 32 ? blk.y
                     : slot < 48 ? blk.z : blk.w;
    const int c = (int)((w >> (30 - 2 * (slot & 15))) & 3u);
    const int base = c == 0 ? oc.x : c == 1 ? oc.y : c == 2 ? oc.z : oc.w;
    r = m.cc(c) + rank_finish(base, blk, c, r, m.sent_row);
  }
}

__global__ void __launch_bounds__(THREADS)
lf_walk_rows_kernel(Index ix, const int32_t* __restrict__ meta,
                    const long long* __restrict__ rows, long long n,
                    long long* __restrict__ pos) {
  const Consts m(meta);
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long k = (long long)blockIdx.x * THREADS + threadIdx.x; k < n;
       k += stride)
    pos[k] = walk(ix, m, __ldg(rows + k));
}

__global__ void __launch_bounds__(THREADS)
lf_walk_min_kernel(Index ix, const int32_t* __restrict__ meta,
                   const long long* __restrict__ bounds, int S,
                   long long total, long long* __restrict__ out) {
  const Consts m(meta);
  const long long* __restrict__ starts = bounds;
  const long long* __restrict__ ends = bounds + S;
  const long long last = __ldg(ends + S - 1);  // total, as the bounds say
  const long long stride = (long long)gridDim.x * THREADS;
  // the loop bound is the same for every lane of a warp, so all 32
  // lanes reach the warp-wide match and reduction together
  for (long long k0 = (long long)blockIdx.x * THREADS; k0 < total;
       k0 += stride) {
    const long long k = k0 + threadIdx.x;
    int seg = -1;
    int pos = 0;
    if (k < last) {
      int lo = 0, hi = S;               // first segment whose end > k
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(ends + mid) <= k) lo = mid + 1; else hi = mid;
      }
      seg = lo;
      const long long first = seg ? __ldg(ends + seg - 1) : 0;
      // positions are below rows <= 2**31 - 1 (int32 samples), or -1
      pos = (int)walk(ix, m, __ldg(starts + seg) + (k - first));
    }
    const unsigned group = __match_any_sync(0xFFFFFFFFu, seg);
    const int least = __reduce_min_sync(group, pos);
    if (seg >= 0 && (int)(threadIdx.x & 31) == __ffs(group) - 1)
      atomicMin(out + seg, (long long)least);
  }
}

static int grid_for(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  return (int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

static Index make_index(const uint32_t* bwt, const int32_t* occ,
                        const uint32_t* marked, const int32_t* marked_rank,
                        const int32_t* samples, int rows, int sample_rate) {
  return Index{reinterpret_cast<const uint4*>(bwt),
               reinterpret_cast<const int4*>(occ), marked, marked_rank,
               samples, rows, sample_rate};
}

extern "C" int lf_walk_rows_launch(const uint32_t* bwt, const int32_t* occ,
                                   const uint32_t* marked,
                                   const int32_t* marked_rank,
                                   const int32_t* samples,
                                   const int32_t* meta, int rows,
                                   int sample_rate, const long long* row_ids,
                                   long long n, long long* pos,
                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  lf_walk_rows_kernel<<<grid_for(n), THREADS, 0, stream>>>(
      make_index(bwt, occ, marked, marked_rank, samples, rows, sample_rate),
      meta, row_ids, n, pos);
  return (int)cudaGetLastError();
}

extern "C" int lf_walk_min_launch(const uint32_t* bwt, const int32_t* occ,
                                  const uint32_t* marked,
                                  const int32_t* marked_rank,
                                  const int32_t* samples,
                                  const int32_t* meta, int rows,
                                  int sample_rate, const long long* bounds,
                                  int S, long long total, long long* out,
                                  cudaStream_t stream) {
  if (total <= 0 || S <= 0) return 0;
  lf_walk_min_kernel<<<grid_for(total), THREADS, 0, stream>>>(
      make_index(bwt, occ, marked, marked_rank, samples, rows, sample_rate),
      meta, bounds, S, total, out);
  return (int)cudaGetLastError();
}
