// Dense multi-tier scan for Hopper: every pattern against every sorted
// row of every delta tier (sealed runs + memtable), with the straddle
// rule applied in the same pass.
//
// Replaces the TPU kernel repro/kernels/tier_scan.py::tier_scan_pallas.
//
// Per tier t (meta row [n_real, n_rows, offset, lo, hi, 0, 0, 0]) and
// query q, over rows r < n_rows:
//   eq     = window prefix-equals the pattern to depth plen and the
//            suffix is not shorter than the pattern (sa + plen <= n_real)
//   lt     = window < pattern, or prefix-equal but truncated
//   g      = sa + offset (global start), e = g + plen
//   owned  = eq && lo < e <= hi                  (the straddle rule)
//   count  = #owned, less = #lt, matches = #eq, first_g = min owned g
// first_g is 2**30 when the tier owns no match.
//
// Bound: operations.  The work is T * B * n_rows compares of up to W
// words each; bytes are small (the windows are read once per query
// tile).  Design: grid (row tile, query tile, tier).  A block stages its
// RT rows' windows and sa and its QT patterns in shared memory, each
// thread owns one query and walks the tile's rows (every thread reads
// the same row at once: a shared-memory broadcast), stopping each
// compare at the first differing word.  The TPU kernel carried its sums
// across the sequential row axis of its grid; here blocks run in no
// order, so each thread adds its tile's partial sums to the outputs
// with atomics (atomicMin for first_g).  Outputs are pre-set by the
// wrapper to 0 / 2**30.
#include <cstdint>
#include <cuda_runtime.h>

#define BIG (1 << 30)

__device__ __forceinline__ uint32_t word_mask(int plen, int w) {
  int r = plen - w * 16;
  r = r < 0 ? 0 : (r > 16 ? 16 : r);
  if (r == 0) return 0u;
  if (r == 16) return 0xFFFFFFFFu;
  return ~((1u << (32 - 2 * r)) - 1u);
}

__global__ void tier_scan_kernel(const uint32_t* __restrict__ patt,   // (W, B)
                                 const int32_t* __restrict__ plen,    // (B,)
                                 const uint32_t* __restrict__ win,    // (T, W, R)
                                 const int32_t* __restrict__ sa,      // (T, R)
                                 const int32_t* __restrict__ meta,    // (T, 8)
                                 int B, int W, int R, int RT,
                                 int32_t* __restrict__ count,         // (T, B)
                                 int32_t* __restrict__ less,
                                 int32_t* __restrict__ matches,
                                 int32_t* __restrict__ first) {
  extern __shared__ uint32_t smem[];
  const int QT = blockDim.x;
  const int t = blockIdx.z;
  const int row0 = blockIdx.x * RT;
  const int q = blockIdx.y * QT + threadIdx.x;
  const int32_t* m = meta + 8 * t;
  const long long n_real = m[0];
  const int n_rows = m[1] < R ? m[1] : R;  // rows past R do not exist
  const long long offset = m[2], lo_b = m[3], hi_b = m[4];
  if (row0 >= n_rows) return;  // uniform: the block scans only stack padding
  const int nr = min(RT, n_rows - row0);

  uint32_t* s_win = smem;                               // (W, RT)
  int32_t* s_sa = reinterpret_cast<int32_t*>(s_win + W * RT);  // (RT,)
  uint32_t* s_patt = reinterpret_cast<uint32_t*>(s_sa + RT);  // (W, QT)
  const uint32_t* win_t = win + (long long)t * W * R;
  for (int i = threadIdx.x; i < W * nr; i += QT) {
    int w = i / nr, r = i - w * nr;
    s_win[w * RT + r] = win_t[(long long)w * R + row0 + r];
  }
  for (int r = threadIdx.x; r < nr; r += QT)
    s_sa[r] = sa[(long long)t * R + row0 + r];
  if (q < B)
    for (int w = 0; w < W; ++w)
      s_patt[w * QT + threadIdx.x] = patt[(long long)w * B + q];
  __syncthreads();
  if (q >= B) return;

  const int L = plen[q];
  int nw = (L + 15) / 16;
  nw = nw < W ? nw : W;
  int c_own = 0, c_lt = 0, c_eq = 0;
  long long f = BIG;
  for (int r = 0; r < nr; ++r) {
    bool pe = true, lt = false;
    for (int w = 0; w < nw; ++w) {
      uint32_t mk = word_mask(L, w);
      uint32_t a = s_win[w * RT + r] & mk;
      uint32_t b = s_patt[w * QT + threadIdx.x] & mk;
      if (a != b) {
        lt = a < b;
        pe = false;
        break;
      }
    }
    long long pos = s_sa[r];
    bool truncated = pos + L > n_real;
    bool eq = pe && !truncated;
    lt = lt || (pe && truncated);
    c_lt += lt;
    c_eq += eq;
    if (eq) {
      long long g = pos + offset;
      long long e = g + L;
      if (e > lo_b && e <= hi_b) {
        ++c_own;
        f = g < f ? g : f;
      }
    }
  }
  long long o = (long long)t * B + q;
  if (c_own) atomicAdd(&count[o], c_own);
  if (c_lt) atomicAdd(&less[o], c_lt);
  if (c_eq) atomicAdd(&matches[o], c_eq);
  if (f < BIG) atomicMin(&first[o], (int)f);
}

extern "C" int tier_scan_launch(const uint32_t* patt, const int32_t* plen,
                                const uint32_t* win, const int32_t* sa,
                                const int32_t* meta, int T, int B, int W,
                                int R, int32_t* count, int32_t* less,
                                int32_t* matches, int32_t* first,
                                cudaStream_t stream) {
  if (T <= 0 || B <= 0 || R <= 0) return 0;
  const int QT = 128, RT = 256;
  size_t smem = ((size_t)W * RT + RT + (size_t)W * QT) * 4;
  dim3 grid((R + RT - 1) / RT, (B + QT - 1) / QT, T);
  tier_scan_kernel<<<grid, QT, smem, stream>>>(patt, plen, win, sa, meta, B,
                                               W, R, RT, count, less,
                                               matches, first);
  return (int)cudaGetLastError();
}
