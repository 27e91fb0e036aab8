// Dense tablet range scan for Hopper: every pattern against a block of
// consecutive sorted suffix rows.
//
// Replaces the TPU kernel repro/kernels/tablet_scan.py::
// tablet_scan_pallas.
//
// Per query q, over the R rows of the windows:
//   eq    = window prefix-equals the pattern to depth plen and the suffix
//           is not shorter than the pattern (pos + plen <= n_real)
//   lt    = window < pattern, or prefix-equal but truncated
//   count = #eq, less = #lt (the lower bound over sorted rows),
//   first_row = min r with eq (2**30 when none)
//
// Bound: bytes for the main path's single batch (every window read once:
// 4 W bytes per row), operations as the batch grows (B x R
// compares of up to W words).  Design: tier_scan.cu's layout without the
// tier axis.  Grid (row tile, query tile); a block stages its RT rows'
// windows and positions and its QT patterns in shared memory, each thread
// owns one query and walks the tile's rows (every thread reads the same
// row at once: a shared-memory broadcast), stopping each compare at the
// first differing word.  Row tiles run in no order, so each thread adds
// its tile's partial sums to the outputs with atomicAdd and its first
// match with atomicMin, into outputs the wrapper presets to 0 / 2**30.
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

__global__ void tablet_scan_kernel(const uint32_t* __restrict__ patt,  // (W, B)
                                   const int32_t* __restrict__ plen,   // (B,)
                                   const uint32_t* __restrict__ win,   // (W, R)
                                   const int32_t* __restrict__ pos,    // (R,)
                                   long long n_real, int B, int W, int R,
                                   int RT,
                                   int32_t* __restrict__ count,        // (B,)
                                   int32_t* __restrict__ less,
                                   int32_t* __restrict__ first) {
  extern __shared__ uint32_t smem[];
  const int QT = blockDim.x;
  const int row0 = blockIdx.x * RT;
  const int q = blockIdx.y * QT + threadIdx.x;
  const int nr = min(RT, R - row0);  // the last tile may be ragged

  uint32_t* s_win = smem;                                      // (W, RT)
  int32_t* s_pos = reinterpret_cast<int32_t*>(s_win + W * RT);  // (RT,)
  uint32_t* s_patt = reinterpret_cast<uint32_t*>(s_pos + RT);   // (W, QT)
  for (int i = threadIdx.x; i < W * nr; i += QT) {
    int w = i / nr, r = i - w * nr;
    s_win[w * RT + r] = win[(long long)w * R + row0 + r];
  }
  for (int r = threadIdx.x; r < nr; r += QT) s_pos[r] = pos[row0 + r];
  if (q < B)
    for (int w = 0; w < W; ++w)
      s_patt[w * QT + threadIdx.x] = patt[(long long)w * B + q];
  __syncthreads();
  if (q >= B) return;

  const int L = plen[q];
  int nw = (L + 15) / 16;
  nw = nw < W ? nw : W;
  int c_eq = 0, c_lt = 0, f = BIG;
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
    bool truncated = (long long)s_pos[r] + L > n_real;
    bool eq = pe && !truncated;
    c_lt += lt || (pe && truncated);
    if (eq) {
      ++c_eq;
      f = min(f, row0 + r);
    }
  }
  if (c_eq) atomicAdd(&count[q], c_eq);
  if (c_lt) atomicAdd(&less[q], c_lt);
  if (f < BIG) atomicMin(&first[q], f);
}

extern "C" int tablet_scan_launch(const uint32_t* patt, const int32_t* plen,
                                  const uint32_t* win, const int32_t* pos,
                                  long long n_real, int B, int W, int R,
                                  int32_t* count, int32_t* less,
                                  int32_t* first, cudaStream_t stream) {
  if (B <= 0 || R <= 0) return 0;
  const int QT = 128, RT = 256;
  size_t smem = ((size_t)W * RT + RT + (size_t)W * QT) * 4;
  dim3 grid((R + RT - 1) / RT, (B + QT - 1) / QT);
  tablet_scan_kernel<<<grid, QT, smem, stream>>>(patt, plen, win, pos, n_real,
                                                 B, W, R, RT, count, less,
                                                 first);
  return (int)cudaGetLastError();
}
