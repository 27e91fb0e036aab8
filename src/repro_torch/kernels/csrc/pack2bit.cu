// 2-bit DNA pack for Hopper: codes {0..3} (uint8, one per base) ->
// big-endian uint32 words, base s of word w at bit 30 - 2s.
//
// Replaces the TPU kernel repro/kernels/pack2bit.py::pack2bit_pallas.
// Bound: bytes.  Each word reads 16 input bytes and writes 4, so the
// least time is (n + n/4) bytes over the memory rate.  Design: one
// thread per output word; a full word's 16 codes are one aligned
// 16-byte load (the input base is 256-byte aligned and word w starts at
// byte 16w), the ragged last word reads byte by byte with a bound check
// (missing slots are 0, i.e. 'A', as in codec.pack_2bit).
#include <cstdint>
#include <cuda_runtime.h>

__global__ void pack2bit_kernel(const uint8_t* __restrict__ codes,
                                long long n, uint32_t* __restrict__ out,
                                long long n_words) {
  long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n_words) return;
  long long base = w * 16;
  uint32_t word = 0;
  if (base + 16 <= n) {
    uint4 v = *reinterpret_cast<const uint4*>(codes + base);
    uint32_t part[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int s = q * 4 + b;  // little-endian bytes: byte b is base 4q+b
        uint32_t c = (part[q] >> (8 * b)) & 0xFFu;
        word |= c << (30 - 2 * s);
      }
    }
  } else {
    for (int s = 0; s < 16; ++s) {
      long long i = base + s;
      uint32_t c = i < n ? (uint32_t)codes[i] : 0u;
      word |= c << (30 - 2 * s);
    }
  }
  out[w] = word;
}

extern "C" int pack2bit_launch(const uint8_t* codes, long long n,
                               uint32_t* out, long long n_words,
                               cudaStream_t stream) {
  if (n_words <= 0) return 0;
  const int threads = 256;
  long long blocks = (n_words + threads - 1) / threads;
  pack2bit_kernel<<<(unsigned)blocks, threads, 0, stream>>>(codes, n, out,
                                                           n_words);
  return (int)cudaGetLastError();
}
