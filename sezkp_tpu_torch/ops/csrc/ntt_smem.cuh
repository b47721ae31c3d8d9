// Shared-memory radix-2 NTT over Goldilocks: the butterfly code and the tile
// sizing of the small-n kernels (ntt_small.cu: K5, K6). It was the first
// design of K2-K4 too, which now run the register passes of ntt_reg.cuh.
#pragma once
#include <stddef.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace ntt_smem {

constexpr int kThreads = 256;
// u64 elements of one shared-memory tile (32 KB), so a tile plus its twiddle
// row and padding stays under the 48 KB static limit for every m <= 2^10.
constexpr int kTileElems = 4096;

// bits == 0 (a transform of length 1) has the one index 0.
__device__ __forceinline__ int bitrev(int j, int bits) {
  return bits ? (int)(__brev((unsigned)j) >> (32 - bits)) : 0;
}

// In-place radix-2 decimation-in-time NTT of `nvec` vectors of length
// m = 2^m_log2 held in shared memory, element (j, v) at s[j * sj + v * sv].
// The vectors must have been stored at bit-reversed j; the result is in
// natural order. wp[k] = w_m^k for k < m/2. VEC_FAST picks which index runs
// fastest across threads (the one with stride 1 in shared memory).
// m_log2 == 0 is the identity (no stage runs).
template <bool VEC_FAST>
__device__ void smem_ntt(uint64_t* s, const uint64_t* wp, int m_log2, int nvec, int sj, int sv) {
  const int half_m = (1 << m_log2) >> 1;
  const int total = half_m * nvec;
  for (int st = 1; st <= m_log2; ++st) {
    const int half = 1 << (st - 1);
    const int tshift = m_log2 - st;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      int v, b;
      if (VEC_FAST) {
        v = idx % nvec;
        b = idx / nvec;
      } else {
        b = idx % half_m;
        v = idx / half_m;
      }
      const int pos = b & (half - 1);
      const int i0 = ((b >> (st - 1)) << st) + pos;
      uint64_t* p0 = s + i0 * sj + v * sv;
      uint64_t* p1 = p0 + half * sj;
      const uint64_t u = *p0;
      const uint64_t t = gl::mul(*p1, wp[pos << tshift]);
      *p0 = gl::add(u, t);
      *p1 = gl::sub(u, t);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void load_wp(uint64_t* wp, const uint64_t* wp_g, int m_log2) {
  const int half_m = (1 << m_log2) >> 1;
  for (int i = threadIdx.x; i < half_m; i += blockDim.x) wp[i] = wp_g[i];
}

// Vectors of length m per block: as many as fill one tile, at most `limit`.
inline int pick_nvec(int m, long long limit) {
  long long nv = kTileElems / m;
  if (nv < 1) nv = 1;
  if (nv > 128) nv = 128;  // bounds the padded tile for very small m
  if (nv > limit) nv = limit;
  return (int)nv;
}

inline size_t smem_bytes(int m, int nvec, bool padded) {
  return sizeof(uint64_t) * ((size_t)(m >> 1) + (size_t)nvec * (m + (padded ? 1 : 0)));
}

}  // namespace ntt_smem
