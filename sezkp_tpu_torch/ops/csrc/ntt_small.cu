// K5 ntt_small_cols, K6 ntt_small_rows: the two phases of the four-step
// Goldilocks NTT for n = n1 * n2 < 2^14.
//
// They replace the roll-based Pallas kernels of sezkp_tpu/ops/ntt_pallas.py
// (`phase_a_kernel` and `phase_b_kernel` in `_build`). Each computes what its
// counterpart computes, not the way it does. The TPU kernels need the rows
// permuted into bit-reversed order by a gather outside the kernel, one
// twiddle row per position and stage, and a roll-and-select exchange between
// butterfly partners, because their compiler has no gathers; and the n^-1 of
// the inverse and the transpose to natural order run outside as well. Here
// the bit reversal is the shared-memory store index, the butterflies address
// their partners directly, the twiddles come from one table w_m^k, and the
// scale and the transpose are part of K6's store.
//
// With a[j1 * n2 + j2] viewed as A[j1, j2]:
//   K5: B[k1, j2] = (sum_j1 A[j1, j2] w_n1^(j1 k1)) * T[k1, j2],
//       T[k1, j2] = w_n^(k1 j2)
//   K6: y[k1 + n1 * k2] = scale * sum_j2 B[k1, j2] w_n2^(j2 k2)
//
// Bound on an H100: a whole transform here is at most 2^13 elements (64 KB),
// 16 B moved per element and phase and log2(m)/2 butterflies per element,
// which the card could do in tens of nanoseconds; a launch takes
// microseconds, so launch latency, not bytes or operations, is what these
// kernels cost. The design is therefore the simplest that is right, with the
// butterfly code of K2-K4's first design (ntt_smem.cuh) and tiles inside the 48 KB default shared
// memory. What a launch does cost on the device is the serial chain of
// stages inside a block, so a block takes a small tile (512 elements where
// the transform length allows: one butterfly per thread and stage) and the
// transform spreads over up to 16 blocks instead of two.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ntt_smem.cuh"

using namespace ntt_smem;

namespace {

// u64 elements of one block's tile: two per thread.
constexpr int kSmallTileElems = 2 * kThreads;

// Vectors of length m per block: as many as fill the small tile, at most `limit`.
inline int small_nvec(int m, int limit) {
  int nv = kSmallTileElems / m;
  if (nv < 1) nv = 1;
  return nv < limit ? nv : limit;
}

// ---- K5: x [n1, n2] -> y [n1, n2]: DFT of length n1 down every column,
// then y[k1, j2] *= tw[k1, j2]. One block takes nvec neighbouring columns.
__global__ void __launch_bounds__(kThreads)
ntt_small_cols_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, int n1_log2,
                      int n2, int nvec, const uint64_t* __restrict__ wp_g,
                      const uint64_t* __restrict__ tw) {
  extern __shared__ uint64_t smem[];
  const int n1 = 1 << n1_log2;
  uint64_t* wp = smem;
  uint64_t* s = smem + (n1 >> 1);
  load_wp(wp, wp_g, n1_log2);
  const int c0 = blockIdx.x * nvec;
  const int total = n1 * nvec;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int v = idx % nvec, j = idx / nvec;
    s[bitrev(j, n1_log2) * nvec + v] = x[j * n2 + c0 + v];
  }
  __syncthreads();
  smem_ntt<true>(s, wp, n1_log2, nvec, nvec, 1);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int v = idx % nvec, k = idx / nvec;
    const int off = k * n2 + c0 + v;
    y[off] = gl::mul(s[k * nvec + v], tw[off]);
  }
}

// ---- K6: x [n1, n2] -> y [n2, n1]: DFT of length n2 along every row, times
// scale, stored transposed so that the flat output is in natural order. One
// block takes nvec neighbouring rows; loads run along a row, stores along k1
// (odd row stride in shared memory, so neither side has bank conflicts).
__global__ void __launch_bounds__(kThreads)
ntt_small_rows_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, int n1,
                      int n2_log2, int nvec, const uint64_t* __restrict__ wp_g, uint64_t scale) {
  extern __shared__ uint64_t smem[];
  const int n2 = 1 << n2_log2;
  uint64_t* wp = smem;
  uint64_t* s = smem + (n2 >> 1);
  load_wp(wp, wp_g, n2_log2);
  const int r0 = blockIdx.x * nvec;
  const int sv = n2 + 1;
  const int total = n2 * nvec;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int j = idx % n2, v = idx / n2;
    s[v * sv + bitrev(j, n2_log2)] = x[(r0 + v) * n2 + j];
  }
  __syncthreads();
  smem_ntt<false>(s, wp, n2_log2, nvec, 1, sv);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int v = idx % nvec, k2 = idx / nvec;
    uint64_t val = s[v * sv + k2];
    if (scale != 1) val = gl::mul(val, scale);
    y[k2 * n1 + r0 + v] = val;
  }
}

}  // namespace

// n1 = 2^n1_log2 and n2 = 2^n2_log2 with 0 <= log2 <= 10 each (a factor of 1
// is the identity transform). Each function returns the launch's cudaError_t
// (0 = launched), or cudaErrorInvalidValue for sizes it does not take.

extern "C" int sezkp_ntt_small_cols(const void* x, void* y, int n1_log2, int n2_log2,
                                    const void* wp, const void* tw, void* stream) {
  if (n1_log2 < 0 || n1_log2 > 10 || n2_log2 < 0 || n2_log2 > 10 || !tw) return (int)cudaErrorInvalidValue;
  const int n1 = 1 << n1_log2, n2 = 1 << n2_log2;
  const int nvec = small_nvec(n1, n2);
  ntt_small_cols_kernel<<<(unsigned)(n2 / nvec), kThreads, smem_bytes(n1, nvec, false),
                          (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)y, n1_log2, n2, nvec, (const uint64_t*)wp,
      (const uint64_t*)tw);
  return (int)cudaGetLastError();
}

extern "C" int sezkp_ntt_small_rows(const void* x, void* y, int n1_log2, int n2_log2,
                                    const void* wp, unsigned long long scale, void* stream) {
  if (n1_log2 < 0 || n1_log2 > 10 || n2_log2 < 0 || n2_log2 > 10) return (int)cudaErrorInvalidValue;
  const int n1 = 1 << n1_log2, n2 = 1 << n2_log2;
  const int nvec = small_nvec(n2, n1);
  ntt_small_rows_kernel<<<(unsigned)(n1 / nvec), kThreads, smem_bytes(n2, nvec, true),
                          (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)y, n1, n2_log2, nvec, (const uint64_t*)wp,
      (uint64_t)scale);
  return (int)cudaGetLastError();
}
