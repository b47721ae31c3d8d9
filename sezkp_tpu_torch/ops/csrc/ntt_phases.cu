// K2 ntt_phase_axis, K3 ntt_phase_batched, K4 ntt_phase_last: the phases of
// the multi-step Goldilocks NTT.
//
// They replace the three Pallas kernels of sezkp_tpu/ops/ntt_mxu.py
// (_dft_call/_dft_kernel, _batched_call/_batched_kernel, _last_call_t). Each
// computes what its counterpart computes -- an exact length-m DFT
// Y[k] = sum_j X[j] w_m^(jk) along one axis of a 2-D or 3-D view, with the
// inter-phase twiddle multiplies fused in -- but not the way it does: the
// int8 digit split, the digit-pair matmuls and the diagonal recombine answer
// a matrix unit without 64-bit integers. Here a thread block loads a tile of
// length-m vectors into shared memory as u64, runs log2(m) radix-2 butterfly
// stages there with __umul64hi-based modular multiplies, applies the
// twiddles and stores. Each element is read once and written once per phase
// (16 B) and takes log2(m)/2 butterflies of 56 integer instructions of field
// arithmetic each (counted in the sm_90a disassembly; the index arithmetic of
// the loop adds about 35 more); by those counts the integer rate is the
// nearer bound on an H100, the memory rate the second. The tile shapes below keep global
// loads and stores contiguous along the fastest axis.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ntt_smem.cuh"

using namespace ntt_smem;

namespace {

// ---- K2: DFT along axis 0 of [m, other] (axis == 0) or along axis 1 of
// [other, m] (axis == 1); then y *= tw (optional), y *= scale (if != 1).
// axis 0: tw is [m, other] (tw_period == 0) or [m, tw_period], repeating
// along the columns. axis 1: tw is [other, m] (full only).
__global__ void __launch_bounds__(kThreads)
ntt_phase_axis_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, int m_log2,
                      long long other, int axis, int nvec, const uint64_t* __restrict__ wp_g,
                      const uint64_t* __restrict__ tw, long long tw_period, uint64_t scale) {
  extern __shared__ uint64_t smem[];
  const int m = 1 << m_log2;
  uint64_t* wp = smem;
  uint64_t* s = smem + (m >> 1);
  load_wp(wp, wp_g, m_log2);
  const long long v0 = (long long)blockIdx.x * nvec;
  const int total = m * nvec;
  if (axis == 0) {
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int v = idx % nvec, j = idx / nvec;
      s[bitrev(j, m_log2) * nvec + v] = x[(long long)j * other + v0 + v];
    }
    __syncthreads();
    smem_ntt<true>(s, wp, m_log2, nvec, nvec, 1);
    const long long tstride = tw_period ? tw_period : other;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int v = idx % nvec, k = idx / nvec;
      uint64_t val = s[k * nvec + v];
      const long long c = v0 + v;
      if (tw) val = gl::mul(val, tw[(long long)k * tstride + (tw_period ? c % tw_period : c)]);
      if (scale != 1) val = gl::mul(val, scale);
      y[(long long)k * other + c] = val;
    }
  } else {
    const int sv = m + 1;  // odd row stride: rows start in different banks
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int j = idx % m, v = idx / m;
      s[v * sv + bitrev(j, m_log2)] = x[(v0 + v) * m + j];
    }
    __syncthreads();
    smem_ntt<false>(s, wp, m_log2, nvec, 1, sv);
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int k = idx % m, v = idx / m;
      uint64_t val = s[v * sv + k];
      const long long off = (v0 + v) * m + k;
      if (tw) val = gl::mul(val, tw[off]);
      if (scale != 1) val = gl::mul(val, scale);
      y[off] = val;
    }
  }
}

// ---- K3: [m1, mc, cols] -> same shape. For each k1: x[k1, a2, c] *=
// ta[k1, a2] (optional), DFT along the middle axis, y[k1, k2, c] *= t[k2, c]
// (optional). grid = (cols / nvec, m1).
__global__ void __launch_bounds__(kThreads)
ntt_phase_batched_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, int mc_log2,
                         int cols, int nvec, const uint64_t* __restrict__ wp_g,
                         const uint64_t* __restrict__ ta, const uint64_t* __restrict__ t) {
  extern __shared__ uint64_t smem[];
  const int mc = 1 << mc_log2;
  uint64_t* wp = smem;
  uint64_t* s = smem + (mc >> 1);
  load_wp(wp, wp_g, mc_log2);
  const int k1 = blockIdx.y;
  const int c0 = blockIdx.x * nvec;
  const long long base = (long long)k1 * mc * cols;
  const int total = mc * nvec;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int v = idx % nvec, j = idx / nvec;
    uint64_t val = x[base + (long long)j * cols + c0 + v];
    if (ta) val = gl::mul(val, ta[k1 * mc + j]);
    s[bitrev(j, mc_log2) * nvec + v] = val;
  }
  __syncthreads();
  smem_ntt<true>(s, wp, mc_log2, nvec, nvec, 1);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int v = idx % nvec, k = idx / nvec;
    uint64_t val = s[k * nvec + v];
    if (t) val = gl::mul(val, t[(long long)k * cols + c0 + v]);
    y[base + (long long)k * cols + c0 + v] = val;
  }
}

// ---- K4: x viewed [m1, m2, mc] = X[k1, k2, b3] -> y [mc, m2, m1] =
// Y[k3, k2, k1]: DFT along the last axis, times scale, written transposed so
// that the flat output is the natural order y[k1 + m1*k2 + m1*m2*k3]. The
// transpose happens in shared memory: loads run along b3, stores along k1.
// grid = (m1 / nvec, m2).
__global__ void __launch_bounds__(kThreads)
ntt_phase_last_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, int m1, int m2,
                      int mc_log2, int nvec, const uint64_t* __restrict__ wp_g, uint64_t scale) {
  extern __shared__ uint64_t smem[];
  const int mc = 1 << mc_log2;
  uint64_t* wp = smem;
  uint64_t* s = smem + (mc >> 1);
  load_wp(wp, wp_g, mc_log2);
  const int k1_0 = blockIdx.x * nvec;
  const int k2 = blockIdx.y;
  const int sv = mc + 1;
  const int total = mc * nvec;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int j = idx % mc, v = idx / mc;
    s[v * sv + bitrev(j, mc_log2)] = x[((long long)(k1_0 + v) * m2 + k2) * mc + j];
  }
  __syncthreads();
  smem_ntt<false>(s, wp, mc_log2, nvec, 1, sv);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int v = idx % nvec, k3 = idx / nvec;
    uint64_t val = s[v * sv + k3];
    if (scale != 1) val = gl::mul(val, scale);
    y[((long long)k3 * m2 + k2) * m1 + k1_0 + v] = val;
  }
}

}  // namespace

// All sizes are powers of two, 2 <= m <= 2^10. Each function returns the
// launch's cudaError_t (0 = launched), or cudaErrorInvalidValue for sizes
// it does not take.

extern "C" int sezkp_ntt_phase_axis(const void* x, void* y, int m_log2, long long other, int axis,
                                    const void* wp, const void* tw, long long tw_period,
                                    unsigned long long scale, void* stream) {
  if (m_log2 < 1 || m_log2 > 10 || other < 1 || (axis != 0 && axis != 1)) return (int)cudaErrorInvalidValue;
  if (axis == 1 && tw_period != 0) return (int)cudaErrorInvalidValue;
  const int m = 1 << m_log2;
  const int nvec = pick_nvec(m, other);
  const size_t smem = smem_bytes(m, nvec, axis == 1);
  ntt_phase_axis_kernel<<<(unsigned)(other / nvec), kThreads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)y, m_log2, other, axis, nvec, (const uint64_t*)wp,
      (const uint64_t*)tw, tw_period, (uint64_t)scale);
  return (int)cudaGetLastError();
}

extern "C" int sezkp_ntt_phase_batched(const void* x, void* y, int m1, int mc_log2, int cols,
                                       const void* wp, const void* ta, const void* t, void* stream) {
  if (mc_log2 < 1 || mc_log2 > 10 || m1 < 1 || m1 > 65535 || cols < 1) return (int)cudaErrorInvalidValue;
  const int mc = 1 << mc_log2;
  const int nvec = pick_nvec(mc, cols);
  const size_t smem = smem_bytes(mc, nvec, false);
  dim3 grid((unsigned)(cols / nvec), (unsigned)m1);
  ntt_phase_batched_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)y, mc_log2, cols, nvec, (const uint64_t*)wp,
      (const uint64_t*)ta, (const uint64_t*)t);
  return (int)cudaGetLastError();
}

extern "C" int sezkp_ntt_phase_last(const void* x, void* y, int m1, int m2, int mc_log2,
                                    const void* wp, unsigned long long scale, void* stream) {
  if (mc_log2 < 1 || mc_log2 > 10 || m1 < 1 || m2 < 1 || m2 > 65535) return (int)cudaErrorInvalidValue;
  const int mc = 1 << mc_log2;
  const int nvec = pick_nvec(mc, m1);
  const size_t smem = smem_bytes(mc, nvec, true);
  dim3 grid((unsigned)(m1 / nvec), (unsigned)m2);
  ntt_phase_last_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)y, m1, m2, mc_log2, nvec, (const uint64_t*)wp,
      (uint64_t)scale);
  return (int)cudaGetLastError();
}
