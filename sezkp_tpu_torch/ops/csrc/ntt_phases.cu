// K2 ntt_phase_axis, K3 ntt_phase_batched: the first two phases of the
// multi-step Goldilocks NTT (the last, K4 ntt_phase_last, is in ntt_last.cu on
// the same register passes).
//
// They replace two Pallas kernels of sezkp_tpu/ops/ntt_mxu.py
// (_dft_call/_dft_kernel, _batched_call/_batched_kernel). Each
// computes what its counterpart computes -- an exact length-m DFT
// Y[k] = sum_j X[j] w_m^(jk) along one axis of a 2-D or 3-D view, with the
// inter-phase twiddle multiplies fused in -- but not the way it does: the
// int8 digit split, the digit-pair matmuls and the diagonal recombine answer
// a matrix unit without 64-bit integers. Each element is read once and
// written once per phase (16 B), and the field arithmetic on it bounds the
// kernels on an H100: integer instructions of the ALU pipe, at about twice
// the time of the bytes (chip_smoke.py computes both bounds).
//
// K2 and K3 (this design) run the register-resident passes of ntt_reg.cuh,
// templated on m = 2^L and the direction, so every index is a shift, a mask
// or a constant: a thread holds 16 elements of each of its vectors, a
// length-16 DFT takes no shared memory and no barrier, the vectors of a tile
// exchange once through shared memory (twice for m = 512, 1024), and every
// twiddle inside a length-16 DFT, and between passes up to w_64, is a power
// of two (gl::mul_pow2: shifts, no 64-bit product). What is left of general
// products (gl::mul_cc): the twiddles between passes from m = 128 up, the
// fused tables (tw, ta, t) and the scale. The butterflies and the products'
// folds take their borrows and carries from PTX carry chains (gl::bfly,
// sub_pb, add_ce) instead of 64-bit compares and selects. What is left is
// the ALU pipe's issue rate: at 2^23 about 117 (K2) and 130 (K3) ALU
// instructions an element. K3 is held to 80 registers (three blocks an SM),
// which hides its latencies better than 126 registers and two blocks; K2
// gains nothing from it (probes/ntt_variants.py times both). Global loads and stores are 16 B
// along the contiguous axis. Strided vectors (K2 axis 0, K3): a thread takes
// two neighbouring columns, loads pass 1's inputs straight into registers
// and stores the last pass's outputs straight to memory; the tile in shared
// memory is [m][column pairs] of 16-B entries, which a quarter-warp reads as
// 128 contiguous bytes, so without bank conflicts. Contiguous vectors (K2
// axis 1): the tile is staged through shared memory (odd row pitch) in both
// directions, one vector a thread; up to m = 16 a thread keeps a whole
// vector and touches no shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ntt_reg.cuh"
#include "smem_opt_in.cuh"

namespace {

using ntt_reg::ld16;
using ntt_reg::Plan;
using ntt_reg::static_for;

// One 16-byte store (a struct assignment may come out as two 8-byte stores).
__device__ __forceinline__ void st16(uint64_t* p, uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  asm volatile("st.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(a), "l"(b) : "memory");
#else
  *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(a, b);
#endif
}

// ---- strided vectors: DFT along axis 0 of x [m, other] (other even), two
// neighbouring columns a thread; y[k, c] = DFT * tw[k*tw_stride + (c & tw_mask)]
// (if tw) * scale. pre: x[j, c] *= pre[j] before the DFT (if pre).
template <int L, bool INV>
__device__ __forceinline__ void cols_tile(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                                          long long other, const uint64_t* __restrict__ pre,
                                          const uint64_t* __restrict__ pt, const uint64_t* __restrict__ tw,
                                          long long tw_stride, long long tw_mask, uint64_t scale) {
  using P = Plan<L>;
  constexpr int E = P::E, T = P::T, CP = P::NT / T;
  extern __shared__ __align__(16) unsigned char ntt_smem_raw[];
  ulonglong2* sx = reinterpret_cast<ulonglong2*>(ntt_smem_raw);  // [m][CP]
  const int cp = threadIdx.x % CP, t = threadIdx.x / CP;
  const long long c = ((long long)blockIdx.x * CP + cp) * 2;
  const bool live = c < other;
  uint64_t a[2][E];
  const uint64_t* xt = x + t * other + c;
  static_for<E>([&](auto j1) {
    constexpr int j = decltype(j1)::value;
    ulonglong2 v = make_ulonglong2(0, 0);
    if (live) v = ld16(xt + j * T * other);
    if (pre) {
      const uint64_t w = __ldg(pre + j * T + t);
      v.x = gl::mul_cc(v.x, w);
      v.y = gl::mul_cc(v.y, w);
    }
    a[0][j] = v.x;
    a[1][j] = v.y;
  });
  const uint64_t* twc = tw + (c & tw_mask);
  ntt_reg::run_passes<L, INV, false>(
      a, t, pt,
      [&](int pos, auto q) { sx[pos * CP + cp] = make_ulonglong2(a[0][q], a[1][q]); },
      [&](int pos, auto q) {
        const ulonglong2 v = sx[pos * CP + cp];
        a[0][q] = v.x;
        a[1][q] = v.y;
      },
      [&](int k, auto q) {
        if (!live) return;
        uint64_t v0 = a[0][q], v1 = a[1][q];
        if (tw) {
          const ulonglong2 w = ld16(twc + k * tw_stride);
          v0 = gl::mul_cc(v0, w.x);
          v1 = gl::mul_cc(v1, w.y);
        }
        if (scale != 1) {
          v0 = gl::mul_cc(v0, scale);
          v1 = gl::mul_cc(v1, scale);
        }
        st16(y + k * other + c, v0, v1);
      });
}

// ---- contiguous vectors: DFT along axis 1 of x [other, m], one vector a
// thread; y[v, k] = DFT * tw[v, k] (if tw) * scale.
template <int L, bool INV>
__device__ __forceinline__ void rows_tile(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                                          long long other, const uint64_t* __restrict__ pt,
                                          const uint64_t* __restrict__ tw, uint64_t scale) {
  using P = Plan<L>;
  constexpr int m = 1 << L, E = P::E, T = P::T, V = P::NT / T;
  const int v = threadIdx.x % V, t = threadIdx.x / V;
  const long long v0 = (long long)blockIdx.x * V;
  auto tail = [&](long long row, int k, uint64_t& e0, uint64_t& e1) {
    if (tw) {
      const ulonglong2 w = ld16(tw + row * m + k);
      e0 = gl::mul_cc(e0, w.x);
      e1 = gl::mul_cc(e1, w.y);
    }
    if (scale != 1) {
      e0 = gl::mul_cc(e0, scale);
      e1 = gl::mul_cc(e1, scale);
    }
  };
  if constexpr (T == 1) {
    // m <= 16: the whole vector in registers, no shared memory
    const long long row = v0 + v;
    if (row >= other) return;
    uint64_t a[1][E];
    static_for<E / 2>([&](auto q) {
      const ulonglong2 w = ld16(x + row * m + 2 * decltype(q)::value);
      a[0][2 * decltype(q)::value] = w.x;
      a[0][2 * decltype(q)::value + 1] = w.y;
    });
    ntt_reg::run_passes<L, INV, false>(a, 0, pt, [](int, auto) {}, [](int, auto) {}, [](int, auto) {});
    static_for<E / 2>([&](auto q) {
      constexpr int k = 2 * decltype(q)::value;
      uint64_t e0 = a[0][k], e1 = a[0][k + 1];
      tail(row, k, e0, e1);
      st16(y + row * m + k, e0, e1);
    });
  } else {
    constexpr int pitch = m + 1;  // odd: the rows of a half-warp's 16 vectors start in different banks
    extern __shared__ __align__(16) unsigned char ntt_smem_raw[];
    uint64_t* sr = reinterpret_cast<uint64_t*>(ntt_smem_raw);  // [V][pitch]
    for (int i = threadIdx.x; i < V * m / 2; i += P::NT) {
      const int r = i / (m / 2), k = 2 * (i % (m / 2));
      if (v0 + r < other) {
        const ulonglong2 w = ld16(x + (v0 + r) * m + k);
        sr[r * pitch + k] = w.x;
        sr[r * pitch + k + 1] = w.y;
      }
    }
    __syncthreads();
    uint64_t* s = sr + v * pitch;
    uint64_t a[1][E];
    static_for<E>([&](auto j1) { a[0][decltype(j1)::value] = s[decltype(j1)::value * T + t]; });
    ntt_reg::run_passes<L, INV, true>(
        a, t, pt, [&](int pos, auto q) { s[pos] = a[0][q]; }, [&](int pos, auto q) { a[0][q] = s[pos]; },
        [&](int k, auto q) { s[k] = a[0][q]; });
    __syncthreads();
    for (int i = threadIdx.x; i < V * m / 2; i += P::NT) {
      const int r = i / (m / 2), k = 2 * (i % (m / 2));
      if (v0 + r < other) {
        uint64_t e0 = sr[r * pitch + k], e1 = sr[r * pitch + k + 1];
        tail(v0 + r, k, e0, e1);
        st16(y + (v0 + r) * m + k, e0, e1);
      }
    }
  }
}

// ---- K2: DFT along axis 0 of [m, other] (AXIS 0) or along axis 1 of
// [other, m] (AXIS 1); then y *= tw (optional), y *= scale (if != 1).
// axis 0: tw[k * tw_stride + (c & tw_mask)]: full [m, other] (stride other,
// mask all ones) or periodic [m, tw_period] (stride and mask + 1 = tw_period).
// axis 1: tw is [other, m] (full only).
template <int L, bool INV, int AXIS>
__global__ void __launch_bounds__(Plan<L>::NT)
ntt_phase_axis_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, long long other,
                      const uint64_t* __restrict__ pt, const uint64_t* __restrict__ tw,
                      long long tw_stride, long long tw_mask, uint64_t scale) {
  if constexpr (AXIS == 0)
    cols_tile<L, INV>(x, y, other, nullptr, pt, tw, tw_stride, tw_mask, scale);
  else
    rows_tile<L, INV>(x, y, other, pt, tw, scale);
}

// ---- K3: [m1, mc, cols] -> same shape. For each k1: x[k1, a2, c] *=
// ta[k1, a2] (optional), DFT along the middle axis, y[k1, k2, c] *= t[k2, c]
// (optional). grid = (column tiles, m1).
template <int L, bool INV>
__global__ void __launch_bounds__(Plan<L>::NT, Plan<L>::NT == 256 ? 3 : 1)
ntt_phase_batched_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, int cols,
                         const uint64_t* __restrict__ pt, const uint64_t* __restrict__ ta,
                         const uint64_t* __restrict__ t) {
  const long long base = (long long)blockIdx.y * cols << L;
  cols_tile<L, INV>(x + base, y + base, cols, ta ? ta + ((long long)blockIdx.y << L) : nullptr, pt, t,
                    cols, -1, 1);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int L, bool INV>
int launch_axis(const void* x, void* y, long long other, int axis, const void* pt, const void* tw,
                long long tw_period, unsigned long long scale, cudaStream_t stream) {
  using P = Plan<L>;
  cudaError_t err;
  if (axis == 0) {
    constexpr int CP = P::NT / P::T;
    constexpr size_t smem = P::NPASS > 1 ? sizeof(ulonglong2) * (1 << L) * CP : 0;
    auto kernel = ntt_phase_axis_kernel<L, INV, 0>;
    static unsigned long long done = 0;
    if ((err = smem_opt_in(kernel, smem, done))) return (int)err;
    kernel<<<(unsigned)((other + 2 * CP - 1) / (2 * CP)), P::NT, smem, stream>>>(
        (const uint64_t*)x, (uint64_t*)y, other, (const uint64_t*)pt, (const uint64_t*)tw,
        tw_period ? tw_period : other, tw_period ? tw_period - 1 : -1, (uint64_t)scale);
  } else {
    constexpr int V = P::NT / P::T;
    constexpr size_t smem = P::T > 1 ? sizeof(uint64_t) * V * ((1 << L) + 1) : 0;
    auto kernel = ntt_phase_axis_kernel<L, INV, 1>;
    static unsigned long long done = 0;
    if ((err = smem_opt_in(kernel, smem, done))) return (int)err;
    kernel<<<(unsigned)((other + V - 1) / V), P::NT, smem, stream>>>(
        (const uint64_t*)x, (uint64_t*)y, other, (const uint64_t*)pt, (const uint64_t*)tw, 0, 0,
        (uint64_t)scale);
  }
  return (int)cudaGetLastError();
}

template <int L, bool INV>
int launch_batched(const void* x, void* y, int m1, int cols, const void* pt, const void* ta, const void* t,
                   cudaStream_t stream) {
  using P = Plan<L>;
  constexpr int CP = P::NT / P::T;
  constexpr size_t smem = P::NPASS > 1 ? sizeof(ulonglong2) * (1 << L) * CP : 0;
  auto kernel = ntt_phase_batched_kernel<L, INV>;
  static unsigned long long done = 0;
  cudaError_t err;
  if ((err = smem_opt_in(kernel, smem, done))) return (int)err;
  dim3 grid((unsigned)((cols + 2 * CP - 1) / (2 * CP)), (unsigned)m1);
  kernel<<<grid, P::NT, smem, stream>>>((const uint64_t*)x, (uint64_t*)y, cols, (const uint64_t*)pt,
                                        (const uint64_t*)ta, (const uint64_t*)t);
  return (int)cudaGetLastError();
}

}  // namespace

#define NTT_DISPATCH(launch, ...)                                            \
  switch (m_log2) {                                                          \
    case 1: return inverse ? launch<1, true>(__VA_ARGS__) : launch<1, false>(__VA_ARGS__);   \
    case 2: return inverse ? launch<2, true>(__VA_ARGS__) : launch<2, false>(__VA_ARGS__);   \
    case 3: return inverse ? launch<3, true>(__VA_ARGS__) : launch<3, false>(__VA_ARGS__);   \
    case 4: return inverse ? launch<4, true>(__VA_ARGS__) : launch<4, false>(__VA_ARGS__);   \
    case 5: return inverse ? launch<5, true>(__VA_ARGS__) : launch<5, false>(__VA_ARGS__);   \
    case 6: return inverse ? launch<6, true>(__VA_ARGS__) : launch<6, false>(__VA_ARGS__);   \
    case 7: return inverse ? launch<7, true>(__VA_ARGS__) : launch<7, false>(__VA_ARGS__);   \
    case 8: return inverse ? launch<8, true>(__VA_ARGS__) : launch<8, false>(__VA_ARGS__);   \
    case 9: return inverse ? launch<9, true>(__VA_ARGS__) : launch<9, false>(__VA_ARGS__);   \
    case 10: return inverse ? launch<10, true>(__VA_ARGS__) : launch<10, false>(__VA_ARGS__); \
  }                                                                          \
  return (int)cudaErrorInvalidValue;

// All sizes are powers of two, 2 <= m <= 2^10. Each function returns the
// launch's cudaError_t (0 = launched), or cudaErrorInvalidValue for sizes,
// layouts or alignments it does not take. K2 and K3: every pointer 16-byte
// aligned; pt = the pass twiddles [m/16, 16] (ntt_torch._pass_twiddles),
// needed from m = 128 up.

extern "C" int sezkp_ntt_phase_axis(const void* x, void* y, int m_log2, long long other, int axis, int inverse,
                                    const void* pt, const void* tw, long long tw_period,
                                    unsigned long long scale, void* stream) {
  if (m_log2 < 1 || m_log2 > 10 || other < 1 || (axis != 0 && axis != 1)) return (int)cudaErrorInvalidValue;
  if (axis == 1 && tw_period != 0) return (int)cudaErrorInvalidValue;
  if (axis == 0 && (other % 2 || other / 2 > 0x7fffffffLL)) return (int)cudaErrorInvalidValue;
  if (tw_period && (tw_period < 2 || (tw_period & (tw_period - 1)) || other % tw_period))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(y) || !aligned16(tw) || (m_log2 >= 7 && !pt)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  NTT_DISPATCH(launch_axis, x, y, other, axis, pt, tw, tw_period, scale, st)
}

extern "C" int sezkp_ntt_phase_batched(const void* x, void* y, int m1, int mc_log2, int cols, int inverse,
                                       const void* pt, const void* ta, const void* t, void* stream) {
  const int m_log2 = mc_log2;
  if (m_log2 < 1 || m_log2 > 10 || m1 < 1 || m1 > 65535 || cols < 2 || cols % 2) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(y) || !aligned16(t) || (m_log2 >= 7 && !pt)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  NTT_DISPATCH(launch_batched, x, y, m1, cols, pt, ta, t, st)
}
