// K4 ntt_phase_last: the last phase of the three-factor Goldilocks NTT.
//
// It replaces the Pallas kernel `_last_call_t` of sezkp_tpu/ops/ntt_mxu.py.
// x [m1, m2, mc] = X[k1, k2, b3] -> y [mc, m2, m1] = Y[k3, k2, k1]: the
// length-mc DFT along the last axis, times `scale`, stored transposed so that
// the flat output is the natural order y[k1 + m1*k2 + m1*m2*k3]. It computes
// what its counterpart computes, not the way it does (that one splits the
// elements into int8 digits for a matrix unit without 64-bit integers).
//
// What bounds it on an H100: as K2 and K3, the integer ALU pipe's issue rate
// for the field arithmetic (chip_smoke.py's bound_design, from
// ntt_torch.pass_counts and the primitives' instruction counts), ahead of the
// bytes (16 B an element: read once, written once).
//
// The design is K2's axis-1 tile (ntt_phases.cu, rows_tile) on the register
// passes of ntt_reg.cuh, templated on mc = 2^L and the direction, so every
// index is a shift, a mask or a constant, and every twiddle inside a
// length-16 DFT and between passes up to mc = 64 a power of two. A block takes
// V (= NT / T) neighbouring values of k1 at one k2; thread (v, t) =
// (threadIdx.x % V, threadIdx.x / V) holds 16 elements of vector k1_0 + v.
// The input side is contiguous along the DFT axis, so it is staged through
// shared memory with 16-byte loads (odd row pitch; up to mc = 16 a thread
// loads its whole vector into registers and touches no shared memory). The
// output side is not staged: the last pass's emit(k, q) stores a[q] * scale
// straight from registers to y[(k*m2 + k2)*m1 + k1_0 + v]. The V threads
// with the same t emit the same k for V neighbouring k1, so each store of a
// warp writes runs of V*8 contiguous bytes (128 B at mc = 256). That drops
// the first design's second shared-memory pass and its barrier, and its
// run-time index arithmetic (%, /, bit reversal) on every butterfly.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ntt_reg.cuh"
#include "smem_opt_in.cuh"

namespace {

using ntt_reg::Plan;
using ntt_reg::static_for;

template <int L>
struct LastTile {
  using P = Plan<L>;
  static constexpr int m = 1 << L, E = P::E, T = P::T, NT = P::NT;
  static constexpr int V = NT / T;    // values of k1 a block, one a thread
  static constexpr int pitch = m + 1; // odd: a half-warp's rows start in different banks
  static constexpr size_t smem = T > 1 ? sizeof(uint64_t) * V * pitch : 0;
};

// grid = (ceil(m1 / V), m2). pt: the pass twiddles (from mc = 128 up).
template <int L, bool INV>
__global__ void __launch_bounds__(Plan<L>::NT)
ntt_phase_last_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, int m1, int m2,
                      const uint64_t* __restrict__ pt, uint64_t scale) {
  using Tl = LastTile<L>;
  constexpr int m = Tl::m, E = Tl::E, T = Tl::T, NT = Tl::NT, V = Tl::V;
  const int v = threadIdx.x % V, t = threadIdx.x / V;
  const int k2 = blockIdx.y;
  const int kb = blockIdx.x * V;  // the block's first k1
  const int k1 = kb + v;          // the thread's k1
  const long long kstride = (long long)m2 * m1;
  uint64_t* yk = y + (long long)k2 * m1 + k1;
  uint64_t a[1][E];
  auto emit = [&](int k, auto q) {
    uint64_t e = a[0][q];
    if (scale != 1) e = gl::mul_cc(e, scale);
    if (k1 < m1) yk[k * kstride] = e;
  };
  if constexpr (T == 1) {
    // mc <= 16: a thread loads its whole vector; no shared memory
    const uint64_t* row = x + ((long long)k1 * m2 + k2) * m;
    static_for<E / 2>([&](auto q) {
      constexpr int j = 2 * decltype(q)::value;
      ulonglong2 w = make_ulonglong2(0, 0);
      if (k1 < m1) w = ntt_reg::ld16(row + j);
      a[0][j] = w.x;
      a[0][j + 1] = w.y;
    });
    ntt_reg::run_passes<L, INV, false>(a, 0, pt, [](int, auto) {}, [](int, auto) {}, emit);
  } else {
    extern __shared__ __align__(16) unsigned char ntt_smem_raw[];
    uint64_t* sr = reinterpret_cast<uint64_t*>(ntt_smem_raw);  // [V][pitch]
    constexpr int pitch = Tl::pitch, CH = V * m / 2;           // 16-byte chunks of the block's rows
    static_assert(CH % NT == 0, "the staged load is a whole number of rounds");
    static_for<CH / NT>([&](auto it) {
      const int i = threadIdx.x + decltype(it)::value * NT;
      const int r = i / (m / 2), k = 2 * (i % (m / 2));
      if (kb + r < m1) {
        const ulonglong2 w = ntt_reg::ld16(x + ((long long)(kb + r) * m2 + k2) * m + k);
        sr[r * pitch + k] = w.x;
        sr[r * pitch + k + 1] = w.y;
      }
    });
    __syncthreads();
    uint64_t* s = sr + v * pitch;
    static_for<E>([&](auto j) { a[0][decltype(j)::value] = s[decltype(j)::value * T + t]; });
    ntt_reg::run_passes<L, INV, false>(
        a, t, pt, [&](int pos, auto q) { s[pos] = a[0][q]; }, [&](int pos, auto q) { a[0][q] = s[pos]; }, emit);
  }
}

template <int L, bool INV>
int launch_last(const void* x, void* y, int m1, int m2, const void* pt, unsigned long long scale,
                cudaStream_t stream) {
  using Tl = LastTile<L>;
  auto kernel = ntt_phase_last_kernel<L, INV>;
  static unsigned long long done = 0;
  cudaError_t err;
  if ((err = smem_opt_in(kernel, Tl::smem, done))) return (int)err;
  dim3 grid((unsigned)((m1 + Tl::V - 1) / Tl::V), (unsigned)m2);
  kernel<<<grid, Tl::NT, Tl::smem, stream>>>((const uint64_t*)x, (uint64_t*)y, m1, m2, (const uint64_t*)pt,
                                             (uint64_t)scale);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// x [m1, m2, 2^mc_log2] -> y [2^mc_log2, m2, m1], 1 <= mc_log2 <= 10, x and y
// 16-byte aligned; pt = the pass twiddles [mc/16, 16] (ntt_torch._pass_twiddles),
// needed from mc = 128 up. Returns the launch's cudaError_t (0 = launched), or
// cudaErrorInvalidValue for what it does not take.
extern "C" int sezkp_ntt_phase_last(const void* x, void* y, int m1, int m2, int mc_log2, int inverse,
                                    const void* pt, unsigned long long scale, void* stream) {
  if (mc_log2 < 1 || mc_log2 > 10 || m1 < 1 || m2 < 1 || m2 > 65535) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(y) || (mc_log2 >= 7 && !pt)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mc_log2) {
    case 1: return inverse ? launch_last<1, true>(x, y, m1, m2, pt, scale, st) : launch_last<1, false>(x, y, m1, m2, pt, scale, st);
    case 2: return inverse ? launch_last<2, true>(x, y, m1, m2, pt, scale, st) : launch_last<2, false>(x, y, m1, m2, pt, scale, st);
    case 3: return inverse ? launch_last<3, true>(x, y, m1, m2, pt, scale, st) : launch_last<3, false>(x, y, m1, m2, pt, scale, st);
    case 4: return inverse ? launch_last<4, true>(x, y, m1, m2, pt, scale, st) : launch_last<4, false>(x, y, m1, m2, pt, scale, st);
    case 5: return inverse ? launch_last<5, true>(x, y, m1, m2, pt, scale, st) : launch_last<5, false>(x, y, m1, m2, pt, scale, st);
    case 6: return inverse ? launch_last<6, true>(x, y, m1, m2, pt, scale, st) : launch_last<6, false>(x, y, m1, m2, pt, scale, st);
    case 7: return inverse ? launch_last<7, true>(x, y, m1, m2, pt, scale, st) : launch_last<7, false>(x, y, m1, m2, pt, scale, st);
    case 8: return inverse ? launch_last<8, true>(x, y, m1, m2, pt, scale, st) : launch_last<8, false>(x, y, m1, m2, pt, scale, st);
    case 9: return inverse ? launch_last<9, true>(x, y, m1, m2, pt, scale, st) : launch_last<9, false>(x, y, m1, m2, pt, scale, st);
    case 10: return inverse ? launch_last<10, true>(x, y, m1, m2, pt, scale, st) : launch_last<10, false>(x, y, m1, m2, pt, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
