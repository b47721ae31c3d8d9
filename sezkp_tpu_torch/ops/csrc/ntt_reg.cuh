// Register-resident radix passes of the Goldilocks NTT: the core of K2
// ntt_phase_axis and K3 ntt_phase_batched (ntt_phases.cu), of K4
// ntt_phase_last (ntt_last.cu) and of K5 ntt_small (ntt_small.cu).
//
// A length-m DFT (m = 2^L, L <= 10) of one vector is split into passes over
// registers. Thread t of the vector holds E = min(m, 2^R) elements (R = 4,
// 16 elements, in K2-K4; a kernel may pick a smaller R) and, with M1 = m / E:
//
//   pass 1  x[j1*M1 + t] (j1 < E) -> a length-E DFT in registers -> times
//           w_m^(k1 t) -> shared memory at position k1*M1 + t;
//   pass 2  (m <= E^2) positions E*t .. E*t+E-1, i.e. E/M1 vectors of length
//           M1 (k1 = t*E/M1 + i) -> their DFTs are y[k1 + E k2];
//           (E^2 < m <= E^3; M1 = E*M2) thread t = E*jj + k1 reads
//           positions k1*M1 + j2a*M2 + jj -> a length-E DFT -> times
//           w_M1^(k2a jj) -> written back in place;
//   pass 3  (E^2 < m) positions E*t .. E*t+E-1 = d*M2 + j3 with
//           d = E k1 + k2a -> length-M2 DFTs -> y[k1 + E k2a + E^2 k3].
//
// Inside a pass nothing touches shared memory and no thread waits for
// another; a tile has one barrier (m <= E^2) or two. Every index into the
// register arrays is a compile-time constant (static_for), so the arrays stay
// in registers. A length-r DFT in registers (r <= 16) is radix-2
// decimation in time on the renamed, bit-reversed inputs, and its twiddles
// w_{2^s}^pos are powers of two mod p (kRootExp below): gl::mul_pow2 with a
// constant exponent, shifts only. A twiddle 2^e with e >= 96 is -2^(e-96);
// the butterfly takes the sign by swapping its add and subtract. The
// twiddles between passes are powers of two up to w_64 (compile-time
// exponents once the run-time index has been matched against its few values,
// which are the same across a warp in K2-K4's thread layouts); w_128 and
// up are general products (gl::mul_cc) from a table [M1, E]. ntt_torch.pass_model is the
// same schedule in tensor code.
#pragma once
#include <stdint.h>

#include <type_traits>

#include "goldilocks.cuh"

namespace ntt_reg {

// One 16-byte load through the read-only path.
__device__ __forceinline__ ulonglong2 ld16(const uint64_t* p) {
  return __ldg(reinterpret_cast<const ulonglong2*>(p));
}

// A compile-time index that converts to int on the device too.
template <int I>
struct ic {
  static constexpr int value = I;
  __host__ __device__ constexpr operator int() const { return I; }
};

// f(ic<0>), f(ic<1>), ..., f(ic<N-1>): compile-time indices.
template <int N, int I = 0, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(ic<I>{});
    static_for<N, I + 1>(f);
  }
}

// f(ic<v>) for a run-time v in [0, N): a chain of compares, one path taken
// without divergence where v is the same across the warp.
template <int N, int I = 0, class F>
__device__ __forceinline__ void static_switch(int v, F&& f) {
  if constexpr (I < N) {
    if (v == I)
      f(ic<I>{});
    else
      static_switch<N, I + 1>(v, f);
  }
}

// kRootExp: 2^root_exp(k) = w_{2^k} = primitive_root_2exp(k), k <= 6
// (ntt_torch.POW2_ROOT_EXP; the tests compare the two).
__host__ __device__ constexpr int root_exp(int k) {
  return k == 1 ? 96 : k == 2 ? 48 : k == 3 ? 120 : k == 4 ? 156 : k == 5 ? 78 : k == 6 ? 39 : 0;
}

// e with 2^e = w_{2^k}^i (w^-i for the inverse), 0 <= e < 192.
__host__ __device__ constexpr int pow2_exp(int k, int i, bool inv) {
  const int e = root_exp(k) * i % 192;
  return inv ? (192 - e) % 192 : e;
}

__host__ __device__ constexpr int brev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// (u, v) -> (u + v 2^E, u - v 2^E).
template <int E>
__device__ __forceinline__ void bfly(uint64_t& u, uint64_t& v) {
  constexpr int s = E % 96;
  const uint64_t t = s ? gl::mul_pow2(v, s) : v;
  uint64_t a, b;
  gl::bfly(u, t, a, b);
  if constexpr (E < 96) {
    u = a;
    v = b;
  } else {
    u = b;
    v = a;
  }
}

// In place, natural order in and out: the length-2^LR DFT of a[BASE + i],
// i < 2^LR.
template <int LR, bool INV, int BASE, int N>
__device__ __forceinline__ void dft_reg(uint64_t (&a)[N]) {
  constexpr int R = 1 << LR;
  uint64_t b[R];
  static_for<R>([&](auto i) { b[decltype(i)::value] = a[BASE + brev(decltype(i)::value, LR)]; });
  static_for<LR>([&](auto s0) {
    constexpr int half = 1 << decltype(s0)::value;  // stage s = s0 + 1
    static_for<R / 2>([&](auto q) {
      constexpr int pos = decltype(q)::value % half;
      constexpr int i0 = decltype(q)::value / half * 2 * half + pos;
      bfly<pow2_exp(decltype(s0)::value + 1, pos, INV)>(b[i0], b[i0 + half]);
    });
  });
  static_for<R>([&](auto i) { a[BASE + decltype(i)::value] = b[decltype(i)::value]; });
}

// a[c][q] *= w_{2^K}^(q * IDX) for every column c and q < Q (powers of two).
template <int K, int IDX, bool INV, int Q, int NC, int N>
__device__ __forceinline__ void twiddle_pow2(uint64_t (&a)[NC][N]) {
  static_for<Q>([&](auto q) {
    constexpr int e = pow2_exp(K, decltype(q)::value * IDX, INV);
    if constexpr (e != 0)
      static_for<NC>([&](auto c) { a[c][decltype(q)::value] = gl::mul_pow2(a[c][decltype(q)::value], e); });
  });
}

// The pass plan of length m = 2^L with 2^R registers a vector (R = 4 in K2-K4).
template <int L, int R = 4>
struct Plan {
  static constexpr int LR1 = L < R ? L : R;  // log2 radix of pass 1
  static constexpr int E = 1 << LR1;         // elements a thread holds of a vector
  static constexpr int T = (1 << L) / E;     // threads of a vector (= M1)
  static constexpr int NPASS = L <= R ? 1 : L <= 2 * R ? 2 : 3;
  static constexpr int LR2 = NPASS == 2 ? L - R : R;
  static constexpr int M2 = NPASS == 3 ? 1 << (L - 2 * R) : 1;
  static constexpr int NT = L == 10 ? 512 : 256;  // threads a block (K2-K4)
  static_assert(L <= 3 * R, "at most three passes");
};

__host__ __device__ constexpr int ilog2(int n) { return n > 1 ? 1 + ilog2(n >> 1) : 0; }

// One thread's twiddles between pass 1 and pass 2 (row t of a table [M1, E]),
// loaded into registers ahead of the passes: run_passes takes it in place
// of the table where a kernel would otherwise wait for these loads in the
// middle of its chain (behind a barrier, say).
template <int E>
struct PassRow {
  uint64_t w[E];
  __device__ __forceinline__ void load(const uint64_t* __restrict__ pt, int t) {
    static_for<E - 1>([&](auto k0) { w[k0 + 1] = __ldg(pt + t * E + k0 + 1); });
  }
};

// The passes of one tile, for NC vectors a thread (NC columns side by side),
// each of N = E registers (the plan is Plan<L, log2 N>). On entry a[c][j1]
// holds x[j1*M1 + t] of column c. put(pos, q) / get(pos, q)
// move a[.][q] to / from position pos of the thread's vectors in shared
// memory; emit(k, q) takes a[.][q] = y[k]. SYNC_EMIT puts a barrier between
// the last pass's reads and its emits (for emits into the same shared memory).
// The twiddles between pass 1 and pass 2 come from pt: the table [M1, E]
// (from m = 128 up, or at every m with TABLE: a kernel whose warps hold
// several t takes no branch for each value) or this thread's PassRow.
template <int L, bool INV, bool SYNC_EMIT, bool TABLE = false, int NC, int N, class PT, class Put, class Get,
          class Emit>
__device__ __forceinline__ void run_passes(uint64_t (&a)[NC][N], int t, PT pt, Put&& put, Get&& get, Emit&& emit) {
  using P = Plan<L, ilog2(N)>;
  constexpr int E = P::E, T = P::T;
  static_assert(N == E, "a thread holds E elements of each vector");
  static_for<NC>([&](auto c) { dft_reg<P::LR1, INV, 0>(a[c]); });
  if constexpr (P::NPASS == 1) {
    static_for<E>([&](auto q) { emit(decltype(q)::value, q); });
  } else {
    if constexpr (L <= 6 && !TABLE) {
      static_switch<T>(t, [&](auto tt) { twiddle_pow2<L, decltype(tt)::value, INV, E>(a); });
    } else {
      if constexpr (std::is_pointer_v<PT>) {
        const uint64_t* __restrict__ row = pt + t * E;
        static_for<E - 1>([&](auto k0) {
          constexpr int k1 = decltype(k0)::value + 1;
          const uint64_t w = __ldg(row + k1);
          static_for<NC>([&](auto c) { a[c][k1] = gl::mul_cc(a[c][k1], w); });
        });
      } else {  // a PassRow
        static_for<E - 1>([&](auto k0) {
          constexpr int k1 = decltype(k0)::value + 1;
          static_for<NC>([&](auto c) { a[c][k1] = gl::mul_cc(a[c][k1], pt.w[k1]); });
        });
      }
    }
    static_for<E>([&](auto k1) { put(decltype(k1)::value * T + t, k1); });
    __syncthreads();
    if constexpr (P::NPASS == 2) {
      constexpr int D = E / T;  // transforms of length T a thread
      static_for<E>([&](auto q) { get(t * E + decltype(q)::value, q); });
      if constexpr (SYNC_EMIT) __syncthreads();
      static_for<D>([&](auto i) {
        static_for<NC>([&](auto c) { dft_reg<P::LR2, INV, decltype(i)::value * T>(a[c]); });
      });
      static_for<E>([&](auto q) {
        constexpr int i = decltype(q)::value / T, k2 = decltype(q)::value % T;
        emit(t * D + i + E * k2, q);
      });
    } else {
      constexpr int M2 = P::M2, M1 = E * M2, D = E / M2;
      const int jj = t / E, k1 = t % E;
      static_for<E>([&](auto j) { get(k1 * M1 + decltype(j)::value * M2 + jj, j); });
      static_for<NC>([&](auto c) { dft_reg<P::LR1, INV, 0>(a[c]); });
      static_switch<M2>(jj, [&](auto jc) { twiddle_pow2<L - P::LR1, decltype(jc)::value, INV, E>(a); });
      static_for<E>([&](auto k2a) { put(k1 * M1 + decltype(k2a)::value * M2 + jj, k2a); });
      __syncthreads();
      static_for<E>([&](auto q) { get(t * E + decltype(q)::value, q); });
      if constexpr (SYNC_EMIT) __syncthreads();
      static_for<D>([&](auto i) {
        static_for<NC>([&](auto c) { dft_reg<L - 2 * P::LR1, INV, decltype(i)::value * M2>(a[c]); });
      });
      static_for<E>([&](auto q) {
        constexpr int i = decltype(q)::value / M2, k3 = decltype(q)::value % M2;
        const int d = t * D + i;
        emit(d / E + E * (d % E) + E * E * k3, q);
      });
    }
  }
}

}  // namespace ntt_reg
