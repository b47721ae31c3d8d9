// K12 deep_divide: the division of the DEEP quotient, out[i] = y[i] / (xs[i] - z)
// over a flat array of n >= 1 field elements, with 1/0 taken as 0.
//
// It replaces no Pallas kernel: the JAX package divides in plain jnp
// (ntt_jax._pow_p_minus_2 under fori_loop, 64 squarings and the multiplies of
// the set bits of p - 2, each a pass over the whole array). The plain version
// (ntt_torch.deep_divide_plain) is that chain in eager tensor code: some
// 6,100 elementwise operations, each a pass over the array.
//
// What bounds it on an H100: 24 B a point (y and xs read once, out written
// once) against, with the batched inverse below, about 4 + 72 / K Goldilocks
// products a point; the integer pipes' issue rate is the nearer bound
// (chip_smoke.py reckons both from the disassembly).
//
// The design is Montgomery's batched inversion in registers. Thread t of
// block b owns the K points b*K*T + j*T + t, j < K: a block's width apart,
// so every load and store of a warp is 256 contiguous bytes. It forms
// d_j = xs_j - z and the prefix products c_j = d_0 ... d_j, inverts c_{K-1}
// once by a fixed addition chain for p - 2 (63 squarings, 9 multiplies,
// against the 126 products of square-and-multiply), walks back through the
// prefixes to each d_j^-1 (two products a point) and stores y_j * d_j^-1.
// A zero d_j (z on the coset) enters the products as 1 and stores 0, which
// is what x^(p-2) gives for 0, and leaves the rest of its batch right;
// points past n enter as 1 and store nothing. ntt_torch.deep_divide_model is
// this schedule in tensor code.
//
// K = 8: the chain's share of a point halves at K = 16, but the 112
// registers a thread then hold fewer warps on an SM than the 58 at K = 8,
// and the serial chain leaves them waiting: on an H100 at 2^23 points 0.198
// ms at K = 16 against 0.159 at K = 8 (probes/ntt_variants.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace {

constexpr int kPoints = 8;     // points a thread (K above)
constexpr int kThreads = 128;  // threads a block
static_assert(kPoints <= 32, "one bit a point in the zero mask");

__device__ __forceinline__ uint64_t sqr_n(uint64_t x, int n) {
  for (int i = 0; i < n; ++i) x = gl::mul_cc(x, x);
  return x;
}

// x^(p-2) = x^(2^64 - 2^32 - 1), with t_k = x^(2^k - 1): t_2 = t_1^2 t_1,
// t_3 = t_2^2 t_1, t_6 = t_3^(2^3) t_3, t_12 = t_6^(2^6) t_6,
// t_24 = t_12^(2^12) t_12, t_30 = t_24^(2^6) t_6, t_31 = t_30^2 t_1; then
// s = t_31^2 = x^(2^32 - 2), t_32 = s x, and s^(2^32) t_32.
__device__ __forceinline__ uint64_t pow_p_minus_2(uint64_t x) {
  const uint64_t t2 = gl::mul_cc(sqr_n(x, 1), x);
  const uint64_t t3 = gl::mul_cc(sqr_n(t2, 1), x);
  const uint64_t t6 = gl::mul_cc(sqr_n(t3, 3), t3);
  const uint64_t t12 = gl::mul_cc(sqr_n(t6, 6), t6);
  const uint64_t t24 = gl::mul_cc(sqr_n(t12, 12), t12);
  const uint64_t t30 = gl::mul_cc(sqr_n(t24, 6), t6);
  const uint64_t t31 = gl::mul_cc(sqr_n(t30, 1), x);
  const uint64_t s = sqr_n(t31, 1);
  return gl::mul_cc(sqr_n(s, 32), gl::mul_cc(s, x));
}

__global__ void __launch_bounds__(kThreads)
deep_divide_kernel(const uint64_t* __restrict__ y, const uint64_t* __restrict__ xs,
                   uint64_t* __restrict__ out, long long n, uint64_t z) {
  const long long i0 = (long long)blockIdx.x * (kPoints * kThreads) + threadIdx.x;
  uint64_t d[kPoints], c[kPoints];
  uint32_t zero = 0;  // bit j: d_j == 0
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const long long i = i0 + (long long)j * kThreads;
    uint64_t dj = 1;
    if (i < n) {
      dj = gl::sub(xs[i], z);
      if (dj == 0) {
        zero |= 1u << j;
        dj = 1;
      }
    }
    d[j] = dj;
    c[j] = j ? gl::mul_cc(c[j - 1], dj) : dj;
  }
  // inv = (d_0 ... d_j)^-1, from j = kPoints - 1 down
  uint64_t inv = pow_p_minus_2(c[kPoints - 1]);
#pragma unroll
  for (int j = kPoints - 1; j >= 0; --j) {
    const uint64_t dinv = j ? gl::mul_cc(inv, c[j - 1]) : inv;
    if (j) inv = gl::mul_cc(inv, d[j]);
    const long long i = i0 + (long long)j * kThreads;
    if (i < n) out[i] = (zero >> j) & 1 ? 0 : gl::mul_cc(y[i], dinv);
  }
}

}  // namespace

// y, xs, out: n uint64 field elements (canonical), out apart from both
// inputs; z canonical. Returns the launch's cudaError_t (0 = launched).
extern "C" int sezkp_deep_divide(const void* y, const void* xs, void* out, long long n,
                                 unsigned long long z, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kPoints * kThreads - 1) / (kPoints * kThreads);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  deep_divide_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)y, (const uint64_t*)xs, (uint64_t*)out, n, (uint64_t)z);
  return (int)cudaGetLastError();
}
