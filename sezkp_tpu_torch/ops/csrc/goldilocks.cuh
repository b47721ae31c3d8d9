// Goldilocks field (p = 2^64 - 2^32 + 1) on one u64 per element.
//
// Every function takes canonical inputs (< p) and returns a canonical value:
// the outputs of the NTT phases are hashed, so a non-canonical representative
// would change proof bytes. The arithmetic mirrors ops/goldilocks_torch.py
// line for line (that file is the plain version the kernels are held to).
//
//   add, sub, neg     field sum, difference, negation
//   mul               the 64 x 64 -> 128-bit product (IMAD.WIDE), folded
//   mul_pow2(x, e)    x * 2^e for 0 <= e < 192 from shifts alone: 2 has order
//                     192 (2^96 = -1), and every root of unity of order up to
//                     64 is a power of two, so the twiddles inside a transform
//                     of length <= 64 take this path (ntt_reg.cuh). With e a
//                     compile-time constant the shifts fold to constants.
//   bfly(u, t)        (u + t, u - t): the butterfly of the register passes.
//   mul_cc            mul, with the fold as below: the general products of
//                     the register passes (K2-K5; mul stays for gl_probe.cu
//                     and probes/ntt_variants.py's A/B).
//
// mul_pow2, mul_cc and bfly write their borrows and carries out as PTX
// carry chains (sub_pb, add_ce), where C++ compares 64-bit values instead
// (two ISETP and two SEL for every correction); the steps are those of sub
// and of mul's fold. Compiled for the host, the same steps run in plain C++.
#pragma once
#include <stdint.h>

namespace gl {

static constexpr uint64_t P = 0xFFFFFFFF00000001ULL;
static constexpr uint64_t EPS = 0xFFFFFFFFULL;  // 2^64 mod p

__device__ __forceinline__ uint64_t canon(uint64_t x) { return x >= P ? x - P : x; }

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;  // carry out of 2^64 folds back as +EPS (no second carry: a, b < p)
  return canon(s);
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) d -= EPS;  // wrapped a - b + 2^64 -> a - b + p
  return d;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  // hi = hh1 * 2^32 + hh0;  2^64 = EPS, 2^96 = -1 (mod p)
  const uint64_t hh0 = hi & EPS;
  const uint64_t hh1 = hi >> 32;
  uint64_t t0 = lo - hh1;
  if (lo < hh1) t0 -= EPS;
  const uint64_t t1 = hh0 * EPS;
  uint64_t r = t0 + t1;
  if (r < t1) r += EPS;
  return canon(r);
}

__device__ __forceinline__ uint64_t neg(uint64_t x) { return x ? P - x : 0; }

// sub's steps, a - b and -EPS (+p) on a borrow, with the borrow read off
// the subtraction itself. Right for a < 2^64 and b <= p where the difference
// is one of a field element (a - b >= -p).
__device__ __forceinline__ uint64_t sub_pb(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  uint32_t lo, hi;
  asm("{\n\t.reg .u32 bw;\n\t"
      "sub.cc.u32 %0, %2, %4;\n\t"
      "subc.cc.u32 %1, %3, %5;\n\t"
      "subc.u32 bw, 0, 0;\n\t"  // 0xFFFFFFFF = EPS on a borrow, else 0
      "sub.cc.u32 %0, %0, bw;\n\t"
      "subc.u32 %1, %1, 0;\n\t}"
      : "=r"(lo), "=r"(hi)
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b), "r"((uint32_t)(b >> 32)));
  return ((uint64_t)hi << 32) | lo;
#else
  uint64_t d = a - b;
  if (a < b) d -= EPS;
  return d;
#endif
}

// a + b and +EPS on a carry out of 2^64 (mul's fold: no second carry there).
__device__ __forceinline__ uint64_t add_ce(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  uint32_t lo, hi;
  asm("{\n\t.reg .u32 c;\n\t"
      "add.cc.u32 %0, %2, %4;\n\t"
      "addc.cc.u32 %1, %3, %5;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "sub.u32 c, 0, c;\n\t"  // EPS on a carry, else 0
      "add.cc.u32 %0, %0, c;\n\t"
      "addc.u32 %1, %1, 0;\n\t}"
      : "=r"(lo), "=r"(hi)
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b), "r"((uint32_t)(b >> 32)));
  return ((uint64_t)hi << 32) | lo;
#else
  uint64_t r = a + b;
  if (r < b) r += EPS;
  return r;
#endif
}

// mul's steps with the fold's two corrections as carry chains (sub_pb,
// add_ce): the general products of the register passes (ntt_reg.cuh).
__device__ __forceinline__ uint64_t mul_cc(uint64_t a, uint64_t b) {
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  return canon(add_ce(sub_pb(lo, hi >> 32), (hi & EPS) * EPS));
}

// (u + t, u - t) for canonical u, t, both canonical: u + t = u - (p - t),
// where no borrow means u + t >= p and the difference is the reduced sum, and
// a borrow adds p back (p - t = p when t = 0: then u).
__device__ __forceinline__ void bfly(uint64_t u, uint64_t t, uint64_t& sum, uint64_t& diff) {
  sum = sub_pb(u, P - t);
  diff = sub_pb(u, t);
}

// x * 2^e mod p, 0 <= e < 192. For e >= 96 it is -(x * 2^(e - 96)). With
// s = e mod 96 the product N = x * 2^s < 2^160 splits into n0 (bits 0..63),
// n1 (bits 64..95) and n2 (bits 96..159, < 2^63), and
// N = n0 + n1 * 2^64 + n2 * 2^96 = n0 + n1 * EPS - n2 (mod p): the fold of
// mul, with n1 * EPS as a shift and a subtraction instead of a product (no
// 64 x 64 product; nvcc makes the shift and subtraction one 32 x 32
// IMAD.WIDE.U32, which keeps it off the busier ALU pipe).
__device__ __forceinline__ uint64_t mul_pow2(uint64_t x, int e) {
  const bool negate = e >= 96;
  const int s = negate ? e - 96 : e;
  uint64_t n0, n1, n2;
  if (s == 0) {
    n0 = x;
    n1 = 0;
    n2 = 0;
  } else if (s < 64) {
    n0 = x << s;
    n1 = (x >> (64 - s)) & EPS;
    n2 = s > 32 ? x >> (96 - s) : 0;
  } else {
    n0 = 0;
    n1 = (x << (s - 64)) & EPS;
    n2 = x >> (96 - s);
  }
  const uint64_t t0 = s > 32 ? sub_pb(n0, n2) : n0;  // n2 < 2^63 < p: one correction (n2 = 0 up to s = 32)
  const uint64_t t1 = (n1 << 32) - n1;
  const uint64_t r = canon(s ? add_ce(t0, t1) : t0);  // n1 = 0 at s = 0
  return negate ? neg(r) : r;
}

}  // namespace gl
