// Goldilocks field (p = 2^64 - 2^32 + 1) on one u64 per element.
//
// Every function takes canonical inputs (< p) and returns a canonical value:
// the outputs of the NTT phases are hashed, so a non-canonical representative
// would change proof bytes. The arithmetic mirrors ops/goldilocks_torch.py
// line for line (that file is the plain version the kernels are held to).
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

}  // namespace gl
