// The balanced base-256 digits of a Goldilocks element and a 4 x 4 byte
// transpose, the two pieces that turn field elements into the int8 digit
// words the tensor cores take. Used by K9 (gl_digits.cu) and by the body of
// K10 and K11 (digit_wgmma.cuh), which runs wgmma (tma_wgmma.cuh).
#pragma once
#include <stdint.h>

namespace i8mma {

// 4 x 4 byte transpose: r[i] holds row i (byte n = column n); afterwards r[n]
// holds column n (byte i = row i).
__device__ __forceinline__ void transpose4x4(uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0b0 r1b0 r0b1 r1b1
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // r0b2 r1b2 r0b3 r1b3
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// The 8 balanced base-256 digits d_k in [-128, 127] of the signed
// representative r of a canonical element v (< p): r = v - p where
// v > MAX_BAL = 0x7F7F7F7F7F7F7F7F, else v; r = sum_k d_k 256^k. Returned as
// the 8 digit bytes (two's complement), digit k in byte k.
// The byte-and-carry chain d_k = ((byte_k + c + 128) mod 256) - 128,
// c' = (byte_k + c + 128 >= 256), is one 64-bit addition of 0x80 to every
// byte (the carries propagate by themselves, the last one is dropped) and one
// xor that takes the 128 off each byte again.
__device__ __forceinline__ uint64_t balanced_digits(uint64_t v) {
  constexpr uint64_t kMaxBal = 0x7F7F7F7F7F7F7F7FULL;
  constexpr uint64_t kP = 0xFFFFFFFF00000001ULL;
  constexpr uint64_t k80 = 0x8080808080808080ULL;
  if (v > kMaxBal) v -= kP;
  return (v + k80) ^ k80;
}

}  // namespace i8mma
