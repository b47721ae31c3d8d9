// The BLAKE3 compression rounds shared by K1 blake3_compress and K7
// blake3_chain: the G function, one round over the sixteen state words
// v0..v15 with the message words m[0..15], and the seven rounds with the
// message schedule written out as constants (round r uses MSG_PERM applied r
// times to 0..15), so no register is ever indexed by a run-time value.
//
// A kernel declares `uint32_t m[16]` and `uint32_t v0 .. v15` in scope, fills
// them, and expands B3_SEVEN_ROUNDS(); the chaining value is then
// v[i] ^ v[i + 8] for i = 0..7.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace b3 {

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

constexpr uint32_t IV0 = 0x6A09E667u, IV1 = 0xBB67AE85u, IV2 = 0x3C6EF372u, IV3 = 0xA54FF53Au;
constexpr uint32_t IV4 = 0x510E527Fu, IV5 = 0x9B05688Cu, IV6 = 0x1F83D9ABu, IV7 = 0x5BE0CD19u;

constexpr uint32_t CHUNK_START = 1u, CHUNK_END = 2u, ROOT = 8u;

}  // namespace b3

#define B3_G(a, b, c, d, mx, my) \
  do {                           \
    a = a + b + (mx);            \
    d = b3::rotr(d ^ a, 16);     \
    c = c + d;                   \
    b = b3::rotr(b ^ c, 12);     \
    a = a + b + (my);            \
    d = b3::rotr(d ^ a, 8);      \
    c = c + d;                   \
    b = b3::rotr(b ^ c, 7);      \
  } while (0)

#define B3_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  do {                                                                                  \
    B3_G(v0, v4, v8, v12, m[s0], m[s1]);                                                \
    B3_G(v1, v5, v9, v13, m[s2], m[s3]);                                                \
    B3_G(v2, v6, v10, v14, m[s4], m[s5]);                                               \
    B3_G(v3, v7, v11, v15, m[s6], m[s7]);                                               \
    B3_G(v0, v5, v10, v15, m[s8], m[s9]);                                               \
    B3_G(v1, v6, v11, v12, m[s10], m[s11]);                                             \
    B3_G(v2, v7, v8, v13, m[s12], m[s13]);                                              \
    B3_G(v3, v4, v9, v14, m[s14], m[s15]);                                              \
  } while (0)

#define B3_SEVEN_ROUNDS()                                              \
  do {                                                                 \
    B3_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);    \
    B3_ROUND(2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8);    \
    B3_ROUND(3, 4, 10, 12, 13, 2, 7, 14, 6, 5, 9, 0, 11, 15, 8, 1);    \
    B3_ROUND(10, 7, 12, 9, 14, 3, 13, 15, 4, 0, 11, 2, 5, 8, 1, 6);    \
    B3_ROUND(12, 13, 9, 11, 15, 10, 14, 8, 7, 2, 5, 3, 0, 1, 6, 4);    \
    B3_ROUND(9, 14, 11, 5, 8, 12, 15, 1, 13, 3, 0, 10, 2, 6, 4, 7);    \
    B3_ROUND(11, 15, 5, 0, 1, 9, 8, 6, 14, 10, 2, 12, 3, 4, 7, 13);    \
  } while (0)
