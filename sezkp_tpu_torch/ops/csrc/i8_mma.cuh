// int8 x int8 -> int32 tile products on the tensor cores (mma.sync) for K10
// (digit_dft.cu), and the balanced base-256 digits of a Goldilocks element
// with a 4 x 4 byte transpose, shared by K9 (gl_digits.cu), K10 and K11
// (digit_dft_last.cu). (K8, i8_gemm.cu, and K11 run wgmma: tma_wgmma.cuh.)
//
// The product is one warp-wide `mma.sync.aligned.m16n8k32` (inline PTX): A is
// 16 rows x 32 k (row-major, k contiguous), B is 32 k x 8 columns (column-
// major, k contiguous per column), C/D is 16 x 8 int32. The instruction has no
// `.satfinite`, so the accumulation wraps mod 2^32 exactly as an int32 sum
// does; the digit products never come near that (|sum| <= 8 m 2^14 <= 2^27).
// Operands are staged in shared memory by the caller, k contiguous for both,
// and read from there as the 32-bit fragments below. No wgmma, no TMA, no
// multi-stage pipeline: this is the simple form.
#pragma once
#include <stdint.h>

namespace i8mma {

// d += a @ b for one 16 x 8 x 32 tile. Lane (g = lane / 4, t = lane % 4)
// holds a[0] = A[g][4t..4t+3], a[1] = A[g+8][4t..], a[2] = A[g][16+4t..],
// a[3] = A[g+8][16+4t..]; b[0] = B[4t..4t+3][g], b[1] = B[16+4t..][g];
// c[0] = C[g][2t], c[1] = C[g][2t+1], c[2] = C[g+8][2t], c[3] = C[g+8][2t+1].
__device__ __forceinline__ void mma_16x8x32(int (&c)[4], const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment from a shared-memory tile stored [row][k], `lda` bytes per row
// (a multiple of 4). `tile` points at (row 0, k 0) of the 16 x 32 tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* tile, int lda, int lane) {
  const int8_t* p = tile + (lane >> 2) * lda + 4 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 16);
}

// B fragment from a shared-memory tile stored [column][k], `ldb` bytes per
// column. `tile` points at (column 0, k 0) of the 32 x 8 tile.
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const int8_t* tile, int ldb, int lane) {
  const int8_t* p = tile + (lane >> 2) * ldb + 4 * (lane & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 16);
}

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
