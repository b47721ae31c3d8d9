// K9 gl_digits: Goldilocks elements -> 8 balanced base-256 int8 digits.
//
// It replaces the Pallas kernel `k_dig` of scripts/exp_ntt_breakdown.py, which
// runs ntt_mxu._digits over [m, tile] blocks: canonical element -> signed
// representative (minus p above MAX_BAL) -> byte-and-carry chain -> 8 digits in
// [-128, 127], the last carry dropped. Here that chain is one addition and
// one xor per element (i8_mma.cuh, balanced_digits).
//
// What bounds it on an H100: the bytes, 8 read and 8 written per element;
// the arithmetic is a handful of integer instructions. So the design is about
// the two layouts it writes, x being [m, other] row-major:
//  - k-major, int8 [8, other, m]: digit plane d, then column c, then the m
//    values down that column contiguous. This is what K10 (digit_dft.cu)
//    loads: the tensor-core instruction wants the contraction index
//    contiguous for both operands. A block takes a 32 x 32 tile of x, reads
//    it along the columns (coalesced), digitises four rows per thread, packs
//    the four digit bytes of each plane into one word by a 4 x 4 byte
//    transpose in registers, and turns the tile in shared memory so that the
//    stores run along m, 32 bytes per (plane, column).
//  - tiled, int8 [m, 8 * other]: for every `tile` columns the 8 digit planes
//    [m, tile] side by side, the layout the Pallas kernel writes. One thread
//    per element, loads and stores both along the columns.
#include <cuda_runtime.h>
#include <stdint.h>

#include "i8_mma.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gl_digits_kmajor_kernel(const uint64_t* __restrict__ x, int8_t* __restrict__ out, int m,
                        long long other) {
  // [plane][column][8 words of 4 rows], 9 words per column against bank conflicts
  __shared__ uint32_t s[8][kTile][9];
  const int tid = threadIdx.x;
  const long long c0 = (long long)blockIdx.x * kTile;
  const int j0 = blockIdx.y * kTile;
  {
    const int c = tid % kTile, jq = tid / kTile;
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint64_t d = i8mma::balanced_digits(x[(long long)(j0 + 4 * jq + r) * other + c0 + c]);
      lo[r] = (uint32_t)d;
      hi[r] = (uint32_t)(d >> 32);
    }
    i8mma::transpose4x4(lo);
    i8mma::transpose4x4(hi);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i][c][jq] = lo[i];
      s[4 + i][c][jq] = hi[i];
    }
  }
  __syncthreads();
  const int c = tid / 8, q = tid % 8;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<uint32_t*>(out + ((long long)i * other + c0 + c) * m + j0 + 4 * q) = s[i][c][q];
}

__global__ void __launch_bounds__(kThreads)
gl_digits_tiled_kernel(const uint64_t* __restrict__ x, int8_t* __restrict__ out, long long total,
                       long long other, long long tile) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long j = idx / other, c = idx % other;
  const uint64_t d = i8mma::balanced_digits(x[idx]);
  int8_t* o = out + j * 8 * other + (c / tile) * 8 * tile + c % tile;
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i * tile] = (int8_t)(d >> (8 * i));
}

}  // namespace

// x u64 [m, other]. tile == 0: out int8 [8, other, m] (k-major; m and other
// multiples of 32, m <= 2^21). tile > 0: out int8 [m, 8 * other], tiled (other
// a multiple of tile). Returns the launch's cudaError_t, or
// cudaErrorInvalidValue for shapes it does not take.
extern "C" int sezkp_gl_digits(const void* x, void* out, long long m, long long other,
                               long long tile, void* stream) {
  if (m < 1 || other < 1 || tile < 0) return (int)cudaErrorInvalidValue;
  if (tile == 0) {
    if (m % kTile || other % kTile || m / kTile > 65535 || other / kTile > 0x7FFFFFFFLL)
      return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)(other / kTile), (unsigned)(m / kTile));
    gl_digits_kmajor_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)x, (int8_t*)out, (int)m, other);
  } else {
    if (other % tile) return (int)cudaErrorInvalidValue;
    const long long total = m * other;
    const long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    gl_digits_tiled_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)x, (int8_t*)out, total, other, tile);
  }
  return (int)cudaGetLastError();
}
