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
//    contiguous for both operands. A block owns whole output runs: a tile
//    of kCols = 16 columns by R rows (R = 256, or the largest of 128, 64, 32
//    that divides m). Its input is R rows of 128 bytes, whole lines, read as
//    16 bytes (two columns) a thread, four rows a thread, every load of the
//    thread issued before the first is used (32 KB in flight a block). Each
//    element becomes its 8 digit bytes; a 4 x 4 byte transpose in registers
//    packs each plane's bytes of four consecutive rows into one word, which
//    goes to shared memory as [plane][column][R / 4 words], the word index
//    xor-ed with 4 (column / 2) so that a warp's 32 writes hit 32 banks.
//    Then each (plane, column) run of R bytes leaves in 16-byte stores,
//    consecutive threads on consecutive addresses: 8 contiguous runs of
//    16 R bytes when R = m. Every output line is written whole by one block,
//    not pieced together by blocks far apart in time.
//  - tiled, int8 [m, 8 * other]: for every `tile` columns the 8 digit planes
//    [m, tile] side by side, the layout the Pallas kernel writes. One thread
//    per element, loads and stores both along the columns.
#include <cuda_runtime.h>
#include <stdint.h>

#include "i8_mma.cuh"
#include "smem_opt_in.cuh"

namespace {

constexpr int kCols = 16;     // columns of a k-major tile (a multiple of 2)
constexpr int kThreads = 256;
constexpr int kMaxRows = 256;  // rows of a k-major tile, at most

// shared-memory word of plane i, column c, row quad q ([8][kCols][kQ] words,
// q xor-ed with 4 (c / 2): a warp's 32 writes in 32 banks)
template <int kQ>
__device__ __forceinline__ int smem_word(int i, int c, int q) {
  return (i * kCols + c) * kQ + (q ^ ((4 * (c >> 1)) & (kQ - 4)));
}

template <int R>
__global__ void __launch_bounds__(kThreads)
gl_digits_kmajor_kernel(const uint64_t* __restrict__ x, int8_t* __restrict__ out, long long m,
                        long long other) {
  extern __shared__ uint4 smem_v[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem_v);  // [8][kCols][kQ]
  constexpr int kQ = R / 4;             // words of a (plane, column) run
  constexpr int kPairs = kCols / 2;     // 16-byte loads across the tile's row
  constexpr int kItems = kQ * kPairs;   // (row quad, column pair) items
  constexpr int kPer = (kItems + kThreads - 1) / kThreads;
  const int tid = threadIdx.x;
  const long long c0 = (long long)blockIdx.x * kCols;
  const long long j0 = (long long)blockIdx.y * R;

  ulonglong2 v[kPer][4];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int it = tid + k * kThreads;
    if (kItems % kThreads == 0 || it < kItems) {
      const uint64_t* src = x + (j0 + 4 * (it / kPairs)) * other + c0 + 2 * (it % kPairs);
#pragma unroll
      for (int r = 0; r < 4; ++r) v[k][r] = __ldg(reinterpret_cast<const ulonglong2*>(src + r * other));
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int it = tid + k * kThreads;
    if (kItems % kThreads == 0 || it < kItems) {
      const int q = it / kPairs, cp = it % kPairs;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint64_t d = i8mma::balanced_digits(e ? v[k][r].y : v[k][r].x);
          lo[r] = (uint32_t)d;
          hi[r] = (uint32_t)(d >> 32);
        }
        i8mma::transpose4x4(lo);
        i8mma::transpose4x4(hi);
        const int c = 2 * cp + e;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[smem_word<kQ>(i, c, q)] = lo[i];
          s[smem_word<kQ>(4 + i, c, q)] = hi[i];
        }
      }
    }
  }
  __syncthreads();
  constexpr int kVec = R / 16;  // 16-byte vectors of a run
  constexpr int kStores = 8 * kCols * kVec;
#pragma unroll
  for (int k = 0; k < (kStores + kThreads - 1) / kThreads; ++k) {
    const int idx = tid + k * kThreads;
    if (kStores % kThreads == 0 || idx < kStores) {
      const int pc = idx / kVec, g = idx % kVec;  // pc = plane * kCols + column
      const int i = pc / kCols, c = pc % kCols;
      const uint4 val = *reinterpret_cast<const uint4*>(s + smem_word<kQ>(i, c, 4 * g));
      *reinterpret_cast<uint4*>(out + (i * other + c0 + c) * m + j0 + 16 * g) = val;
    }
  }
}

template <int R>
int launch_kmajor(const void* x, void* out, long long m, long long other, cudaStream_t st) {
  static unsigned long long opted = 0;
  constexpr size_t smem = 8 * kCols * R;
  const cudaError_t err = smem_opt_in(gl_digits_kmajor_kernel<R>, smem, opted);
  if (err) return (int)err;
  const dim3 grid((unsigned)(other / kCols), (unsigned)(m / R));
  gl_digits_kmajor_kernel<R><<<grid, kThreads, smem, st>>>((const uint64_t*)x, (int8_t*)out, m, other);
  return (int)cudaGetLastError();
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
// multiples of 32, m <= 2^21, x 16-byte aligned). tile > 0: out int8
// [m, 8 * other], tiled (other a multiple of tile). Returns the launch's
// cudaError_t, or cudaErrorInvalidValue for shapes it does not take.
extern "C" int sezkp_gl_digits(const void* x, void* out, long long m, long long other,
                               long long tile, void* stream) {
  if (m < 1 || other < 1 || tile < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tile == 0) {
    if (m % 32 || other % 32 || m > (1 << 21) || other / kCols > 0x7FFFFFFFLL || ((uintptr_t)x & 15))
      return (int)cudaErrorInvalidValue;
    if (m % kMaxRows == 0) return launch_kmajor<kMaxRows>(x, out, m, other, st);
    if (m % 128 == 0) return launch_kmajor<128>(x, out, m, other, st);
    if (m % 64 == 0) return launch_kmajor<64>(x, out, m, other, st);
    return launch_kmajor<32>(x, out, m, other, st);
  }
  if (other % tile) return (int)cudaErrorInvalidValue;
  const long long total = m * other;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  gl_digits_tiled_kernel<<<(unsigned)blocks, kThreads, 0, st>>>((const uint64_t*)x, (int8_t*)out, total, other,
                                                               tile);
  return (int)cudaGetLastError();
}
