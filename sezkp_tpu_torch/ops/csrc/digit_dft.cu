// K10 digit_dft: one DFT phase Y = W @ X along axis 0 of the Goldilocks NTT,
// computed the digit way on the tensor cores with TMA loads and wgmma.
//
// K10 replaces the Pallas kernels `k_dots` and `k_dr` of
// scripts/exp_ntt_breakdown.py (the digit-pair products of one phase summed
// by diagonal, ntt_mxu._dot_digits, then either the plain sum of the
// diagonals or the recombination mod p, ntt_mxu._recombine); with elements
// in and the recombination it is ntt_mxu._dft_call without a twiddle.
//
// The arithmetic: every operand is 8 balanced base-256 digits of its signed
// representative, so W @ X over the integers is sum_{i,j} 256^(i+j) W_j @ X_i,
// 64 int8 products with exact int32 sums (|.| <= m 2^14 each), gathered into
// the 15 diagonals s_d = sum_{i+j=d} W_j @ X_i (|s_d| <= 8 m 2^14 <= 2^27 for
// m <= 2^10), then either the diagonals added as int32 (u32 bits) or the
// canonical value of sum_d s_d 2^(8d) mod p.
//
// What bounds it on an H100: the operations, 2 * 64 * m int8 operations an
// output element over the dense 1979 TOPS (0.139 ms at m = 256, other =
// 32768); the bytes (8 an element in as u64 or as digits, 8 out recombined or
// 4 as the sum; the table from L2) take 0.030-0.040 ms.
//
// The design: K11's kernel (digit_dft_last.cu; the body is digit_wgmma.cuh's)
// with one table. In K11's terms X's rows k1 are K10's columns, b3 is the
// contraction index b and k3 the output row k: tiles of 64 columns (512 at
// 2^23, min(tiles, SMs) persistent blocks), N-tiles of 32 rows k, one
// producer warpgroup keeping TMA rings of X stages (16 b x 64 columns) and W
// stages (8 planes x 32 rows x 128 b) full, two consumer warpgroups that
// build the 128 KB cache of A fragments once a tile (at its first N-tile)
// and split the 15 diagonals of every N-tile's wgmma.m64n32k32 products.
// Four instantiations, (source, epilogue):
// - elements in: X u64 [m][other] is M-major (b runs down the columns), so a
//   stage lands as one box [16 b][64 columns] and each thread digitises 4
//   rows of one column (digit_wgmma.cuh, kXCols);
// - stack in: the int8 k-major stack [8][other][m] arrives K-major, a box of
//   8 planes x 64 columns x 16 b a stage, and is copied into the cache;
// - the recombination: K11's, stored as a [32 k][64 column] u64 tile;
// - the sum: each warpgroup adds its diagonals as int32, the two halves are
//   added and stored through an INT32 map (8 KB a tile).
// Columns >= other are TMA's zeros on the way in and fall outside the store.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "digit_wgmma.cuh"
#include "smem_opt_in.cuh"

namespace {

using namespace digit_wgmma;

template <int SRC, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
digit_dft_kernel(__grid_constant__ const CUtensorMap tm_w, __grid_constant__ const CUtensorMap tm_x,
                 __grid_constant__ const CUtensorMap tm_out, int m, int tiles) {
  body<SRC, EPI>(&tm_w, &tm_x, &tm_out, m, tiles, tiles);
}

template <int SRC, int EPI>
int launch(const CUtensorMap& tm_w, const CUtensorMap& tm_x, const CUtensorMap& tm_out, int m, int tiles,
           cudaStream_t stream) {
  cudaError_t err;
  static unsigned long long done = 0;
  if ((err = smem_opt_in(digit_dft_kernel<SRC, EPI>, kSmem, done))) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return (int)err;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  digit_dft_kernel<SRC, EPI><<<grid, kThreads, kSmem, stream>>>(tm_w, tm_x, tm_out, m, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// K10. Y[m, other] = W @ X along axis 0. w: int8 [8 * m, m], digit plane d of
// W in rows d*m .. (W symmetric). Exactly one of xdig (int8 [8, other, m], the
// k-major stack K9 writes) and x (u64 [m, other]) is non-null. out: int32
// [m, other] (epilogue 0: the sum of the diagonals) or u64 [m, other]
// (epilogue 1: the recombination). m a power of two in 32 .. 1024, other a
// multiple of 16 below 2^31 - 64; every pointer 16-byte aligned. Returns the
// launch's cudaError_t, cudaErrorInvalidValue for what it does not take, or
// cudaErrorNotSupported when a tensor map cannot be encoded.
extern "C" int sezkp_digit_dft(const void* w, const void* xdig, const void* x, void* out, int m,
                               long long other, int epilogue, void* stream) {
  if ((xdig == nullptr) == (x == nullptr) || m < 32 || m > 1024 || (m & (m - 1)) || other < 16 || other % 16 ||
      other > 0x7FFFFFFFLL - kRows || (epilogue != 0 && epilogue != 1))
    return (int)cudaErrorInvalidValue;
  const void* xs = xdig ? xdig : x;
  if (!aligned16(w) || !aligned16(xs) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  const int tiles = (int)((other + kRows - 1) / kRows);
  const cuuint64_t mm = (cuuint64_t)m, oo = (cuuint64_t)other;
  // W as [8 m rows][m b], boxes of 32 rows x 128 b
  const cuuint64_t wdims[2] = {mm, kNdig * mm}, wstr[1] = {mm};
  const cuuint32_t wbox[2] = {kWB, kN};
  // X: elements [m b][other], boxes of 16 b x 64 columns; the stack [8][other][m b], boxes of 8 x 64 x 16 b
  const cuuint64_t edims[2] = {oo, mm}, estr[1] = {oo * 8};
  const cuuint32_t ebox[2] = {kRows, kXB};
  const cuuint64_t sdims[3] = {mm, oo, kNdig}, sstr[2] = {mm, oo * mm};
  const cuuint32_t sbox[3] = {kXB, kRows, kNdig};
  // Y as [m][other], boxes of 32 rows x 64 columns (u64 or int32)
  const cuuint64_t odims[2] = {oo, mm}, ostr[1] = {oo * (epilogue ? 8 : 4)};
  const cuuint32_t obox[2] = {kRows, kN};
  CUtensorMap tm_w, tm_x, tm_out;
  if (!tensor_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdims, wstr, wbox, true) ||
      !(xdig ? tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, xdig, sdims, sstr, sbox, false)
             : tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT64, 2, x, edims, estr, ebox, false)) ||
      !tensor_map(&tm_out, epilogue ? CU_TENSOR_MAP_DATA_TYPE_UINT64 : CU_TENSOR_MAP_DATA_TYPE_INT32, 2, out, odims,
                  ostr, obox, false))
    return (int)cudaErrorNotSupported;
  const cudaStream_t s = (cudaStream_t)stream;
  if (xdig)
    return epilogue ? launch<kXStack, kRecombine>(tm_w, tm_x, tm_out, m, tiles, s)
                    : launch<kXStack, kSum>(tm_w, tm_x, tm_out, m, tiles, s);
  return epilogue ? launch<kXCols, kRecombine>(tm_w, tm_x, tm_out, m, tiles, s)
                  : launch<kXCols, kSum>(tm_w, tm_x, tm_out, m, tiles, s);
}
