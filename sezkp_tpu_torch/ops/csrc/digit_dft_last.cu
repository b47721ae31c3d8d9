// K11 digit_dft_last: the last phase of the three-factor Goldilocks NTT, with
// the middle twiddle folded into one table per middle index k2, computed the
// digit way on the tensor cores with TMA loads and wgmma.
//
// It replaces `_last_call_t_folded` of scripts/ntt_twiddle_fold_ab.py (the
// pl.pallas_call at :101): for every k2 < m2,
//   Y[k3, k2 cols + k1] = sum_b3 X[k1, k2 mc + b3] W'[k2][k3, b3] mod p,
// X field elements u64 [cols, m2 mc], W' the int8 digit table
// [m2][mc k3][8 digits][mc b3] (ntt_digits_torch.folded_table), Y u64
// [mc, m2 cols], whose flat order is the natural order of the transform.
// The arithmetic is K10's (digit_dft.cu): 8 balanced base-256 digits of each
// operand, 64 int8 products summed by diagonal into 15 exact int32 sums
// (|s_d| <= 8 mc 2^14 <= 2^27), one recombination mod p.
//
// What bounds it on an H100: the operations, 2 * 64 * mc int8 operations an
// output element over the dense 1979 TOPS (0.139 ms at 2^23: cols = 128,
// m2 = 256, mc = 256); the bytes (8 an element in, 8 out, the 134 MB table
// once) take 0.080 ms.
//
// The design (the GEMM shape of K8, i8_gemm.cu, on the pieces of
// tma_wgmma.cuh; the kernel body is digit_wgmma.cuh's, which K10 shares):
// - The product D[k1][k3] = sum_b3 X_i[k1][b3] W_j[k3][b3] has both operands
//   K-major (b3 contiguous), as wgmma takes 8-bit operands. A (M = 64 k1) is
//   X's digit plane i from registers; B (N = 32 k3) is plane j of W' straight
//   from its TMA tile. wgmma.m64n32k32.s32.s8.s8, no .satfinite.
// - The accumulators: a diagonal is N / 2 = 16 registers a thread, so the 15
//   do not fit one warpgroup (and at N = 16, where they would, the int8
//   wgmma issues below the dense rate: probes/wgmma_rate.py). The two
//   consumer warpgroups compute the same 64 x 32 tile and split the
//   diagonals, 32 digit products each: {0..6, 11} (128 registers) and
//   {7..10, 12..14} (112). Each adds its diagonals into a field element (the
//   recombination is linear), and the two halves meet in shared memory.
//   Shared memory read a k32 step: B 64 x 1 KB and A 2 x 8 x 2 KB of
//   fragments against 64 products of 131,072 operations: 96 of the 128
//   bytes a clock an SM has at the dense rate.
// - Digits once a tile: a tile is 64 rows k1 of one slice k2. Its X arrives
//   by TMA in stages of 16 b3 x 64 rows (128-byte swizzle), two a k32 step;
//   the two warpgroups (one takes the even stages, one the odd) digitise it
//   into a 128 KB cache of A fragments laid out in the order the threads
//   load them: one conflict-free 16-byte load a plane and k32 step. The
//   first N-tile of a tile builds the cache step by step, just before each
//   step's products (a barrier of the two warpgroups a step), so the X loads
//   overlap the products. Fragments rather than swizzled planes: the cache
//   is read 16 times a tile and written once, and the table, the other
//   operand, needs no thread to touch it. For mc > 256 the cache holds a
//   chunk of 256 b3 and is rebuilt for every (N-tile, chunk): the diagonals
//   sum across chunks in the accumulators (right at every mc, slower above
//   256, which the probes do not reach).
// - One thread of the producer warpgroup keeps TMA loads in flight through
//   two rings of two slots: X stages (8 KB) and W stages (32 KB: 8 planes x
//   32 k3 x 128 b3, a 3-D map over [k2 k3][digit][b3] so that each plane
//   lands as a 1024-byte aligned tile of 32 rows), each slot with a `full`
//   mbarrier (the TMA's bytes) and an `empty` one. The A fragments are
//   double-buffered: a step's loads run while the previous step's products
//   do; a W stage is released once its last step's products have completed.
// - Epilogue: the recombination on the accumulators, in 64-bit arithmetic
//   (the 8 folded signed sums as two 54-bit halves); the tile [32 k3][64 k1]
//   goes through shared memory and a TMA store over the 3-D view
//   [mc][m2][cols] (rows k1 >= cols fall outside it and are not written).
//   The second warpgroup goes on to the next N-tile while the first adds the
//   halves and stores.
// - Grid: persistent, min(tiles, SMs) blocks over the m2 x ceil(cols / 64)
//   tiles in order, the tiles of one slice next to each other (the second
//   read of W'[k2] comes from L2); 512 tiles at 2^23 on 132 SMs: 3.88 waves,
//   97 % of the last one full.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "digit_wgmma.cuh"
#include "smem_opt_in.cuh"

namespace {

using namespace digit_wgmma;

__global__ void __launch_bounds__(kThreads, 1)
digit_dft_last_kernel(__grid_constant__ const CUtensorMap tm_w, __grid_constant__ const CUtensorMap tm_x,
                      __grid_constant__ const CUtensorMap tm_out, int mc, int halves, int tiles) {
  body<kXRows, kRecombine>(&tm_w, &tm_x, &tm_out, mc, halves, tiles);
}

}  // namespace

// K11. x: u64 [cols, m2 * mc] = X[k1, (k2, b3)]. wf: int8 [m2, mc, 8, mc] =
// digit d of W'[k2][k3, b3] at [k2][k3][d][b3]. out: u64 [mc, m2 * cols] =
// Y[k3, (k2, k1)], Y[k3, k2, k1] = sum_b3 X[k1, k2, b3] W'[k2][k3, b3] mod p.
// mc a power of two in 32 .. 1024, cols a multiple of 16, m2 <= 65535; every
// pointer 16-byte aligned. Returns the launch's cudaError_t,
// cudaErrorInvalidValue for what it does not take, or cudaErrorNotSupported
// when a tensor map cannot be encoded.
extern "C" int sezkp_digit_dft_last(const void* wf, const void* x, void* out, int cols, int m2, int mc,
                                    void* stream) {
  if (mc < 32 || mc > 1024 || (mc & (mc - 1)) || cols < 16 || cols % 16 || m2 < 1 || m2 > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(wf) || !aligned16(x) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  const int halves = (cols + kRows - 1) / kRows;
  const long long tiles = (long long)m2 * halves;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const cuuint64_t n2 = (cuuint64_t)m2 * mc;
  // W' as [k2 k3][digit][b3], boxes of 32 rows x 1 digit x 128 b3
  const cuuint64_t wdims[3] = {(cuuint64_t)mc, kNdig, n2}, wstr[2] = {(cuuint64_t)mc, (cuuint64_t)kNdig * mc};
  const cuuint32_t wbox[3] = {kWB, 1, kN};
  // X as [cols][m2 mc], boxes of 64 rows x 16 b3
  const cuuint64_t xdims[2] = {n2, (cuuint64_t)cols}, xstr[1] = {n2 * 8};
  const cuuint32_t xbox[2] = {kXB, kRows};
  // Y as [mc][m2][cols], boxes of 32 k3 x 1 k2 x 64 k1
  const cuuint64_t odims[3] = {(cuuint64_t)cols, (cuuint64_t)m2, (cuuint64_t)mc};
  const cuuint64_t ostr[2] = {(cuuint64_t)cols * 8, (cuuint64_t)m2 * cols * 8};
  const cuuint32_t obox[3] = {kRows, 1, kN};
  CUtensorMap tm_w, tm_x, tm_out;
  if (!tensor_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, wf, wdims, wstr, wbox, true) ||
      !tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT64, 2, x, xdims, xstr, xbox, true) ||
      !tensor_map(&tm_out, CU_TENSOR_MAP_DATA_TYPE_UINT64, 3, out, odims, ostr, obox, false))
    return (int)cudaErrorNotSupported;

  cudaError_t err;
  static unsigned long long done = 0;
  if ((err = smem_opt_in(digit_dft_last_kernel, kSmem, done))) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return (int)err;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  digit_dft_last_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(tm_w, tm_x, tm_out, mc, halves,
                                                                         (int)tiles);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a block of K11 takes (bytes), for the reports.
extern "C" int sezkp_digit_dft_last_smem() { return (int)kSmem; }
