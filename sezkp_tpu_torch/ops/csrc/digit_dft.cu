// K10 digit_dft and K11 digit_dft_last: one DFT phase Y = W @ X of the
// Goldilocks NTT computed the digit way, on the tensor cores.
//
// K10 replaces the Pallas kernels `k_dots` and `k_dr` of
// scripts/exp_ntt_breakdown.py (the digit-pair products of one phase summed
// by diagonal, ntt_mxu._dot_digits, then either the plain sum of the
// diagonals or the recombination mod p, ntt_mxu._recombine); K11 replaces
// `_last_call_t_folded` of scripts/ntt_twiddle_fold_ab.py (the last phase with
// one table per middle index k2 and the natural-order transposed store).
//
// The arithmetic: every operand is 8 balanced base-256 digits of its signed
// representative, so W @ X over the integers is sum_{i,j} 256^(i+j) W_j @ X_i,
// 64 int8 products with exact int32 sums (|.| <= m 2^14 each), gathered into
// the 15 diagonals s_d = sum_{i+j=d} W_j @ X_i (|s_d| <= 8 m 2^14 <= 2^27 for
// m <= 2^10). The recombination is the canonical value of sum_d s_d 2^(8d)
// mod p: the diagonals d >= 8 fold onto byte positions < 8 with signs
// (2^64 = 2^32 - 1, 2^96 = -1), the positive and the negative parts of the 8
// folded sums are each a number below 2^87 held in 128 bits, reduced with
// 2^64 = 2^32 - 1, and subtracted in the field.
//
// What bounds it on an H100: the operations, 2 * 64 * m MACs per output
// element over the dense int8 tensor-core rate; the bytes (8 per element in
// as digits or as u64, 8 out, the table once) are 5 to 40 times less time at
// m = 128 .. 1024. What the design does about it: one kernel for both, in its
// simple form. Both are the same product once K11 is read as
// Y_k2^T[k3, k1] = sum_b3 W'[k2][k3, b3] X[k1, k2, b3]: the columns of the
// right operand are the k1 rows of the input, whose b3 run is contiguous in
// memory, which is what the instruction wants (contraction index contiguous
// for both operands). A block of four warps owns `bn` columns: it fills shared
// memory once with the 8 digit planes of its columns over the whole
// contraction ([plane][column][k], digitised on the way when the input is
// field elements), then walks down the rows of W in steps of 16 * warps_m,
// staging the 8 digit planes of those rows of the table per k chunk, each
// warp holding the 15 diagonals of a 16 x 16 output tile in registers (120 of
// them) and issuing 128 `mma.sync.m16n8k32` per 32 of k. The epilogue runs on
// the accumulator registers and stores straight to the output, for K11 at
// Y[k3, (k2, k1)], whose flat order is the natural order of the transform.
// No asynchronous copies, no wgmma, one stage.
#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"
#include "i8_mma.cuh"

namespace {

constexpr int kNdig = 8, kDiags = 15;
constexpr int kThreads = 128;
constexpr int kPad = 16;           // bytes added to every shared-memory row (bank spread, keeps 16-byte alignment)
constexpr int kStageBytes = 4096;  // k bytes of the table staged per row group: rows_a * kc

struct Params {
  const int8_t* w;        // table digits: w[slice*w_slice + d*w_dig + row*w_row + k]
  long long w_slice, w_dig, w_row;
  const int8_t* xdig;     // digit stack [8][ncols][m] (k-major), or null
  const uint64_t* x;      // field elements x[slice*x_slice + k*x_k + col*x_col], or null
  long long x_slice, x_k, x_col;
  void* out;              // out[row*o_row + slice*o_slice + col]: u64 (recombine) or int32 (sum)
  long long o_row, o_slice;
  int m;                  // rows of W = contraction length
  long long ncols;
  int bn;                 // columns per block: 16, 32 or 64
  int kc;                 // k chunk of the table stage
  int epilogue;           // 0: sum of the diagonals as int32; 1: recombination, canonical u64
};

// canonical value of v = lo + 2^64 hi, hi < 2^32
__device__ __forceinline__ uint64_t reduce_96(unsigned __int128 v) {
  const uint64_t lo = (uint64_t)v, hi = (uint64_t)(v >> 64);
  return gl::add(gl::canon(lo), hi * gl::EPS);
}

__device__ __forceinline__ uint64_t recombine(const int (&s)[kDiags]) {
  const int sig[kNdig] = {
      s[0] - s[8] - s[12], s[1] - s[9] - s[13], s[2] - s[10] - s[14], s[3] - s[11],
      s[4] + s[8],         s[5] + s[9],         s[6] + s[10],         s[7] + s[11]};
  unsigned __int128 pos = 0, neg = 0;
#pragma unroll
  for (int r = 0; r < kNdig; ++r) {
    pos += (unsigned __int128)(uint32_t)max(sig[r], 0) << (8 * r);
    neg += (unsigned __int128)(uint32_t)max(-sig[r], 0) << (8 * r);
  }
  return gl::sub(reduce_96(pos), reduce_96(neg));
}

__global__ void __launch_bounds__(kThreads)
digit_dft_kernel(const Params p) {
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = p.m, bn = p.bn, kc = p.kc;
  const int warps_n = bn / 16, warps_m = 4 / warps_n;
  const int wn = warp % warps_n, wm = warp / warps_n;
  const int rows_a = 16 * warps_m;
  const int ldx = m + kPad, lda = kc + kPad;
  int8_t* sX = smem;                            // [8][bn][ldx]
  int8_t* sA = smem + (size_t)kNdig * bn * ldx; // [8][rows_a][lda]
  const long long c0 = (long long)blockIdx.x * bn;
  const long long slice = blockIdx.y;

  // ---- the digit planes of this block's columns, over the whole contraction
  if (p.xdig) {
    const int per_col = m / 16;
    for (int idx = tid; idx < kNdig * bn * per_col; idx += kThreads) {
      const int q = idx % per_col, col = (idx / per_col) % bn, d = idx / (per_col * bn);
      const uint4 v = *reinterpret_cast<const uint4*>(
          p.xdig + ((long long)d * p.ncols + c0 + col) * m + 16 * q);
      *reinterpret_cast<uint4*>(sX + ((size_t)d * bn + col) * ldx + 16 * q) = v;
    }
  } else {
    const int kqs = m / 4;
    const bool col_fast = p.x_col == 1;  // neighbouring threads on neighbouring addresses
    for (int idx = tid; idx < bn * kqs; idx += kThreads) {
      const int col = col_fast ? idx % bn : idx / kqs;
      const int kq = col_fast ? idx / bn : idx % kqs;
      const uint64_t* src = p.x + slice * p.x_slice + (long long)(4 * kq) * p.x_k + (c0 + col) * p.x_col;
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint64_t d = i8mma::balanced_digits(src[r * p.x_k]);
        lo[r] = (uint32_t)d;
        hi[r] = (uint32_t)(d >> 32);
      }
      i8mma::transpose4x4(lo);
      i8mma::transpose4x4(hi);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<uint32_t*>(sX + ((size_t)i * bn + col) * ldx + 4 * kq) = lo[i];
        *reinterpret_cast<uint32_t*>(sX + ((size_t)(4 + i) * bn + col) * ldx + 4 * kq) = hi[i];
      }
    }
  }

  const int8_t* wbase = p.w + slice * p.w_slice;
  const int g = lane >> 2, t = lane & 3;
  for (int row0 = 0; row0 < m; row0 += rows_a) {
    int acc[kDiags][2][4];
#pragma unroll
    for (int d = 0; d < kDiags; ++d)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[d][nt][c] = 0;

    for (int k0 = 0; k0 < m; k0 += kc) {
      __syncthreads();  // the previous stage is consumed (first pass: sX is filled)
      const int per_row = kc / 16;
      for (int idx = tid; idx < kNdig * rows_a * per_row; idx += kThreads) {
        const int q = idx % per_row, r = (idx / per_row) % rows_a, d = idx / (per_row * rows_a);
        const uint4 v = *reinterpret_cast<const uint4*>(
            wbase + d * p.w_dig + (long long)(row0 + r) * p.w_row + k0 + 16 * q);
        *reinterpret_cast<uint4*>(sA + ((size_t)d * rows_a + r) * lda + 16 * q) = v;
      }
      __syncthreads();
      for (int ks = 0; ks < kc; ks += 32) {
        uint32_t bf[kNdig][2][2];
#pragma unroll
        for (int i = 0; i < kNdig; ++i)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            i8mma::load_b(bf[i][nt], sX + ((size_t)i * bn + wn * 16 + nt * 8) * ldx + k0 + ks, ldx, lane);
#pragma unroll
        for (int j = 0; j < kNdig; ++j) {
          uint32_t af[4];
          i8mma::load_a(af, sA + ((size_t)j * rows_a + wm * 16) * lda + ks, lda, lane);
#pragma unroll
          for (int i = 0; i < kNdig; ++i)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) i8mma::mma_16x8x32(acc[i + j][nt], af, bf[i][nt]);
        }
      }
    }

    // ---- epilogue on the accumulators: c[0], c[1] are (row g, columns 2t, 2t+1), c[2], c[3] row g+8
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + wm * 16 + g + 8 * h;
        const long long at = row * p.o_row + slice * p.o_slice + c0 + wn * 16 + nt * 8 + 2 * t;
        int s0[kDiags], s1[kDiags];
#pragma unroll
        for (int d = 0; d < kDiags; ++d) {
          s0[d] = acc[d][nt][2 * h];
          s1[d] = acc[d][nt][2 * h + 1];
        }
        if (p.epilogue == 0) {
          int v0 = 0, v1 = 0;
#pragma unroll
          for (int d = 0; d < kDiags; ++d) {
            v0 += s0[d];
            v1 += s1[d];
          }
          *reinterpret_cast<int2*>(static_cast<int*>(p.out) + at) = make_int2(v0, v1);
        } else {
          *reinterpret_cast<ulonglong2*>(static_cast<uint64_t*>(p.out) + at) =
              make_ulonglong2(recombine(s0), recombine(s1));
        }
      }
  }
}

// Columns per block: the largest of 64, 32, 16 that divides ncols and
// keeps the resident digit planes near 72 KB, so that two blocks share an SM
// up to m = 512.
int pick_bn(int m, long long ncols) {
  int bn = 64;
  while (bn > 16 && ((long long)kNdig * bn * (m + kPad) > 74 * 1024 || ncols % bn)) bn >>= 1;
  return bn;
}

int launch(Params p, long long slices, cudaStream_t stream) {
  const int m = p.m;
  if (m < 32 || m > 1024 || (m & (m - 1)) || p.ncols < 16 || p.ncols % 16 || slices < 1 ||
      slices > 65535 || (p.epilogue != 0 && p.epilogue != 1))
    return (int)cudaErrorInvalidValue;
  p.bn = pick_bn(m, p.ncols);
  if (p.ncols % p.bn || p.ncols / p.bn > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int rows_a = 16 * (4 / (p.bn / 16));
  if (rows_a > m) return (int)cudaErrorInvalidValue;
  p.kc = min(m, kStageBytes / rows_a);
  const size_t smem = (size_t)kNdig * p.bn * (m + kPad) + (size_t)kNdig * rows_a * (p.kc + kPad);
  cudaError_t e = cudaFuncSetAttribute(digit_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)(p.ncols / p.bn), (unsigned)slices);
  digit_dft_kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// K10. Y[m, other] = W @ X along axis 0. w: int8 [8 * m, m], digit plane d of
// W in rows d*m .. (W symmetric). Exactly one of xdig (int8 [8, other, m], the
// k-major stack K9 writes) and x (u64 [m, other]) is non-null. out: int32
// [m, other] (epilogue 0) or u64 [m, other] (epilogue 1). m a power of two in
// 32 .. 1024, other a multiple of 16. Returns the launch's cudaError_t, or
// cudaErrorInvalidValue for what it does not take.
extern "C" int sezkp_digit_dft(const void* w, const void* xdig, const void* x, void* out, int m,
                               long long other, int epilogue, void* stream) {
  if ((xdig == nullptr) == (x == nullptr)) return (int)cudaErrorInvalidValue;
  Params p{};
  p.w = (const int8_t*)w;
  p.w_slice = 0;
  p.w_dig = (long long)m * m;
  p.w_row = m;
  p.xdig = (const int8_t*)xdig;
  p.x = (const uint64_t*)x;
  p.x_slice = 0;
  p.x_k = other;
  p.x_col = 1;
  p.out = out;
  p.o_row = other;
  p.o_slice = 0;
  p.m = m;
  p.ncols = other;
  p.epilogue = epilogue;
  return launch(p, 1, (cudaStream_t)stream);
}

// K11. x: u64 [cols, m2 * mc] = X[k1, (k2, b3)]. wf: int8 [m2, mc, 8, mc] =
// digit d of W'[k2][k3, b3] at [k2][k3][d][b3]. out: u64 [mc, m2 * cols] =
// Y[k3, (k2, k1)], Y[k3, k2, k1] = sum_b3 X[k1, k2, b3] W'[k2][k3, b3] mod p.
// mc a power of two in 32 .. 1024, cols a multiple of 16, m2 <= 65535.
extern "C" int sezkp_digit_dft_last(const void* wf, const void* x, void* out, int cols, int m2,
                                    int mc, void* stream) {
  Params p{};
  p.w = (const int8_t*)wf;
  p.w_slice = (long long)mc * kNdig * mc;
  p.w_dig = mc;
  p.w_row = (long long)kNdig * mc;
  p.xdig = nullptr;
  p.x = (const uint64_t*)x;
  p.x_slice = mc;
  p.x_k = 1;
  p.x_col = (long long)m2 * mc;
  p.out = out;
  p.o_row = (long long)m2 * cols;
  p.o_slice = cols;
  p.m = mc;
  p.ncols = cols;
  p.epilogue = 1;
  return launch(p, m2, (cudaStream_t)stream);
}
