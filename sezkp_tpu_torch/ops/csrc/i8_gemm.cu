// K8 i8_gemm: out[M, N] = epilogue(sum_j W_j[M, K] @ X[K, N]), int8 operands,
// int32 accumulation on the tensor cores.
//
// It replaces the three Pallas kernels of scripts/exp_mxu_peak.py, the probe
// of the matrix unit's int8 rate: `dots_kernel(nrep, tile, fuse)` (nrep
// stacked weight blocks whose products are summed), the single product
// W[mm, mm] @ X[mm, tile] with int32 output, and the same product stored as
// (p & 127) int8. W is [nrep * M, K] row-major (block j = rows j*M ..), X is
// [K, N] row-major, as the probe lays them out.
//
// What bounds it on an H100: the operations, 2 * nrep * M * K * N over the
// dense int8 tensor-core rate, ahead of the bytes (X once, W once, the output
// once) at every shape the probe uses. What the design does about it: not
// much yet. A block of four warps owns a 64 x 64 output tile; per 64-deep k
// chunk it stages a 64 x 64 tile of W_j and of X in shared memory (X is
// byte-transposed on the way, 4 x 4 bytes at a time in registers, because the
// instruction wants k contiguous per column and X has N contiguous), then
// every warp runs 2 x 4 `mma.sync.m16n8k32` tiles over it. One stage, two
// barriers per chunk, no asynchronous copy, no wgmma. Blocks that share a
// column tile of X are neighbours in the grid, so X is read from device
// memory about once and from L2 the other M / 64 - 1 times.
//
// `fuse` chooses the loop order over (j, k chunk), which changes no integer:
// 0 runs the nrep products one after the other (X staged anew for each), 1
// runs one product over the stacked weights (each X chunk staged once and
// used by all nrep row blocks), as the probe's `fuse` flag does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "i8_mma.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kKC = 64;
constexpr int kLd = kKC + 16;  // 80-byte rows: the 8 rows of a fragment fall in 8 different bank groups
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
i8_gemm_kernel(const int8_t* __restrict__ w, const int8_t* __restrict__ x, void* __restrict__ out,
               int M, int K, long long N, int nrep, int fuse, int epilogue, int mtiles) {
  __shared__ __align__(16) int8_t sA[kBM * kLd];
  __shared__ __align__(16) int8_t sB[kBN * kLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int row0 = (int)(blockIdx.x % mtiles) * kBM;
  const long long col0 = (long long)(blockIdx.x / mtiles) * kBN;
  const int kchunks = K / kKC;

  int acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

  const int steps = nrep * kchunks;
  for (int s = 0; s < steps; ++s) {
    const int j = fuse ? s % nrep : s / kchunks;
    const int kc = fuse ? s / nrep : s % kchunks;
    // stage W_j[row0 .. +64, kc*64 .. +64]: 64 rows of 64 bytes, 16 bytes a load
    for (int idx = tid; idx < kBM * (kKC / 16); idx += kThreads) {
      const int r = idx / (kKC / 16), q = idx % (kKC / 16);
      const uint4 v = *reinterpret_cast<const uint4*>(
          w + ((long long)j * M + row0 + r) * K + (long long)kc * kKC + 16 * q);
      *reinterpret_cast<uint4*>(sA + r * kLd + 16 * q) = v;
    }
    // stage X[kc*64 .. +64, col0 .. +64] transposed to [column][k]; one X
    // chunk serves all nrep row blocks when fused
    if (!fuse || j == 0) {
      for (int idx = tid; idx < (kKC / 4) * (kBN / 4); idx += kThreads) {
        const int nq = idx % (kBN / 4), kq = idx / (kBN / 4);
        uint32_t r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = *reinterpret_cast<const uint32_t*>(
              x + ((long long)kc * kKC + 4 * kq + i) * N + col0 + 4 * nq);
        i8mma::transpose4x4(r);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<uint32_t*>(sB + (4 * nq + i) * kLd + 4 * kq) = r[i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 32) {
      uint32_t bf[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        i8mma::load_b(bf[ni], sB + (wn * 32 + ni * 8) * kLd + ks, kLd, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t af[4];
        i8mma::load_a(af, sA + (wm * 32 + mi * 16) * kLd + ks, kLd, lane);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) i8mma::mma_16x8x32(acc[mi][ni], af, bf[ni]);
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + wm * 32 + mi * 16 + g + 8 * h;
        const long long col = col0 + wn * 32 + ni * 8 + 2 * t;
        const int p0 = acc[mi][ni][2 * h], p1 = acc[mi][ni][2 * h + 1];
        if (epilogue == 0) {
          *reinterpret_cast<int2*>(static_cast<int*>(out) + row * N + col) = make_int2(p0, p1);
        } else {
          *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + row * N + col) =
              make_char2((signed char)(p0 & 127), (signed char)(p1 & 127));
        }
      }
}

}  // namespace

// w int8 [nrep * M, K], x int8 [K, N], out int32 [M, N] (epilogue 0) or int8
// [M, N] holding (p & 127) (epilogue 1). M, K and N are multiples of 64.
// Returns the launch's cudaError_t, or cudaErrorInvalidValue for shapes it
// does not take.
extern "C" int sezkp_i8_gemm(const void* w, const void* x, void* out, int M, int K, long long N,
                             int nrep, int fuse, int epilogue, void* stream) {
  if (M < kBM || K < kKC || N < kBN || M % kBM || K % kKC || N % kBN || nrep < 1 ||
      (epilogue != 0 && epilogue != 1))
    return (int)cudaErrorInvalidValue;
  const int mtiles = M / kBM;
  const long long blocks = (long long)mtiles * (N / kBN);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  i8_gemm_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)w, (const int8_t*)x, out, M, K, N, nrep, fuse ? 1 : 0, epilogue, mtiles);
  return (int)cudaGetLastError();
}
