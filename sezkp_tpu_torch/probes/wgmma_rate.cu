// The int8 rate of wgmma.mma_async by its N (probes/wgmma_rate.py): no port
// kernel, the measurement behind K11's choice of N = 32 (digit_dft_last.cu).
// One block of two warpgroups an SM, each issuing groups of `kPer` products
// m64nNk32 (A from registers, B from a shared-memory tile through the
// 128-byte-swizzle descriptor) round-robin over `kAcc` independent
// accumulators, a group committed and waited for one behind, as K8 and K11
// do. Every N takes the same int8 operations a group.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_wgmma.cuh"

namespace {

using namespace hopper;

__device__ __forceinline__ void mma16(int* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %13, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, "
      "%12, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma32(int* d, const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n32k32_s8_rs(*reinterpret_cast<int(*)[16]>(d), a, db);
}

__device__ __forceinline__ void mma64(int* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

constexpr int kSmem = 64 * 1024;

template <int N, int kAcc, int kPer>
__global__ void __launch_bounds__(256, 1) rate_kernel(int groups, int* out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < 256 * 128 / 4; i += blockDim.x) reinterpret_cast<int*>(smem)[i] = i * 7;
  __syncthreads();
  int acc[kAcc][N / 2];
#pragma unroll
  for (int d = 0; d < kAcc; ++d)
#pragma unroll
    for (int c = 0; c < N / 2; ++c) acc[d][c] = 0;
  uint32_t a[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[i][c] = threadIdx.x * 3 + i * 5 + c;
  const uint64_t db = desc_k128(smem + (threadIdx.x / 128) * 8192);
  for (int it = 0; it < groups; ++it) {
#pragma unroll
    for (int d = 0; d < kAcc; ++d) fence_regs(acc[d]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const uint64_t dk = db + 2 * (k % 4) + 64 * (k / 8 % 2);
      if constexpr (N == 16) mma16(acc[k % kAcc], a[k % 8], dk);
      if constexpr (N == 32) mma32(acc[k % kAcc], a[k % 8], dk);
      if constexpr (N == 64) mma64(acc[k % kAcc], a[k % 8], dk);
    }
    wgmma_commit();
#pragma unroll
    for (int d = 0; d < kAcc; ++d) fence_regs(acc[d]);
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  int s = 0;
#pragma unroll
  for (int d = 0; d < kAcc; ++d)
#pragma unroll
    for (int c = 0; c < N / 2; ++c) s += acc[d][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int N, int kAcc, int kPer>
int launch(int blocks, int groups, int* out, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(rate_kernel<N, kAcc, kPer>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err) return (int)err;
  rate_kernel<N, kAcc, kPer><<<blocks, 256, kSmem, st>>>(groups, out);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of `blocks` blocks, `groups` groups of products each warpgroup;
// a group is 64 products of N = 16 (15 accumulators, K11's earlier design),
// 32 of N = 32 (8) or 16 of N = 64 (4): 2 * 64 * 16 * 32 * 64 int8
// operations. out: int32 [blocks * 256]. Returns the launch's cudaError_t.
extern "C" int sezkp_wgmma_rate(int n, int blocks, int groups, void* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n == 16) return launch<16, 15, 64>(blocks, groups, (int*)out, st);
  if (n == 32) return launch<32, 8, 32>(blocks, groups, (int*)out, st);
  if (n == 64) return launch<64, 4, 16>(blocks, groups, (int*)out, st);
  return (int)cudaErrorInvalidValue;
}
