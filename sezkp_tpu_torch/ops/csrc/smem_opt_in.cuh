// Dynamic shared memory above the 48 KB default needs the kernel's opt-in.
// Shared by the kernels that take more (ntt_phases.cu, ntt_last.cu,
// i8_gemm.cu).
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>

// Opt `kernel` in to `bytes` of dynamic shared memory, once per kernel and
// device (`done`: one bit a device), so that no launch after the first, and
// none captured into a CUDA graph, makes the call.
template <class K>
cudaError_t smem_opt_in(K kernel, size_t bytes, unsigned long long& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (!err) done |= bit;
  return err;
}
