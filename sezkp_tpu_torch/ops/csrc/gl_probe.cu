// One-primitive kernels for counting the machine instructions of the
// Goldilocks primitives in goldilocks.cuh. Not part of the kernel library:
// chip_smoke.py's `sass` phase compiles this file alone, disassembles it and
// subtracts probe_base (same loads, store and indexing, one 64-bit xor) from
// each probe, which leaves the instructions of the primitive itself.
#include <stdint.h>

#include "goldilocks.cuh"

#define PROBE(name, expr)                                                          \
  extern "C" __global__ void name(const uint64_t* __restrict__ a,                  \
                                  const uint64_t* __restrict__ b, uint64_t* y) {   \
    const int i = blockIdx.x * blockDim.x + threadIdx.x;                           \
    const uint64_t p = a[i], q = b[i];                                             \
    y[i] = (expr);                                                                 \
  }

PROBE(probe_base, p ^ q)
PROBE(probe_mul, gl::mul(p, q))
PROBE(probe_add, gl::add(p, q))
PROBE(probe_sub, gl::sub(p, q))
