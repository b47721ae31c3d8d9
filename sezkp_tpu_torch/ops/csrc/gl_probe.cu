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
PROBE(probe_mul_cc, gl::mul_cc(p, q))
PROBE(probe_add, gl::add(p, q))
PROBE(probe_sub, gl::sub(p, q))
PROBE(probe_neg, gl::neg(p) ^ q)
// mul_pow2 with a compile-time exponent, one of each shift range (n2 = 0 /
// all three parts / n0 = 0): the exponents of the NTT passes are constants
PROBE(probe_mul_pow2_lo, gl::mul_pow2(p, 24) ^ q)
PROBE(probe_mul_pow2_mid, gl::mul_pow2(p, 48) ^ q)
PROBE(probe_mul_pow2_hi, gl::mul_pow2(p, 72) ^ q)

// the butterfly's two outputs folded into one by the xor that probe_base has
extern "C" __global__ void probe_bfly(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                                      uint64_t* y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint64_t s, d;
  gl::bfly(a[i], b[i], s, d);
  y[i] = s ^ d;
}
