// K1 blake3_compress: batched single-block BLAKE3 compression.
//
// Replaces the Pallas kernel of sezkp_tpu/ops/blake3_pallas.py (_build,
// compress_planes). Same function: uint32 [16, N] word-major message planes
// -> [8, N] (chaining value / digest) or [16, N] (first XOF block); counter 0;
// block_len and flags are the same for every message of a launch.
//
// Hopper design: one thread per message. The 16 state words and 16 message
// words live in registers; the 7 rounds are unrolled with the message
// schedule written out as constants, so there is no indexed register access.
// Word-major planes make thread i read address w*N + i: a warp reads 128
// contiguous bytes per word. A ragged N is masked here, there is no padding
// pass. Per message: 64 B read, 32 B (or 64 B) written, about 680 32-bit
// integer instructions (three-input adds, funnel-shift rotates) -- on this
// card the integer rate, not the memory, is the nearer bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

#define B3_G(a, b, c, d, mx, my) \
  do {                           \
    a = a + b + (mx);            \
    d = rotr(d ^ a, 16);         \
    c = c + d;                   \
    b = rotr(b ^ c, 12);         \
    a = a + b + (my);            \
    d = rotr(d ^ a, 8);          \
    c = c + d;                   \
    b = rotr(b ^ c, 7);          \
  } while (0)

#define B3_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  do {                                                                                  \
    B3_G(v0, v4, v8, v12, m[s0], m[s1]);                                                \
    B3_G(v1, v5, v9, v13, m[s2], m[s3]);                                                \
    B3_G(v2, v6, v10, v14, m[s4], m[s5]);                                               \
    B3_G(v3, v7, v11, v15, m[s6], m[s7]);                                               \
    B3_G(v0, v5, v10, v15, m[s8], m[s9]);                                               \
    B3_G(v1, v6, v11, v12, m[s10], m[s11]);                                             \
    B3_G(v2, v7, v8, v13, m[s12], m[s13]);                                              \
    B3_G(v3, v4, v9, v14, m[s14], m[s15]);                                              \
  } while (0)

constexpr uint32_t IV0 = 0x6A09E667u, IV1 = 0xBB67AE85u, IV2 = 0x3C6EF372u, IV3 = 0xA54FF53Au;
constexpr uint32_t IV4 = 0x510E527Fu, IV5 = 0x9B05688Cu, IV6 = 0x1F83D9ABu, IV7 = 0x5BE0CD19u;

__global__ void __launch_bounds__(256)
blake3_compress_kernel(const uint32_t* __restrict__ msg, uint32_t* __restrict__ out,
                       long long n, uint32_t block_len, uint32_t flags, int out_words) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t m[16];
#pragma unroll
  for (int w = 0; w < 16; ++w) m[w] = msg[(long long)w * n + i];

  uint32_t v0 = IV0, v1 = IV1, v2 = IV2, v3 = IV3, v4 = IV4, v5 = IV5, v6 = IV6, v7 = IV7;
  uint32_t v8 = IV0, v9 = IV1, v10 = IV2, v11 = IV3, v12 = 0u, v13 = 0u, v14 = block_len, v15 = flags;

  // message schedule: round r uses MSG_PERM applied r times to 0..15
  B3_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  B3_ROUND(2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8);
  B3_ROUND(3, 4, 10, 12, 13, 2, 7, 14, 6, 5, 9, 0, 11, 15, 8, 1);
  B3_ROUND(10, 7, 12, 9, 14, 3, 13, 15, 4, 0, 11, 2, 5, 8, 1, 6);
  B3_ROUND(12, 13, 9, 11, 15, 10, 14, 8, 7, 2, 5, 3, 0, 1, 6, 4);
  B3_ROUND(9, 14, 11, 5, 8, 12, 15, 1, 13, 3, 0, 10, 2, 6, 4, 7);
  B3_ROUND(11, 15, 5, 0, 1, 9, 8, 6, 14, 10, 2, 12, 3, 4, 7, 13);

  out[0 * n + i] = v0 ^ v8;
  out[1 * n + i] = v1 ^ v9;
  out[2 * n + i] = v2 ^ v10;
  out[3 * n + i] = v3 ^ v11;
  out[4 * n + i] = v4 ^ v12;
  out[5 * n + i] = v5 ^ v13;
  out[6 * n + i] = v6 ^ v14;
  out[7 * n + i] = v7 ^ v15;
  if (out_words == 16) {
    out[8 * n + i] = v8 ^ IV0;
    out[9 * n + i] = v9 ^ IV1;
    out[10 * n + i] = v10 ^ IV2;
    out[11 * n + i] = v11 ^ IV3;
    out[12 * n + i] = v12 ^ IV4;
    out[13 * n + i] = v13 ^ IV5;
    out[14 * n + i] = v14 ^ IV6;
    out[15 * n + i] = v15 ^ IV7;
  }
}

}  // namespace

// msg: uint32 [16, n]; out: uint32 [out_words, n], out_words 8 or 16.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int sezkp_blake3_compress(const void* msg, void* out, long long n, int block_len,
                                     int flags, int out_words, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  blake3_compress_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)msg, (uint32_t*)out, n, (uint32_t)block_len, (uint32_t)flags, out_words);
  return (int)cudaGetLastError();
}
