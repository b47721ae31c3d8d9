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
// card the integer rate, not the memory, is the nearer bound. The rounds are
// those of blake3_round.cuh, which K7 blake3_chain shares.
#include "blake3_round.cuh"

namespace {

using namespace b3;

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

  B3_SEVEN_ROUNDS();

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
