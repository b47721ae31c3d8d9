// K7 blake3_chain: batched single-chunk, multi-block BLAKE3 of N messages of
// one length (1 .. 1024 bytes).
//
// Replaces the Pallas kernel of sezkp_tpu/ops/blake3_pallas.py (_build_chain,
// entry hash_many_words). Same function: uint32 [nblocks*16, N] word-major
// planes of the zero-padded messages (little-endian words) plus the true byte
// length -> [8, N] digest words. Block 0 carries CHUNK_START, the last block
// CHUNK_END|ROOT and the length of its tail, every other block length 64;
// counter 0; the chaining value of block b is the input of block b + 1.
//
// Hopper design: one thread per message and a run-time loop over the blocks.
// The chaining value stays in eight registers between blocks, so a message
// costs one read of its padded words and one 32-byte write, whatever its
// length; each block's sixteen words are loaded as K1 loads them (thread i
// reads address w*N + i: 128 contiguous bytes per warp and word). The rounds
// are those of blake3_round.cuh, shared with K1. The block loop is not
// unrolled: one copy of the seven rounds serves every length, so there is one
// kernel and no per-length program. A ragged N is masked here. Per message
// and block: 64 B read and one compression (the same integer instructions as
// K1); the integer rate is the nearer bound from two blocks up, and at the
// batch sizes of a fold prove (some 10^4 messages) the launch itself costs
// more than either.
#include "blake3_round.cuh"

namespace {

using namespace b3;

__global__ void __launch_bounds__(256)
blake3_chain_kernel(const uint32_t* __restrict__ msg, uint32_t* __restrict__ out,
                    long long n, int nblocks, uint32_t last_len) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t h0 = IV0, h1 = IV1, h2 = IV2, h3 = IV3, h4 = IV4, h5 = IV5, h6 = IV6, h7 = IV7;
  const uint32_t* p = msg + i;

#pragma unroll 1
  for (int b = 0; b < nblocks; ++b) {
    uint32_t m[16];
#pragma unroll
    for (int w = 0; w < 16; ++w) m[w] = p[(long long)w * n];
    p += 16 * n;

    const bool last = (b == nblocks - 1);
    const uint32_t flags = (b == 0 ? CHUNK_START : 0u) | (last ? (CHUNK_END | ROOT) : 0u);
    uint32_t v0 = h0, v1 = h1, v2 = h2, v3 = h3, v4 = h4, v5 = h5, v6 = h6, v7 = h7;
    uint32_t v8 = IV0, v9 = IV1, v10 = IV2, v11 = IV3, v12 = 0u, v13 = 0u;
    uint32_t v14 = last ? last_len : 64u, v15 = flags;

    B3_SEVEN_ROUNDS();

    h0 = v0 ^ v8;
    h1 = v1 ^ v9;
    h2 = v2 ^ v10;
    h3 = v3 ^ v11;
    h4 = v4 ^ v12;
    h5 = v5 ^ v13;
    h6 = v6 ^ v14;
    h7 = v7 ^ v15;
  }

  out[0 * n + i] = h0;
  out[1 * n + i] = h1;
  out[2 * n + i] = h2;
  out[3 * n + i] = h3;
  out[4 * n + i] = h4;
  out[5 * n + i] = h5;
  out[6 * n + i] = h6;
  out[7 * n + i] = h7;
}

}  // namespace

// msg: uint32 [nblocks*16, n]; out: uint32 [8, n]; 1 <= nblocks <= 16;
// last_len: bytes of the message in its last block, 1 .. 64.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int sezkp_blake3_chain(const void* msg, void* out, long long n, int nblocks,
                                  int last_len, void* stream) {
  if (n <= 0) return 0;
  if (nblocks < 1 || nblocks > 16 || last_len < 1 || last_len > 64) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  blake3_chain_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)msg, (uint32_t*)out, n, nblocks, (uint32_t)last_len);
  return (int)cudaGetLastError();
}
