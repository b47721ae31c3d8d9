// K13 blake3_chunk_roots: the chunk roots of labeled field columns, and
// optionally their leaf chaining values, in one launch for a whole matrix.
//
// It replaces no Pallas kernel. It replaces the eager composition around K1
// (blake3_torch.chunk_roots_plain): a [16, n] message tensor filled by some
// thirty elementwise operations that splice each value behind its column's
// label prefix, one K1 launch for the leaves, then a gather of the even and
// odd nodes and one K1 launch for each of the L levels of the chunk trees:
// about 51 launches a column (or a 2^21-row segment of one). In the JAX
// package the same composition is blake3_jax.columns_commit_* under jit,
// which XLA fuses.
//
// Function: values u64 [C_all, n] (row stride given, unit column stride),
// a table int32 [C, 18] (column c's label prefix as 16 little-endian words,
// its length in bytes, the row of `values` it commits) -> roots u32
// [C, 8, n >> L] (chunk k's root, word-major per column) and, when `cvs` is
// not null, the leaf CVs u32 [C, 8, n]. A leaf is one BLAKE3 compression of
// prefix || value_le8 (block length len + 8), a parent one of left || right
// (block length 64), both with CHUNK_START|CHUNK_END|ROOT and counter 0:
// blake3_torch's leaves and parent levels, bit for bit.
//
// What bounds it on an H100: one leaf and (2^L - 1) / 2^L parent compressions
// a leaf, 680 integer instructions each, against 8 B read and 32 B of CVs
// written a leaf; the integer rate is the nearer bound, about 6 times the
// bytes' with the CVs written and 28 times without.
// So the design keeps every word of every compression in registers or shared
// memory and does nothing else:
//
// - one block for each (column, chunk) tree (grid: chunks x columns), of
//   T = 256 threads; L is 10 (the columns' chunks) or 11 (the FRI's);
// - thread t owns the leaf pairs p = t + j*T (j < 2^(L-9)): it reads the
//   pair's two values with one 16-byte load (a warp reads 512 contiguous
//   bytes), splices each into the prefix words with funnel shifts in
//   registers (the prefix's length mod 4 gives the shift; all four occur
//   among the labels of tau = 8, the FRI's empty prefix gives 0), hashes both
//   leaves and their parent, stores the two leaf CVs of each word as one
//   8-byte store (consecutive leaves on consecutive words) and the parent in
//   shared memory, word-major [8][2^(L-1)]: 16 KB at L = 10, 32 KB at L = 11;
// - the levels above are reduced in place in shared memory: parent q reads
//   its children 2q and 2q + 1 of each word as one 8-byte load (conflict
//   free), a barrier, then stores itself at q; from 16 parents down warp 0
//   goes on alone under __syncwarp and the other warps have left;
// - thread 0 writes the root.
//
// As in K7, each loop body holds one copy of the seven rounds
// (blake3_round.cuh) and is not unrolled, so the leaves, the pair's parent
// and every level above run the same 680 instructions. A prove launches it
// once for its columns' commitment and once for each chunked FRI layer;
// nothing is allocated here and nothing synchronises.
// blake3_torch.chunk_roots_model is this schedule in tensor code.
#include "blake3_round.cuh"

namespace {

using namespace b3;

constexpr int kTableWords = 18;  // 16 prefix words, prefix length, source row
constexpr int kThreads = 256;    // T above
constexpr uint32_t kFlags = CHUNK_START | CHUNK_END | ROOT;

// One compression of the 16 words m with the IV as chaining value -> cv.
__device__ __forceinline__ void compress(const uint32_t (&m)[16], uint32_t block_len,
                                         uint32_t (&cv)[8]) {
  uint32_t v0 = IV0, v1 = IV1, v2 = IV2, v3 = IV3, v4 = IV4, v5 = IV5, v6 = IV6, v7 = IV7;
  uint32_t v8 = IV0, v9 = IV1, v10 = IV2, v11 = IV3, v12 = 0u, v13 = 0u, v14 = block_len,
           v15 = kFlags;
  B3_SEVEN_ROUNDS();
  cv[0] = v0 ^ v8;
  cv[1] = v1 ^ v9;
  cv[2] = v2 ^ v10;
  cv[3] = v3 ^ v11;
  cv[4] = v4 ^ v12;
  cv[5] = v5 ^ v13;
  cv[6] = v6 ^ v14;
  cv[7] = v7 ^ v15;
}

// m = prefix words with the value x's eight little-endian bytes at byte
// offset 4 * word0 + sh / 8. The words past the prefix are zero, so the value
// lands in words word0 .. word0 + 2 by funnel shifts; word0 is the same for
// the whole block, and the switch keeps every index of m a constant.
__device__ __forceinline__ void splice(uint32_t (&m)[16], const uint32_t* pw, int word0, int sh,
                                       uint64_t x) {
#pragma unroll
  for (int w = 0; w < 16; ++w) m[w] = pw[w];
  const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  const uint32_t a = pw[word0] | (lo << sh);
  const uint32_t b = __funnelshift_l(lo, hi, sh);   // hi when sh = 0
  const uint32_t c = __funnelshift_l(hi, 0u, sh);   // 0 when sh = 0
  switch (word0) {
#define B3_SPLICE_AT(W)                   \
  case W:                                 \
    m[W] = a;                             \
    m[W + 1] = b;                         \
    if (W + 2 < 16) m[(W + 2) & 15] = c;  \
    break;
    B3_SPLICE_AT(0) B3_SPLICE_AT(1) B3_SPLICE_AT(2) B3_SPLICE_AT(3) B3_SPLICE_AT(4)
    B3_SPLICE_AT(5) B3_SPLICE_AT(6) B3_SPLICE_AT(7) B3_SPLICE_AT(8) B3_SPLICE_AT(9)
    B3_SPLICE_AT(10) B3_SPLICE_AT(11) B3_SPLICE_AT(12) B3_SPLICE_AT(13) B3_SPLICE_AT(14)
#undef B3_SPLICE_AT
    default:
      break;
  }
}

// The barrier of the tree's levels: the block's, or warp 0's alone.
template <bool kBlock>
__device__ __forceinline__ void level_sync() {
  if (kBlock) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// One parent of a level of the in-place tree: parent q < h of children 2q,
// 2q + 1 in `level` (every thread calls it; those with q >= h only meet the
// barriers); the root goes to `root` when h is 1. A barrier comes between
// the reads and the writes, and after the writes.
template <int H, bool kBlock>
__device__ __forceinline__ void tree_level(uint32_t (*level)[H], int h, int q, uint32_t* root,
                                           long long root_stride) {
  uint32_t m[16], cv[8];
  const bool act = q < h;
  if (act) {
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const uint2 kids = *reinterpret_cast<const uint2*>(&level[w][2 * q]);
      m[w] = kids.x;
      m[8 + w] = kids.y;
    }
  }
  level_sync<kBlock>();
  if (act) {
    compress(m, 64u, cv);
    if (h == 1) {
#pragma unroll
      for (int w = 0; w < 8; ++w) root[w * root_stride] = cv[w];
    } else {
#pragma unroll
      for (int w = 0; w < 8; ++w) level[w][q] = cv[w];
    }
  }
  level_sync<kBlock>();
}

template <int L>
__global__ void __launch_bounds__(kThreads)
blake3_chunk_roots_kernel(const uint64_t* __restrict__ values, long long row_stride, long long n,
                          const int32_t* __restrict__ table, uint32_t* __restrict__ roots,
                          uint32_t* __restrict__ cvs) {
  static_assert(L == 10 || L == 11, "the columns' chunks and the FRI's");
  constexpr int T = kThreads;
  constexpr int kPairs = 1 << (L - 1);  // level-1 nodes
  constexpr int kPairsPerThread = kPairs / T;

  __shared__ __align__(16) uint32_t level[8][kPairs];
  __shared__ uint32_t pw[16];

  const int t = threadIdx.x;
  const long long k = blockIdx.x;  // chunk
  const int c = blockIdx.y;        // column of the table
  const long long nchunks = n >> L;
  const int32_t* row = table + (long long)c * kTableWords;
  if (t < 16) pw[t] = (uint32_t)row[t];
  const int plen = row[16];
  const int word0 = plen >> 2, sh = (plen & 3) * 8;
  const uint32_t leaf_len = (uint32_t)plen + 8u;
  const uint64_t* src = values + (long long)row[17] * row_stride + (k << L);
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  uint32_t* cv_out = cvs == nullptr ? nullptr : cvs + (long long)c * 8 * n + (k << L);
  __syncthreads();

  // leaves and their parents, a pair at a time
#pragma unroll 1
  for (int j = 0; j < kPairsPerThread; ++j) {
    const int p = t + j * T;
    uint64_t x0, x1;
    if (vec) {
      const ulonglong2 x = *reinterpret_cast<const ulonglong2*>(src + 2 * p);
      x0 = x.x;
      x1 = x.y;
    } else {
      x0 = src[2 * p];
      x1 = src[2 * p + 1];
    }
    uint32_t left[8], right[8];
#pragma unroll 1
    for (int step = 0; step < 3; ++step) {
      uint32_t m[16], cv[8];
      if (step < 2) {
        splice(m, pw, word0, sh, step == 0 ? x0 : x1);
      } else {
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          m[w] = left[w];
          m[8 + w] = right[w];
        }
      }
      compress(m, step < 2 ? leaf_len : 64u, cv);
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        if (step == 0) left[w] = cv[w];
        if (step == 1) right[w] = cv[w];
        if (step == 2) level[w][p] = cv[w];
      }
    }
    if (cv_out != nullptr) {
#pragma unroll
      for (int w = 0; w < 8; ++w)
        *reinterpret_cast<uint2*>(cv_out + w * n + 2 * p) = make_uint2(left[w], right[w]);
    }
  }
  __syncthreads();

  uint32_t* root = roots + (long long)c * 8 * nchunks + k;
  int h = kPairs / 2;
  for (; h >= 32; h >>= 1) {
#pragma unroll 1
    for (int q0 = 0; q0 < h; q0 += T)
      tree_level<kPairs, true>(level, h, q0 + t, root, nchunks);
  }
  if (t >= 32) return;
#pragma unroll 1
  for (; h >= 1; h >>= 1)
    tree_level<kPairs, false>(level, h, t, root, nchunks);
}

template <int L>
int launch(const void* values, long long row_stride, long long n, int cols, const void* table,
           void* roots, void* cvs, cudaStream_t stream) {
  const dim3 grid((unsigned)(n >> L), (unsigned)cols);
  blake3_chunk_roots_kernel<L><<<grid, kThreads, 0, stream>>>(
      (const uint64_t*)values, row_stride, n, (const int32_t*)table, (uint32_t*)roots,
      (uint32_t*)cvs);
  return (int)cudaGetLastError();
}

}  // namespace

// values: u64 [.., n] rows `row_stride` elements apart; table: int32
// [cols, 18]; roots: u32 [cols, 8, n >> chunk_log2]; cvs: u32 [cols, 8, n] or
// null. chunk_log2 10 or 11, n a positive multiple of 2^chunk_log2,
// 1 <= cols <= 65535, each prefix at most 56 bytes.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int sezkp_blake3_chunk_roots(const void* values, long long row_stride, long long n,
                                        int chunk_log2, int cols, const void* table, void* roots,
                                        void* cvs, void* stream) {
  if ((chunk_log2 != 10 && chunk_log2 != 11) || n <= 0 || (n & ((1LL << chunk_log2) - 1)) != 0 ||
      (n >> chunk_log2) > 0x7FFFFFFFLL || cols < 1 || cols > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return chunk_log2 == 10 ? launch<10>(values, row_stride, n, cols, table, roots, cvs, s)
                          : launch<11>(values, row_stride, n, cols, table, roots, cvs, s);
}
