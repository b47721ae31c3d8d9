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
// What bounds it on an H100: the int8 operations (2 nrep M K N over the dense
// 1979 TOPS) or the bytes (W, X and the output once each; at
// [1024, 1024] @ [1024, 2^20] the 4 GB int32 output alone is 1.28 ms at
// 3.35 TB/s). chip_smoke.py computes both.
//
// The design, Hopper's GEMM shape on the swapped product out^T = X^T W^T:
// - wgmma with 8-bit operands takes both of them K-major, and X has N
//   contiguous. So X^T is the A operand, taken from registers: each consumer
//   thread builds its fragments from the TMA-loaded X tile [128 k][128 n]
//   with 16-bit shared-memory reads (two neighbouring n, one k) and byte
//   permutes. The thread's fragment rows g and g + 8 are the neighbouring
//   columns n = 2g and 2g + 1 (a fixed permutation of n inside the tile,
//   which the epilogue undoes); the four k rows of a read are taken in an
//   order rotated by the lane's q, which puts them in four different banks
//   of the swizzled tile, and one permute rotates the bytes back. W^T is the
//   B operand, straight from a TMA tile of W [256 m][128 k].
// - The kernel is persistent: one block an SM walks the output tiles of
//   256 m x 128 n, the M tiles of one column tile next to each other, so X
//   is read from memory about once and W stays in L2.
// - One thread of the producer warpgroup keeps TMA loads (128-byte swizzle;
//   out-of-bounds elements read as zeros) in flight through two rings of
//   three shared-memory stages, W tiles and X tiles, each slot with a `full`
//   mbarrier (the TMA's bytes) and an `empty` one (the consumers' release).
//   The producer warpgroup gives its registers to the consumers (setmaxnreg
//   40 / 232).
// - Two consumer warpgroups take 64 n each (all 256 m:
//   wgmma.m64n256k32.s32.s8.s8, four a 128-byte k chunk, 128 accumulator
//   registers a thread). The fragments are double-buffered: the next k
//   chunk's are built while the current chunk's products run. An X stage is
//   released as soon as its fragments are in registers; a W stage when the
//   chunk's products have completed (wgmma.wait_group 1 after the next
//   chunk's are issued). The int32 sums wrap mod 2^32: no .satfinite.
// - The epilogue writes each warpgroup's tile back as out[m][n] into shared
//   memory (int32 in the 128-byte swizzled layout), in rounds of 128 m, and
//   stores it with TMA (the box is clipped at the tensor's edge), so one
//   tile's stores overlap the next tile's loads and products; the buffer is
//   written again only when the previous store has read it.
// What bounds it in this shape is shared memory's bandwidth more than the
// tensor cores: a k chunk's TMA fills (48 KB), the wgmma reads of the W tile
// by both warpgroups (64 KB) and the fragment reads (16 KB, conflict-free)
// come to about 1.1 times the chunk's products at the dense rate (128 bytes
// a clock an SM against 8192 int8 operations).
//
// `fuse` chooses the loop order over (j, k chunk), which changes no integer:
// 0 runs the nrep products one after the other (an X tile loaded for each),
// 1 runs k chunks outside and j inside, so one set of X fragments serves all
// nrep W_j tiles, as the probe's `fuse` flag does.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "smem_opt_in.cuh"
#include "tma_wgmma.cuh"

namespace {

using namespace hopper;

template <int B>
using Buf = std::integral_constant<int, B>;  // a compile-time fragment buffer index

constexpr int kBM = 256, kBN = 128, kBK = 128;  // output tile (m, n), k chunk (bytes)
constexpr int kStagesW = 3, kStagesX = 3;
constexpr int kWBytes = kBM * kBK;               // a W stage: 32 KB
constexpr int kXBytes = kBK * kBN;               // an X stage: 16 KB
constexpr int kConsumers = 2;                     // warpgroups of 64 n
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kEpiRows = 128;                     // m rows a round of the epilogue stores
constexpr int kEpiBytes = kEpiRows * 64 * 4;      // a round of a warpgroup's int32 tile: 32 KB
constexpr int kBarBytes = 2 * (kStagesW + kStagesX) * 8;
constexpr size_t kSmem = 1024 + kStagesW * kWBytes + kStagesX * kXBytes + kConsumers * kEpiBytes + kBarBytes;

__global__ void __launch_bounds__(kThreads, 1)
i8_gemm_kernel(__grid_constant__ const CUtensorMap tm_w, __grid_constant__ const CUtensorMap tm_x,
               __grid_constant__ const CUtensorMap tm_out, int M, int K, long long N, int nrep, int fuse,
               int epilogue, int mtiles, long long ntiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sW = smem;
  unsigned char* sX = sW + kStagesW * kWBytes;
  unsigned char* sE = sX + kStagesX * kXBytes;
  uint64_t* full_w = reinterpret_cast<uint64_t*>(sE + kConsumers * kEpiBytes);
  uint64_t* empty_w = full_w + kStagesW;
  uint64_t* full_x = empty_w + kStagesW;
  uint64_t* empty_x = full_x + kStagesX;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesW; ++s) {
      mbar_init(full_w + s, 1);
      mbar_init(empty_w + s, kConsumers * 4);  // lane 0 of every consumer warp
    }
    for (int s = 0; s < kStagesX; ++s) {
      mbar_init(full_x + s, 1);
      mbar_init(empty_x + s, kConsumers * 128);  // every consumer thread, once its reads are done
    }
    fence_mbar_init();
  }
  __syncthreads();
  const int kchunks = (K + kBK - 1) / kBK;
  const int steps = nrep * kchunks;

  if (warp >= kConsumers * 4) {
    // ---- producer warpgroup: gives its registers to the consumers; one
    // thread issues every TMA load
    setmaxnreg_dec<40>();
    if (warp == kConsumers * 4 && lane == 0) {
      int iw = 0, ix = 0;
      uint32_t pw = 0, px = 0;
      for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = (int)(tile % mtiles) * kBM;
        const int n0 = (int)(tile / mtiles) * kBN;
        for (int s = 0; s < steps; ++s) {
          const int j = fuse ? s % nrep : s / kchunks;
          const int kc = fuse ? s / nrep : s % kchunks;
          if (!fuse || j == 0) {
            mbar_wait(empty_x + ix, px ^ 1);
            mbar_expect_tx(full_x + ix, kXBytes);
            tma_load_2d(sX + ix * kXBytes, &tm_x, full_x + ix, n0, kc * kBK);
            if (++ix == kStagesX) ix = 0, px ^= 1;
          }
          mbar_wait(empty_w + iw, pw ^ 1);
          mbar_expect_tx(full_w + iw, kWBytes);
          tma_load_2d(sW + iw * kWBytes, &tm_w, full_w + iw, kc * kBK, j * M + m0);
          if (++iw == kStagesW) iw = 0, pw ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes n = 64 wg .. 64 wg + 63 of the tile
    setmaxnreg_inc<232>();
    const int wg = warp / 4, w4 = warp % 4, g = lane / 4, q4 = lane % 4;
    const bool leader = threadIdx.x % 128 == 0;
    unsigned char* epi = sE + wg * kEpiBytes;
    // the thread's two columns n, 2g and 2g + 1 of its warp's 16: 16-byte unit
    // and offset in a 128-byte row of the X tile; `rot` puts byte c of a
    // fragment word at position c (its reads come in the order c = (i + q) % 4)
    const int xunit = 4 * wg + w4, xoff = 2 * g;
    uint32_t rot = 0;
    for (int c = 0; c < 4; ++c) rot |= (uint32_t)((c - q4) & 3) << (4 * c);
    // W steps a set of fragments serves, sets of fragments a tile
    const int G = fuse ? nrep : 1, F = steps / G;
    int iw = 0, ix = 0, prev_w = -1;
    uint32_t pw = 0, px = 0;
    int acc[128];
    uint32_t fr[2][kBK / 32][4];  // the A fragments of a k chunk, double-buffered

    // fr[b] <- the next X tile [k][n]; the stage is released when the reads are done
    auto build = [&](auto bb) {
      constexpr int b = decltype(bb)::value;
      mbar_wait(full_x + ix, px);
      const unsigned char* xs = sX + ix * kXBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = 32 * kk + 16 * hh + 4 * q4 + ((i + q4) & 3);
            v[i] = *reinterpret_cast<const uint16_t*>(xs + k * 128 + ((xunit ^ (k & 7)) << 4) + xoff);
          }
          const uint32_t t01 = __byte_perm(v[0], v[1], 0x5140), t23 = __byte_perm(v[2], v[3], 0x5140);
          fr[b][kk][2 * hh] = __byte_perm(__byte_perm(t01, t23, 0x5410), 0, rot);      // column 2g
          fr[b][kk][2 * hh + 1] = __byte_perm(__byte_perm(t01, t23, 0x7632), 0, rot);  // column 2g + 1
        }
      }
      mbar_arrive(empty_x + ix);
      if (++ix == kStagesX) ix = 0, px ^= 1;
    };
    // the G steps of fragment set f, from fr[b]; the next set is built into
    // fr[1 - b] while the last step's products run
    auto group = [&](auto bb, int f) {
      constexpr int b = decltype(bb)::value;
      for (int jj = 0; jj < G; ++jj) {
        mbar_wait(full_w + iw, pw);
        const uint64_t db = desc_k128(sW + iw * kWBytes);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) wgmma_m64n256k32_s8_rs(acc, fr[b][kk], db + 2 * kk);
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<1>();  // the previous step's products are done: release its W stage
        if (lane == 0 && prev_w >= 0) mbar_arrive(empty_w + prev_w);
        prev_w = iw;
        if (++iw == kStagesW) iw = 0, pw ^= 1;
        if (jj == G - 1 && f + 1 < F) build(Buf<1 - b>{});
      }
    };

    for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int m0 = (int)(tile % mtiles) * kBM;
      const long long n0 = (tile / mtiles) * kBN;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0;
      build(Buf<0>{});
      for (int f = 0; f < F; f += 2) {
        group(Buf<0>{}, f);
        if (f + 1 < F) group(Buf<1>{}, f + 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty_w + prev_w);
      prev_w = -1;

      // ---- epilogue: D^T[n][m] in registers -> out[m][n] in shared memory ->
      // TMA store, in rounds of kEpiRows m. Thread (w4, g, q4) holds, for
      // i < 32, D^T at n = 16 w4 + 2g + h (h = 0 in acc[4i], acc[4i + 1]; h = 1
      // in acc[4i + 2], acc[4i + 3]) and m = 8i + 2q4 (+ 1 in the odd ones).
      const long long ncol = n0 + 64 * wg;
#pragma unroll
      for (int hf = 0; hf < kBM / kEpiRows; ++hf) {
        constexpr int I = kEpiRows / 8;  // values of i a round
        const int row0 = m0 + kEpiRows * hf;
        if (leader) tma_store_wait_read();  // the previous store has read the buffer
        named_sync(1 + wg, 128);
        if (epilogue == 0) {
          // two boxes of kEpiRows m x 32 int32 n (128 B a row), box c = w4 / 2;
          // 16-byte unit u of row r at ((u ^ (r % 8)) * 16)
          unsigned char* box = epi + (w4 >> 1) * kEpiRows * 128;
          const int u = 4 * (w4 & 1) + (g >> 1), off = 8 * (g & 1);
#pragma unroll
          for (int i = I * hf; i < I * hf + I; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = 8 * (i - I * hf) + 2 * q4 + e;
              *reinterpret_cast<int2*>(box + r * 128 + ((u ^ (r & 7)) << 4) + off) =
                  make_int2(acc[4 * i + e], acc[4 * i + 2 + e]);
            }
          }
        } else {
          // one box of kEpiRows m x 64 int8 n, unswizzled
#pragma unroll
          for (int i = I * hf; i < I * hf + I; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = 8 * (i - I * hf) + 2 * q4 + e;
              *reinterpret_cast<char2*>(epi + r * 64 + 16 * w4 + 2 * g) =
                  make_char2((signed char)(acc[4 * i + e] & 127), (signed char)(acc[4 * i + 2 + e] & 127));
            }
          }
        }
        fence_proxy_async();
        named_sync(1 + wg, 128);
        if (leader && row0 < M && ncol < N) {
          if (epilogue == 0) {
            tma_store_2d(&tm_out, epi, (int)ncol, row0);
            tma_store_2d(&tm_out, epi + kEpiRows * 128, (int)ncol + 32, row0);
          } else {
            tma_store_2d(&tm_out, epi, (int)ncol, row0);
          }
          tma_store_commit();
        }
      }
    }
    if (leader) tma_store_wait();
  }
}

// a row-major [rows, cols] matrix of `elem`-byte elements, boxes of
// box_rows x box_cols, with the 128-byte swizzle or none, zeros outside
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base, uint64_t rows,
              uint64_t cols, uint32_t box_cols, uint32_t box_rows, bool swizzle) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  return tensor_map(map, type, 2, base, dims, strides, box, swizzle);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// w int8 [nrep * M, K], x int8 [K, N], out int32 [M, N] (epilogue 0) or int8
// [M, N] holding (p & 127) (epilogue 1). M, K and N are multiples of 64; every
// pointer is 16-byte aligned. Returns the first failing launch's cudaError_t, cudaErrorInvalidValue
// for what it does not take, or cudaErrorNotSupported when a tensor map cannot
// be encoded.
extern "C" int sezkp_i8_gemm(const void* w, const void* x, void* out, int M, int K, long long N,
                             int nrep, int fuse, int epilogue, void* stream) {
  if (M < 64 || K < 64 || N < 64 || M % 64 || K % 64 || N % 64 || nrep < 1 || (epilogue != 0 && epilogue != 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)nrep * M > 0x7FFFFFFFLL || N > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (!aligned16(w) || !aligned16(x) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap tm_w, tm_x, tm_out;
  const bool ok =
      make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, (uint64_t)nrep * M, K, kBK, kBM, true) &&
      make_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, K, N, kBN, kBK, true) &&
      (epilogue == 0 ? make_map(&tm_out, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, out, M, N, 32, kEpiRows, true)
                     : make_map(&tm_out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, out, M, N, 64, kEpiRows, false));
  if (!ok) return (int)cudaErrorNotSupported;

  cudaError_t err;
  static unsigned long long done = 0;
  if ((err = smem_opt_in(i8_gemm_kernel, kSmem, done))) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return (int)err;
  const int mtiles = (M + kBM - 1) / kBM;
  const long long ntiles = (long long)mtiles * ((N + kBN - 1) / kBN);
  const unsigned grid = (unsigned)(ntiles < sms ? ntiles : sms);
  i8_gemm_kernel<<<grid, kThreads, kSmem, st>>>(tm_w, tm_x, tm_out, M, K, N, nrep, fuse ? 1 : 0, epilogue,
                                                mtiles, ntiles);
  return (int)cudaGetLastError();
}
