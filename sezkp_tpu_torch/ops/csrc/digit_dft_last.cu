// K11 digit_dft_last: the last phase of the three-factor Goldilocks NTT, with
// the middle twiddle folded into one table per middle index k2, computed the
// digit way on the tensor cores with TMA loads and wgmma.
//
// It replaces `_last_call_t_folded` of scripts/ntt_twiddle_fold_ab.py (the
// pl.pallas_call at :101): for every k2 < m2,
//   Y[k3, k2 cols + k1] = sum_b3 X[k1, k2 mc + b3] W'[k2][k3, b3] mod p,
// X field elements u64 [cols, m2 mc], W' the int8 digit table
// [m2][mc k3][8 digits][mc b3] (ntt_digits_torch.folded_table), Y u64
// [mc, m2 cols], whose flat order is the natural order of the transform.
// The arithmetic is K10's (digit_dft.cu): 8 balanced base-256 digits of each
// operand, 64 int8 products summed by diagonal into 15 exact int32 sums
// (|s_d| <= 8 mc 2^14 <= 2^27), one recombination mod p.
//
// What bounds it on an H100: the operations, 2 * 64 * mc int8 operations an
// output element over the dense 1979 TOPS (0.139 ms at 2^23: cols = 128,
// m2 = 256, mc = 256); the bytes (8 an element in, 8 out, the 134 MB table
// once) take 0.080 ms.
//
// The design (the GEMM shape of K8, i8_gemm.cu, on the pieces of
// tma_wgmma.cuh):
// - The product D[k1][k3] = sum_b3 X_i[k1][b3] W_j[k3][b3] has both operands
//   K-major (b3 contiguous), as wgmma takes 8-bit operands. A (M = 64 k1) is
//   X's digit plane i from registers; B (N = 32 k3) is plane j of W' straight
//   from its TMA tile. wgmma.m64n32k32.s32.s8.s8, no .satfinite.
// - The accumulators: a diagonal is N / 2 = 16 registers a thread, so the 15
//   do not fit one warpgroup (and at N = 16, where they would, the int8
//   wgmma issues below the dense rate: probes/wgmma_rate.py). The two
//   consumer warpgroups compute the same 64 x 32 tile and split the
//   diagonals, 32 digit products each: {0..6, 11} (128 registers) and
//   {7..10, 12..14} (112). Each adds its diagonals into a field element (the
//   recombination is linear), and the two halves meet in shared memory.
//   Shared memory read a k32 step: B 64 x 1 KB and A 2 x 8 x 2 KB of
//   fragments against 64 products of 131,072 operations: 96 of the 128
//   bytes a clock an SM has at the dense rate.
// - Digits once a tile: a tile is 64 rows k1 of one slice k2. Its X arrives
//   by TMA in stages of 16 b3 x 64 rows (128-byte swizzle), two a k32 step;
//   the two warpgroups (one takes the even stages, one the odd) digitise it
//   into a 128 KB cache of A fragments laid out in the order the threads
//   load them: one conflict-free 16-byte load a plane and k32 step. The
//   first N-tile of a tile builds the cache step by step, just before each
//   step's products (a barrier of the two warpgroups a step), so the X loads
//   overlap the products. Fragments rather than swizzled planes: the cache
//   is read 16 times a tile and written once, and the table, the other
//   operand, needs no thread to touch it. For mc > 256 the cache holds a
//   chunk of 256 b3 and is rebuilt for every (N-tile, chunk): the diagonals
//   sum across chunks in the accumulators (right at every mc, slower above
//   256, which the probes do not reach).
// - One thread of the producer warpgroup keeps TMA loads in flight through
//   two rings of two slots: X stages (8 KB) and W stages (32 KB: 8 planes x
//   32 k3 x 128 b3, a 3-D map over [k2 k3][digit][b3] so that each plane
//   lands as a 1024-byte aligned tile of 32 rows), each slot with a `full`
//   mbarrier (the TMA's bytes) and an `empty` one. The A fragments are
//   double-buffered: a step's loads run while the previous step's products
//   do; a W stage is released once its last step's products have completed.
// - Epilogue: the recombination on the accumulators, in 64-bit arithmetic
//   (the 8 folded signed sums as two 54-bit halves); the tile [32 k3][64 k1]
//   goes through shared memory and a TMA store over the 3-D view
//   [mc][m2][cols] (rows k1 >= cols fall outside it and are not written).
//   The second warpgroup goes on to the next N-tile while the first adds the
//   halves and stores.
// - Grid: persistent, min(tiles, SMs) blocks over the m2 x ceil(cols / 64)
//   tiles in order, the tiles of one slice next to each other (the second
//   read of W'[k2] comes from L2); 512 tiles at 2^23 on 132 SMs: 3.88 waves,
//   97 % of the last one full.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "goldilocks.cuh"
#include "i8_mma.cuh"
#include "smem_opt_in.cuh"
#include "tma_wgmma.cuh"

namespace {

using namespace hopper;

template <int B>
using Int = std::integral_constant<int, B>;  // a compile-time warpgroup or fragment buffer index

constexpr int kNdig = 8, kDiags = 15;
constexpr int kRows = 64;                     // k1 rows of a tile: wgmma's M
constexpr int kN = 32;                        // k3 columns of an N-tile: wgmma's N, the rows of a W stage
constexpr int kConsumers = 2;                 // warpgroups
constexpr int kChunk = 256;                   // b3 of the digit cache
constexpr int kXB = 16;                       // b3 of an X stage (128 bytes of u64 a row)
constexpr int kWB = 128;                      // b3 of a W stage
constexpr int kStages = 2;                    // slots of each ring
constexpr int kCacheBytes = (kChunk / 32) * kNdig * 128 * 16;  // [k32 step][plane][thread][16 bytes]: 128 KB
constexpr int kPlaneBytes = kN * kWB;         // a plane of a W stage: 4 KB
constexpr int kWBytes = kNdig * kPlaneBytes;  // 32 KB
constexpr int kXBytes = kRows * kXB * 8;      // 8 KB
constexpr int kOutBytes = kN * kRows * 8;     // an N-tile's u64 [32 k3][64 k1]: 16 KB
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr size_t kSmem = 1024 + kCacheBytes + kStages * (kWBytes + kXBytes) + kOutBytes + 4 * kStages * 8;

// The diagonals of warpgroup WG, 32 digit products each: WG 0 {0, ..., 6, 11},
// WG 1 {7, 8, 9, 10, 12, 13, 14}.
__host__ __device__ constexpr int part_size(int wg) { return wg == 0 ? 8 : 7; }
__host__ __device__ constexpr int part_diag(int wg, int k) {
  return wg == 0 ? (k < 7 ? k : 11) : (k < 4 ? 7 + k : 8 + k);
}

// sum_d s_d 2^(8d) mod p, canonical, for |s_d| <= 2^27: the 8 folded signed
// sums sig_r (2^64 = 2^32 - 1, 2^96 = -1; |sig_r| < 2^29), lo = sum_{r<4}
// sig_r 2^(8r) and hi = sum_{r<4} sig_(r+4) 2^(8r) (|.| < 2^54), and
// lo + hi 2^32 = lo + (hi >> 32) (2^32 - 1) + (hi mod 2^32) 2^32 (mod p).
__device__ __forceinline__ uint64_t recombine(const int (&s)[kDiags]) {
  const long long sig[kNdig] = {
      s[0] - s[8] - s[12], s[1] - s[9] - s[13], s[2] - s[10] - s[14], s[3] - s[11],
      s[4] + s[8],         s[5] + s[9],         s[6] + s[10],         s[7] + s[11]};
  long long lo = 0, hi = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    lo += sig[r] * (1LL << (8 * r));
    hi += sig[4 + r] * (1LL << (8 * r));
  }
  const long long t = lo + (hi >> 32) * (long long)gl::EPS;  // |t| < 2^55 < p
  const uint64_t tc = t < 0 ? (uint64_t)t + gl::P : (uint64_t)t;
  return gl::add(gl::canon((uint64_t)(hi & 0xFFFFFFFFLL) << 32), tc);
}

template <int R, int C>
__device__ __forceinline__ void fence_acc(int (&acc)[R][C]) {
#pragma unroll
  for (int d = 0; d < R; ++d) fence_regs(acc[d]);
}

// The schedule both sides walk: per tile the N-tiles p (32 k3 from 32 p), per
// N-tile the chunks kc of 256 b3 (one when mc <= 256), per chunk its W stages
// of wspc k32 steps. A chunk's digits are built, step by step, when there is
// more than one chunk, or at p = 0.
struct Shape {
  int cs, nk, spc, wspc, ntiles;
  __device__ explicit Shape(int mc) {
    cs = min(mc, kChunk);
    nk = mc / cs;
    spc = cs / 32;
    wspc = min(4, spc);
    ntiles = mc / kN;
  }
  __device__ bool build(int p) const { return nk > 1 || p == 0; }
};

__global__ void __launch_bounds__(kThreads, 1)
digit_dft_last_kernel(__grid_constant__ const CUtensorMap tm_w, __grid_constant__ const CUtensorMap tm_x,
                      __grid_constant__ const CUtensorMap tm_out, int mc, int halves, int tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* cache = smem;
  unsigned char* sW = cache + kCacheBytes;
  unsigned char* sX = sW + kStages * kWBytes;
  uint64_t* sOut = reinterpret_cast<uint64_t*>(sX + kStages * kXBytes);
  uint64_t* full_w = reinterpret_cast<uint64_t*>(sX + kStages * kXBytes + kOutBytes);
  uint64_t* empty_w = full_w + kStages;
  uint64_t* full_x = empty_w + kStages;
  uint64_t* empty_x = full_x + kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_w + s, 1);
      mbar_init(empty_w + s, kConsumers * 4);  // lane 0 of every consumer warp, its products done
      mbar_init(full_x + s, 1);
      mbar_init(empty_x + s, 128);  // every thread of the warpgroup that digitises the slot
    }
    fence_mbar_init();
  }
  __syncthreads();
  const Shape sh(mc);
  // the maps in parameter space (the lambdas below take these pointers, never a copy of a map)
  const CUtensorMap *map_w = &tm_w, *map_x = &tm_x, *map_out = &tm_out;

  if (warp >= kConsumers * 4) {
    // ---- producer warpgroup: gives its registers to the consumers; one
    // thread issues every TMA load, in the order the consumers take them: a
    // chunk's first W stage, then for each k32 step its two X stages (when
    // the chunk is built) and, at a W stage's first step, the next W stage
    setmaxnreg_dec<40>();
    if (warp == kConsumers * 4 && lane == 0) {
      int iw = 0, ix = 0;
      uint32_t pw = 0, px = 0;
      auto load_w = [&](int k2, int p, int kc, int sub) {
        mbar_wait(empty_w + iw, pw ^ 1);
        mbar_expect_tx(full_w + iw, kWBytes);
        for (int j = 0; j < kNdig; ++j)
          tma_load_3d(sW + iw * kWBytes + j * kPlaneBytes, map_w, full_w + iw, kc * kChunk + sub * kWB, j,
                      k2 * mc + p * kN);
        if (++iw == kStages) iw = 0, pw ^= 1;
      };
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int k2 = tile / halves, h = tile % halves;
        for (int p = 0; p < sh.ntiles; ++p) {
          for (int kc = 0; kc < sh.nk; ++kc) {
            load_w(k2, p, kc, 0);
            for (int sc = 0; sc < sh.spc; ++sc) {
              if (sh.build(p))
                for (int jj = 0; jj < kConsumers; ++jj) {
                  mbar_wait(empty_x + ix, px ^ 1);
                  mbar_expect_tx(full_x + ix, kXBytes);
                  tma_load_2d(sX + ix * kXBytes, map_x, full_x + ix, k2 * mc + kc * kChunk + (2 * sc + jj) * kXB,
                              h * kRows);
                  if (++ix == kStages) ix = 0, px ^= 1;
                }
              if (sc % sh.wspc == 0 && sc + sh.wspc < sh.spc) load_w(k2, p, kc, sc / sh.wspc + 1);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: both warpgroups compute every N-tile, each its own diagonals
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128, w4 = t / 32, g = lane / 4, q4 = lane % 4;
    const bool leader = t == 0;

    auto consume = [&](auto wgc) {
      constexpr int WG = decltype(wgc)::value;
      constexpr int NP = part_size(WG);
      int iw = 0, prev_w = -1;
      uint32_t pw = 0, pxw = 0;
      int acc[NP][16];
      uint32_t fr[2][kNdig][4];  // the A fragments of a k32 step, double-buffered

      // X stage j of a chunk lands in slot j % 2 and warpgroup j % 2 digitises
      // it: stage 2 sc + WG -> words 2 WG (row 16 w4 + g) and 2 WG + 1 (row
      // + 8) of every thread's fragments of step sc, elements 4 q4 .. 4 q4 + 3
      // of the stage's 16 (16-byte units 2 q4, 2 q4 + 1, swizzled by the row)
      auto digitise = [&](int sc) {
        const unsigned char* xs = sX + WG * kXBytes;
        mbar_wait(full_x + WG, pxw);
        uint32_t word[2][kNdig];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const unsigned char* row = xs + (16 * w4 + g + 8 * rr) * 128;
          const ulonglong2 v0 = *reinterpret_cast<const ulonglong2*>(row + (((2 * q4) ^ g) << 4));
          const ulonglong2 v1 = *reinterpret_cast<const ulonglong2*>(row + (((2 * q4 + 1) ^ g) << 4));
          const uint64_t e[4] = {v0.x, v0.y, v1.x, v1.y};
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint64_t d = i8mma::balanced_digits(e[c]);
            lo[c] = (uint32_t)d;
            hi[c] = (uint32_t)(d >> 32);
          }
          i8mma::transpose4x4(lo);
          i8mma::transpose4x4(hi);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            word[rr][i] = lo[i];
            word[rr][4 + i] = hi[i];
          }
        }
        mbar_arrive(empty_x + WG);
        pxw ^= 1;
        unsigned char* dst = cache + (sc * kNdig * 128 + t) * 16 + 8 * WG;
#pragma unroll
        for (int i = 0; i < kNdig; ++i)
          *reinterpret_cast<uint2*>(dst + i * 128 * 16) = make_uint2(word[0][i], word[1][i]);
      };

      // k32 step s of N-tile p (step sc = s % spc of chunk s / spc) from fragment buffer b
      auto step = [&](auto bb, int s, int p) {
        constexpr int b = decltype(bb)::value;
        const int sc = s % sh.spc, sw = sc % sh.wspc;
        if (sh.build(p)) {
          if (sc == 0) named_sync(1, 128 * kConsumers);  // both are done with the cache's previous chunk
          digitise(sc);
          named_sync(1, 128 * kConsumers);  // step sc's fragments are in the cache
        }
        if (sw == 0) mbar_wait(full_w + iw, pw);
        const unsigned char* src = cache + (sc * kNdig * 128 + t) * 16;
#pragma unroll
        for (int i = 0; i < kNdig; ++i) {
          const uint4 v = *reinterpret_cast<const uint4*>(src + i * 128 * 16);
          fr[b][i][0] = v.x;
          fr[b][i][1] = v.y;
          fr[b][i][2] = v.z;
          fr[b][i][3] = v.w;
        }
        const uint64_t db = desc_k128(sW + iw * kWBytes) + 2 * sw;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kNdig; ++j)
#pragma unroll
          for (int k = 0; k < NP; ++k) {
            const int i = part_diag(WG, k) - j;
            if (i >= 0 && i < kNdig) wgmma_m64n32k32_s8_rs(acc[k], fr[b][i], db + (uint64_t)(j * (kPlaneBytes >> 4)));
          }
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // step s - 1 is done: its fragment buffer is free, and so is its W stage
        if (sw == 0 && prev_w >= 0) {
          if (lane == 0) mbar_arrive(empty_w + prev_w);
          prev_w = -1;
        }
        if (sw == sh.wspc - 1) {  // the stage's last step is issued: released after its products
          prev_w = iw;
          if (++iw == kStages) iw = 0, pw ^= 1;
        }
      };

      const int steps = sh.nk * sh.spc;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int k2 = tile / halves, h = tile % halves;
        for (int p = 0; p < sh.ntiles; ++p) {
#pragma unroll
          for (int k = 0; k < NP; ++k)
#pragma unroll
            for (int c = 0; c < 16; ++c) acc[k][c] = 0;
          for (int s = 0; s < steps; s += 2) {
            step(Int<0>{}, s, p);
            if (s + 1 < steps) step(Int<1>{}, s + 1, p);
          }
          wgmma_wait<0>();
          fence_acc(acc);
          if (lane == 0) mbar_arrive(empty_w + prev_w);
          prev_w = -1;

          // ---- epilogue: thread (w4, g, q4) holds D[k1][k3] at k1 = 16 w4 + g
          // + 8 rr, k3 = 8 ci + 2 q4 + e in acc[.][4 ci + 2 rr + e]. Each
          // warpgroup recombines its diagonals; warpgroup 1 leaves its field
          // elements at their place in the tile [32 k3][64 k1], warpgroup 0
          // adds its own and stores the tile at (k1 64 h, k2, k3 32 p).
          uint64_t y[16];
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            int sd[kDiags] = {};
#pragma unroll
            for (int k = 0; k < NP; ++k) sd[part_diag(WG, k)] = acc[k][c];
            y[c] = recombine(sd);
          }
          if (WG == 0 && leader) tma_store_wait_read();  // the previous store has read the tile
          named_sync(1, 128 * kConsumers);
          auto at = [&](int c) { return (8 * (c / 4) + 2 * q4 + (c & 1)) * kRows + 16 * w4 + g + 8 * ((c / 2) & 1); };
          if (WG == 1) {
#pragma unroll
            for (int c = 0; c < 16; ++c) sOut[at(c)] = y[c];
          }
          named_sync(1, 128 * kConsumers);
          if (WG == 0) {
#pragma unroll
            for (int c = 0; c < 16; ++c) sOut[at(c)] = gl::add(y[c], sOut[at(c)]);
            fence_proxy_async();
            named_sync(2, 128);
            if (leader) {
              tma_store_3d(map_out, sOut, h * kRows, k2, p * kN);
              tma_store_commit();
            }
          }
        }
      }
      if (WG == 0 && leader) tma_store_wait();
    };

    if (warp < 4)
      consume(Int<0>{});
    else
      consume(Int<1>{});
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// K11. x: u64 [cols, m2 * mc] = X[k1, (k2, b3)]. wf: int8 [m2, mc, 8, mc] =
// digit d of W'[k2][k3, b3] at [k2][k3][d][b3]. out: u64 [mc, m2 * cols] =
// Y[k3, (k2, k1)], Y[k3, k2, k1] = sum_b3 X[k1, k2, b3] W'[k2][k3, b3] mod p.
// mc a power of two in 32 .. 1024, cols a multiple of 16, m2 <= 65535; every
// pointer 16-byte aligned. Returns the launch's cudaError_t,
// cudaErrorInvalidValue for what it does not take, or cudaErrorNotSupported
// when a tensor map cannot be encoded.
extern "C" int sezkp_digit_dft_last(const void* wf, const void* x, void* out, int cols, int m2, int mc,
                                    void* stream) {
  if (mc < 32 || mc > 1024 || (mc & (mc - 1)) || cols < 16 || cols % 16 || m2 < 1 || m2 > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(wf) || !aligned16(x) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  const int halves = (cols + kRows - 1) / kRows;
  const long long tiles = (long long)m2 * halves;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const cuuint64_t n2 = (cuuint64_t)m2 * mc;
  // W' as [k2 k3][digit][b3], boxes of 32 rows x 1 digit x 128 b3
  const cuuint64_t wdims[3] = {(cuuint64_t)mc, kNdig, n2}, wstr[2] = {(cuuint64_t)mc, (cuuint64_t)kNdig * mc};
  const cuuint32_t wbox[3] = {kWB, 1, kN};
  // X as [cols][m2 mc], boxes of 64 rows x 16 b3
  const cuuint64_t xdims[2] = {n2, (cuuint64_t)cols}, xstr[1] = {n2 * 8};
  const cuuint32_t xbox[2] = {kXB, kRows};
  // Y as [mc][m2][cols], boxes of 32 k3 x 1 k2 x 64 k1
  const cuuint64_t odims[3] = {(cuuint64_t)cols, (cuuint64_t)m2, (cuuint64_t)mc};
  const cuuint64_t ostr[2] = {(cuuint64_t)cols * 8, (cuuint64_t)m2 * cols * 8};
  const cuuint32_t obox[3] = {kRows, 1, kN};
  CUtensorMap tm_w, tm_x, tm_out;
  if (!tensor_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, wf, wdims, wstr, wbox, true) ||
      !tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT64, 2, x, xdims, xstr, xbox, true) ||
      !tensor_map(&tm_out, CU_TENSOR_MAP_DATA_TYPE_UINT64, 3, out, odims, ostr, obox, false))
    return (int)cudaErrorNotSupported;

  cudaError_t err;
  static unsigned long long done = 0;
  if ((err = smem_opt_in(digit_dft_last_kernel, kSmem, done))) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return (int)err;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  digit_dft_last_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(tm_w, tm_x, tm_out, mc, halves,
                                                                         (int)tiles);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a block of K11 takes (bytes), for the reports.
extern "C" int sezkp_digit_dft_last_smem() { return (int)kSmem; }
