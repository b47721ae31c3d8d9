// The kernel body of the digit-form DFT phase on TMA + wgmma, shared by K11
// digit_dft_last (digit_dft_last.cu, whose comment gives the design) and K10
// digit_dft (digit_dft.cu). Both compute, per output tile,
//   D[k1][k3] = sum_b3 X[k1][b3] W[k3][b3] mod p
// as 64 int8 digit products summed by diagonal: rows k1 of X are wgmma's M
// (64 a tile), outputs k3 its N (32 an N-tile), b3 the contraction. K11 has
// one folded table per slice k2 (`m2` slices); K10 is K11 with one table
// (m2 = 1): its columns are the rows k1, its contraction index b is b3 and
// its output row k is k3.
//
// The template's parameters are what differs:
// - SRC, where X comes from and how a stage of 16 b3 x 64 rows lands:
//   kXRows  K11: u64 [rows][m2 mc], b3 contiguous: one box [64 rows][16 b3],
//           128-byte swizzle; the table a 3-D map over [k2 k3][digit][b3]
//           and the store over [mc][m2][rows].
//   kXCols  K10 elements in: u64 [m][columns], columns contiguous: one
//           unswizzled box [16 b][64 columns]; a thread's 4 consecutive b of
//           one column are 4 rows of it (four wavefronts an 8-byte load
//           where two would do: the four q4 of a column read one bank. Four
//           swizzled boxes [16 b][16 columns] read at two, and a swizzled 3-D
//           box [16 b][4][16 columns] also at four: neither was quicker,
//           probes/ntt_variants.py, and the four boxes cost two spilled
//           registers, PERF.md);
//   kXStack K10 stack in: int8 [digit][columns][m] (K9's k-major stack): one
//           box [8 planes][64 columns][16 b], unswizzled; each fragment word
//           is 4 bytes of one plane row, copied (no digitising).
//           K10's table is a 2-D map over [8 m rows][m b] (plane j of the
//           N-tile p is the box at row j m + 32 p), its store over [m][columns].
// - EPI: kRecombine (the canonical field element, u64) or kSum (the 15
//   diagonals added as int32, wrapping; u32 bits through an INT32 map).
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "goldilocks.cuh"
#include "i8_mma.cuh"
#include "tma_wgmma.cuh"

namespace digit_wgmma {

using namespace hopper;

template <int B>
using Int = std::integral_constant<int, B>;  // a compile-time warpgroup or fragment buffer index

enum XSource { kXRows, kXCols, kXStack };
enum Epilogue { kRecombine, kSum };

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
constexpr int kXBytes = kRows * kXB * 8;      // 8 KB (the stack's 8 planes of int8 too)
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

// The digit words of 4 elements c = 0..3 (k = 4 q4 + c): word i holds digit
// plane i, byte c = element c (i8mma::transpose4x4 of the digit bytes).
__device__ __forceinline__ void digit_words(const uint64_t (&e)[4], uint32_t* word) {
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
    word[i] = lo[i];
    word[4 + i] = hi[i];
  }
}

// Thread (w4, g, q4)'s words of an X stage at `xs`: word[rr][i] is digit plane
// i of row 16 w4 + g + 8 rr, b3 = 4 q4 .. 4 q4 + 3 of the stage's 16.
template <int SRC>
__device__ __forceinline__ void stage_words(const unsigned char* xs, int w4, int g, int q4,
                                            uint32_t (&word)[2][kNdig]) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if constexpr (SRC == kXRows) {
      // [64 rows][16 b3]: elements 4 q4 .. 4 q4 + 3 are the 16-byte units 2 q4
      // and 2 q4 + 1 of the row, swizzled by the row
      const unsigned char* row = xs + (16 * w4 + g + 8 * rr) * 128;
      const ulonglong2 v0 = *reinterpret_cast<const ulonglong2*>(row + (((2 * q4) ^ g) << 4));
      const ulonglong2 v1 = *reinterpret_cast<const ulonglong2*>(row + (((2 * q4 + 1) ^ g) << 4));
      const uint64_t e[4] = {v0.x, v0.y, v1.x, v1.y};
      digit_words(e, word[rr]);
    } else if constexpr (SRC == kXCols) {
      // [16 b3][64 rows]: the row's element of b3 = 4 q4 + c
      const unsigned char* col = xs + (16 * w4 + g + 8 * rr) * 8;
      uint64_t e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) e[c] = *reinterpret_cast<const uint64_t*>(col + (4 * q4 + c) * kRows * 8);
      digit_words(e, word[rr]);
    } else {
      // [plane][64 rows][16 b3]: the word is bytes 4 q4 .. 4 q4 + 3 of the plane's row
      const unsigned char* row = xs + (16 * w4 + g + 8 * rr) * 16 + 4 * q4;
#pragma unroll
      for (int i = 0; i < kNdig; ++i) word[rr][i] = *reinterpret_cast<const uint32_t*>(row + i * kRows * 16);
    }
  }
}

// The kernel: K11 (SRC = kXRows) over m2 = tiles / halves slices, K10 (m2 = 1,
// halves = tiles) over the column tiles. The maps are the kernel's
// __grid_constant__ parameters (their addresses, never a copy).
template <int SRC, int EPI>
__device__ __forceinline__ void body(const CUtensorMap* map_w, const CUtensorMap* map_x,
                                     const CUtensorMap* map_out, int mc, int halves, int tiles) {
  static_assert(SRC == kXRows ? EPI == kRecombine : true, "K11 recombines");
  using Out = std::conditional_t<EPI == kSum, uint32_t, uint64_t>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* cache = smem;
  unsigned char* sW = cache + kCacheBytes;
  unsigned char* sX = sW + kStages * kWBytes;
  Out* sOut = reinterpret_cast<Out*>(sX + kStages * kXBytes);
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
        for (int j = 0; j < kNdig; ++j) {
          if constexpr (SRC == kXRows)
            tma_load_3d(sW + iw * kWBytes + j * kPlaneBytes, map_w, full_w + iw, kc * kChunk + sub * kWB, j,
                        k2 * mc + p * kN);
          else
            tma_load_2d(sW + iw * kWBytes + j * kPlaneBytes, map_w, full_w + iw, kc * kChunk + sub * kWB,
                        j * mc + p * kN);
        }
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
                  if constexpr (SRC == kXRows)
                    tma_load_2d(sX + ix * kXBytes, map_x, full_x + ix, k2 * mc + kc * kChunk + (2 * sc + jj) * kXB,
                                h * kRows);
                  else if constexpr (SRC == kXCols)
                    tma_load_2d(sX + ix * kXBytes, map_x, full_x + ix, h * kRows, kc * kChunk + (2 * sc + jj) * kXB);
                  else
                    tma_load_3d(sX + ix * kXBytes, map_x, full_x + ix, kc * kChunk + (2 * sc + jj) * kXB, h * kRows, 0);
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

      // X stage j of a chunk lands in slot j % 2 and warpgroup j % 2 takes
      // it: stage 2 sc + WG -> words 2 WG (row 16 w4 + g) and 2 WG + 1 (row
      // + 8) of every thread's fragments of step sc
      auto digitise = [&](int sc) {
        const unsigned char* xs = sX + WG * kXBytes;
        mbar_wait(full_x + WG, pxw);
        uint32_t word[2][kNdig];
        stage_words<SRC>(xs, w4, g, q4, word);
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
          // warpgroup reduces its diagonals (recombined, or added as int32);
          // warpgroup 1 leaves its values at their place in the tile
          // [32 k3][64 k1], warpgroup 0 adds its own and stores the tile at
          // (k1 64 h, k2, k3 32 p)
          Out y[16];
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            if constexpr (EPI == kSum) {
              uint32_t v = 0;
#pragma unroll
              for (int k = 0; k < NP; ++k) v += (uint32_t)acc[k][c];
              y[c] = v;
            } else {
              int sd[kDiags] = {};
#pragma unroll
              for (int k = 0; k < NP; ++k) sd[part_diag(WG, k)] = acc[k][c];
              y[c] = recombine(sd);
            }
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
            for (int c = 0; c < 16; ++c) {
              if constexpr (EPI == kSum)
                sOut[at(c)] += y[c];
              else
                sOut[at(c)] = gl::add(y[c], sOut[at(c)]);
            }
            fence_proxy_async();
            named_sync(2, 128);
            if (leader) {
              if constexpr (SRC == kXRows)
                tma_store_3d(map_out, sOut, h * kRows, k2, p * kN);
              else
                tma_store_2d(map_out, sOut, h * kRows, p * kN);
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

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace digit_wgmma
