// K5 ntt_small: the whole Goldilocks NTT of n = 2^L points, L = 1 .. 13, in
// one launch of one thread block cluster; natural order in and out, the n^-1
// of the inverse folded in.
//
// It replaces the four-step transform of sezkp_tpu/ops/ntt_pallas.py
// (`_build`'s f): `phase_a_kernel` (the pallas_call at :162), `phase_b_kernel`
// (:177), and the bit-reverse gathers, the n^-1 scale and the transpose to
// natural order that run around them there. It computes what they compute,
// not the way they do (roll-and-select butterflies for a compiler without
// gathers). With n = n1 * n2, n1 = 2^(L/2) and a[j1 * n2 + j2] = A[j1, j2]:
//
//   phase A  B[k1, j2] = (sum_j1 A[j1, j2] w_n1^(j1 k1)) * tw[k1, j2],
//            tw[k1, j2] = w_n^(k1 j2), times n^-1 for the inverse
//   phase B  y[k1 + n1 k2] = sum_j2 B[k1, j2] w_n2^(j2 k2)
//
// What bounds it on an H100: at most 2^13 elements, 64 KB in, 64 KB out and
// 64 KB of table, which the card could move in 0.06 us; the field arithmetic
// is about as short (chip_smoke.py's bound). A launch takes about a
// microsecond. So what a transform costs is the launch, the latency of its
// loads and barriers, and the one chain of dependent work that each thread
// runs (one or two warps an SM issue it), and the design keeps all three
// short:
//
// - One launch, for both phases. The grid is one cluster of C CTAs (C = 1 up
//   to n = 2^8, then 2, 4, 8 and 16 from n = 2^12: Small<L>::C). The
//   intermediate B never goes to device memory: CTA c runs phase A on its
//   n2/C columns and leaves B[:, its columns] in its own shared memory; after
//   a cluster barrier it reads its n1/C rows of B from the C CTAs' shared
//   memory (distributed shared memory), runs phase B and stores y.
// - Both phases on the register passes of ntt_reg.cuh, templated on L and
//   the direction: compile-time indices, power-of-two twiddles inside a
//   pass, at most two exchanges through shared memory a phase. A thread
//   holds 2^kReg = 8 elements of one vector (16 made each thread's chain
//   twice as long: probes/ntt_variants.py), so at n = 2^13 the transform
//   takes 1024 threads, 64 a CTA; every thread is busy in both phases.
// - The twiddles between a phase's passes come from tables (pta, ptb), not
//   as powers of two: a warp holds several values of t, and a power of two
//   for each would be a branch each. Every load from device memory is issued
//   at the start (the inputs, phase A's four-step twiddles, both phases'
//   pass twiddles into registers), so none waits behind a barrier.
// - Phase A multiplies the four-step twiddle into its result on the way to
//   shared memory. The inverse's n^-1 rides in that table
//   (ntt_torch._small_twiddles), so the inverse costs no product more than
//   the forward transform.
// - The exit barrier is split: a CTA arrives as soon as it has read its
//   peers' shared memory and waits (so that no CTA leaves while a peer still
//   reads it) only at the end, behind phase B's work.
// - Phase B's threads take neighbouring rows k1, so its stores y[k1 + n1 k2]
//   come in runs of n1/C elements, straight from registers.
//
// ntt_torch.small_cluster_model is the same schedule in tensor code (CTA
// slices, addresses in shared memory, stores by address).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ntt_reg.cuh"

namespace cg = cooperative_groups;

namespace {

using ntt_reg::Plan;
using ntt_reg::static_for;

// ntt_torch.py mirrors these (SMALL_REG_LOG2, SMALL_CLUSTER_CAP,
// SMALL_MIN_THREADS); the tests compare them.
constexpr int kReg = 3;          // log2 of the elements a thread holds of a vector
constexpr int kClusterCap = 16;  // the largest cluster (above 8: non-portable)
constexpr int kMinThreads = 32;  // a CTA's threads before the transform takes more CTAs

template <int L>
struct Small {
  static constexpr int LA = L / 2, LB = L - LA;
  static constexpr int n1 = 1 << LA, n2 = 1 << LB;
  using PA = Plan<LA, kReg>;
  using PB = Plan<LB, kReg>;
  // threads of the whole transform in each phase: one per vector and register set
  static constexpr int TOT_A = n2 * PA::T, TOT_B = n1 * PB::T;
  static constexpr int TOT = TOT_A > TOT_B ? TOT_A : TOT_B;
  static constexpr int C0 = TOT / kMinThreads > 1 ? TOT / kMinThreads : 1;
  static constexpr int C1 = C0 < kClusterCap ? C0 : kClusterCap;
  static constexpr int C = C1 < n1 ? C1 : n1;  // CTAs of the cluster
  static constexpr int COLS = n2 / C;          // phase A: columns a CTA
  static constexpr int ROWS = n1 / C;          // phase B: rows a CTA
  static constexpr int NA = COLS * PA::T, NB = ROWS * PB::T;
  static constexpr int NT = NA > NB ? NA : NB;  // threads a CTA
  static constexpr int SLICE = n1 * COLS;       // elements a CTA holds (= ROWS * n2)
  // a phase with an exchange has a barrier inside: every thread must run it
  static_assert(PA::NPASS == 1 || NA == NT, "phase A's barrier needs every thread");
  static_assert(PB::NPASS == 1 || NB == NT, "phase B's barrier needs every thread");
  static_assert(PA::NPASS <= 2, "emit_k: phase A's plan has one exchange at most");
};

// The output index k that run_passes emits register q of thread t as
// (plans of one or two passes).
template <class P>
__device__ __forceinline__ int emit_k(int t, int q) {
  if constexpr (P::NPASS == 1) {
    return q;
  } else {
    constexpr int D = P::E / P::T;
    return t * D + q / P::T + P::E * (q % P::T);
  }
}

// Phase A's twiddles: w[q] = tw[k1 * n2 + j2] for the k1 that register q
// of thread t becomes (n^-1 folded into tw for the inverse).
template <class PA, int n2>
__device__ __forceinline__ void four_step_twiddles(uint64_t (&w)[PA::E], const uint64_t* __restrict__ tw, int t,
                                                   int j2) {
  static_for<PA::E>([&](auto q) { w[q] = __ldg(tw + emit_k<PA>(t, q) * n2 + j2); });
}

// The cluster barrier in two halves: arrive (release: this thread's reads
// and writes of shared memory come first) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory"); }

template <int L, bool INV>
__global__ void __launch_bounds__(Small<L>::NT)
ntt_small_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, const uint64_t* __restrict__ tw,
                 const uint64_t* __restrict__ pta, const uint64_t* __restrict__ ptb) {
  using S = Small<L>;
  using PA = typename S::PA;
  using PB = typename S::PB;
  constexpr int n1 = S::n1, n2 = S::n2, COLS = S::COLS, ROWS = S::ROWS;
  __shared__ uint64_t sx[S::SLICE];  // a phase's exchange between its passes
  __shared__ uint64_t sb[S::SLICE];  // B[k1, c*COLS + col] at k1*COLS + col, read by the cluster
  const int tid = threadIdx.x;
  int c = 0;
  if constexpr (S::C > 1) c = (int)cg::this_cluster().block_rank();
  const bool live_a = S::NA == S::NT || tid < S::NA, live_b = S::NB == S::NT || tid < S::NB;
  const int col = tid % COLS, ta = tid / COLS;  // phase A: column c*COLS + col, thread ta of it
  const int r = tid % ROWS, tb = tid / ROWS;    // phase B: row c*ROWS + r, thread tb of it
  // every load from device memory first: the inputs, phase A's twiddles and
  // both phases' pass twiddles (phase B's would otherwise wait behind the
  // cluster barrier)
  uint64_t a[1][PA::E], w[PA::E];
  ntt_reg::PassRow<PA::E> rowa;
  ntt_reg::PassRow<PB::E> rowb;
  if (live_a) {
    const int j2 = c * COLS + col;
    static_for<PA::E>([&](auto q) { a[0][q] = x[(q * PA::T + ta) * n2 + j2]; });
    four_step_twiddles<PA, n2>(w, tw, ta, j2);
    if constexpr (PA::NPASS > 1) rowa.load(pta, ta);
  }
  if constexpr (PB::NPASS > 1) {
    if (live_b) rowb.load(ptb, tb);
  }

  // ---- phase A: thread (col, ta) holds x[(j1*TA + ta) * n2 + j2] of column j2
  if (live_a)
    ntt_reg::run_passes<S::LA, INV, false, true>(
        a, ta, rowa, [&](int pos, auto q) { sx[pos * COLS + col] = a[0][q]; },
        [&](int pos, auto q) { a[0][q] = sx[pos * COLS + col]; },
        [&](int k, auto q) { sb[k * COLS + col] = gl::mul_cc(a[0][q], w[q]); });
  if constexpr (S::C > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  // ---- phase B: thread (r, tb) holds B[k1, j1*TB + tb], from the CTA that owns that column
  const int k1 = c * ROWS + r;
  uint64_t b[1][PB::E];
  if (live_b)
    static_for<PB::E>([&](auto q) {
      const int j2 = q * PB::T + tb;
      const uint64_t* src = sb;
      if constexpr (S::C > 1) src = cg::this_cluster().map_shared_rank(sb, (unsigned)(j2 / COLS));
      b[0][q] = src[k1 * COLS + j2 % COLS];
    });
  // this CTA has read its peers' shared memory: it arrives now, and waits
  // (so that no peer leaves while this CTA may still read it) only at the end
  if constexpr (S::C > 1) cluster_arrive();
  if (live_b)
    ntt_reg::run_passes<S::LB, INV, false, true>(
        b, tb, rowb, [&](int pos, auto q) { sx[pos * ROWS + r] = b[0][q]; },
        [&](int pos, auto q) { b[0][q] = sx[pos * ROWS + r]; },
        [&](int k, auto q) { y[k1 + n1 * k] = b[0][q]; });
  if constexpr (S::C > 1) cluster_wait();
}

// An empty kernel: the launch floor that chip_smoke.py times beside K5.
__global__ void launch_floor_kernel(int) {}

// Make `kernel` launchable as clusters of `cluster` CTAs of `threads`
// threads, once per kernel, cluster size and device (`done`: one bit a
// device), so that no launch after the first, and none captured into a CUDA
// graph, makes these calls: opt in to a non-portable size above 8, and
// refuse what the card cannot co-schedule.
template <class K>
cudaError_t cluster_ready(K kernel, int cluster, int threads, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (done & bit) return cudaSuccess;
  if (cluster > 8 && (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)))
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3((unsigned)threads);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int active = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg))) return err;
  if (active < 1) return cudaErrorLaunchOutOfResources;
  done |= bit;
  return cudaSuccess;
}

// One cluster of `cluster` CTAs (a plain launch of one CTA for 1).
template <class... KArgs, class... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), int cluster, int threads, unsigned long long& done,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  cudaError_t err;
  if (cluster > 1) {
    if ((err = cluster_ready(kernel, cluster, threads, done))) return err;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = (unsigned)cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  if ((err = cudaLaunchKernelEx(&cfg, kernel, args...))) return err;
  return cudaGetLastError();
}

template <int L, bool INV>
int launch_small(const void* x, void* y, const void* tw, const void* pta, const void* ptb, cudaStream_t stream) {
  using S = Small<L>;
  if ((S::PA::NPASS > 1 && !pta) || (S::PB::NPASS > 1 && !ptb)) return (int)cudaErrorInvalidValue;
  static unsigned long long done = 0;
  return (int)launch_cluster(ntt_small_kernel<L, INV>, S::C, S::NT, done, stream, (const uint64_t*)x,
                             (uint64_t*)y, (const uint64_t*)tw, (const uint64_t*)pta, (const uint64_t*)ptb);
}

}  // namespace

// x, y: n = 2^n_log2 field elements (1 <= n_log2 <= 13), natural order. tw:
// the four-step twiddles [n1, n2] with n^-1 folded in for the inverse
// (ntt_torch._small_twiddles); pta, ptb: the pass twiddles of phase A and B
// [n1 / 2^kReg, 2^kReg] and [n2 / 2^kReg, 2^kReg] (ntt_torch._pass_twiddles),
// needed where that phase has two passes (n1 or n2 above 2^kReg). Returns
// the launch's cudaError_t (0 = launched), or cudaErrorInvalidValue for what
// it does not take.
extern "C" int sezkp_ntt_small(const void* x, void* y, int n_log2, int inverse, const void* tw, const void* pta,
                               const void* ptb, void* stream) {
  if (n_log2 < 1 || n_log2 > 13 || !x || !y || !tw) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n_log2) {
#define NTT_SMALL_CASE(L)                                                            \
  case L:                                                                            \
    return inverse ? launch_small<L, true>(x, y, tw, pta, ptb, st)                   \
                   : launch_small<L, false>(x, y, tw, pta, ptb, st);
    NTT_SMALL_CASE(1) NTT_SMALL_CASE(2) NTT_SMALL_CASE(3) NTT_SMALL_CASE(4) NTT_SMALL_CASE(5)
    NTT_SMALL_CASE(6) NTT_SMALL_CASE(7) NTT_SMALL_CASE(8) NTT_SMALL_CASE(9) NTT_SMALL_CASE(10)
    NTT_SMALL_CASE(11) NTT_SMALL_CASE(12) NTT_SMALL_CASE(13)
#undef NTT_SMALL_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The cluster size K5 launches for n = 2^n_log2 (0 for sizes it does not take).
extern "C" int sezkp_ntt_small_cluster(int n_log2) {
  switch (n_log2) {
#define NTT_SMALL_C(L) \
  case L: return Small<L>::C;
    NTT_SMALL_C(1) NTT_SMALL_C(2) NTT_SMALL_C(3) NTT_SMALL_C(4) NTT_SMALL_C(5) NTT_SMALL_C(6) NTT_SMALL_C(7)
    NTT_SMALL_C(8) NTT_SMALL_C(9) NTT_SMALL_C(10) NTT_SMALL_C(11) NTT_SMALL_C(12) NTT_SMALL_C(13)
#undef NTT_SMALL_C
  }
  return 0;
}

// The launch floor: one empty cluster of `cluster` CTAs of 32 threads
// (cluster = 1, 2, 4, 8, 16), launched as K5 launches. Exported for
// chip_smoke.py's timing only.
extern "C" int sezkp_launch_floor(int cluster, void* stream) {
  static unsigned long long done[5] = {};
  const int i = ntt_reg::ilog2(cluster);
  if (cluster < 1 || cluster > 16 || (1 << i) != cluster) return (int)cudaErrorInvalidValue;
  return (int)launch_cluster(launch_floor_kernel, cluster, 32, done[i], (cudaStream_t)stream, 0);
}
