"""A/B of the design choices of K2 ntt_phase_axis, K3 ntt_phase_batched, K4
ntt_phase_last, K5 ntt_small, K9 gl_digits, K10 digit_dft, K11
digit_dft_last and K12 deep_divide.

Each variant is this checkout's ops/csrc with the text edits of one design
choice, the sources it concerns (ntt_phases.cu for K2/K3, ntt_last.cu for
K4, ntt_small.cu for K5, gl_digits.cu for K9, digit_dft.cu for K10 and
digit_dft_last.cu for K11, whose common body is digit_wgmma.cuh, deep_divide.cu
for K12) built into a library of its own (nvcc,
all variants at once, under sezkp_tpu_torch/_build/variants/). The
main-path shapes of a T = 2^20 prove (the coset NTT at 2^23, the base
inverse NTT at 2^20), of a T = 2^13 prove (K5 at 2^13) and of the probes
(K9's k-major stack and K10 on one phase of 2^23, K10 in three modes,
K11's phase C at 2^23, K12 over the LDE's coset of 2^23) are timed with CUDA events in turns: every variant,
then every variant again in reverse order; K5, whose launch costs the host
more than the card, K9, K10 and K11 replayed from a CUDA graph. Each variant's
outputs must equal the port's own kernels'. ptxas's registers and spills of
the main-path instantiations are printed.

  base             the sources as they are
  add_sub          butterflies as gl::add + gl::sub (64-bit compares and
                   selects) instead of gl::bfly's carry chains
  mul              general products as gl::mul instead of gl::mul_cc
  k3_two_blocks    K3 without the launch bound of three blocks an SM
  k2_three_blocks  K2 with it
  k5_reg4          K5 with 16 elements a thread (kReg = 4; two passes in
                   phase B at 2^13, 32 threads a CTA) instead of 8
  k5_cluster8      K5 with clusters of at most 8 CTAs (128 threads a CTA at 2^13)
  k5_cluster4      ... of at most 4 (256 threads a CTA at 2^13)
  k5_pow2          K5 with the twiddles between passes as powers of two up to
                   w_64 (a branch for each value of t a warp holds) instead of
                   the tables
  k5_table_in_pass K5 reading its pass twiddles from the tables inside the
                   passes instead of into registers at the start
  k5_one_barrier   K5 with its exit barrier whole at the end instead of
                   arriving once the peers' shared memory has been read
  k5_row_twiddle   K5 with phase A's four-step twiddles s w_n^(k1 j2) built by
                   products from one row, s and s w_n^j2 (rows 0 and 1 of the
                   table), instead of read from the whole table
  k11_chained      K10 and K11 issuing a k32 step's products diagonal by
                   diagonal, so that consecutive products add into the same
                   accumulators, instead of plane by plane of W (consecutive
                   products into different diagonals)
  k11_wait0        K10 and K11 waiting for a step's products before the next
                   step's fragments are loaded and issued, instead of one step
                   behind (double-buffered fragments)
  k10_cols_boxes   K10's elements stage as four swizzled boxes [16 b][16
                   columns] (two wavefronts a load) instead of one unswizzled
                   box [16 b][64 columns] (four)
  k10_cols_3d      ... as one swizzled 3-D box [16 b][4][16 columns] (rows of
                   128 bytes, b-major; four wavefronts)
  k9_rows128       K9 (k-major) with tiles of at most 128 rows instead of 256
  k9_cols32        K9 with tiles of 32 columns instead of 16 (64 KB of shared
                   memory a block)
  k9_threads128    K9 with 128 threads a block (four items of 4 rows x 2
                   columns a thread at 256 rows) instead of 256 (two)
  k9_threads512    ... with 512 (one)
  k9_tma           K9 storing each 128-row half of its tile with one TMA
                   store of a 3-D box [8 planes][16 columns][128 bytes] (the
                   128-byte swizzle in shared memory) instead of 16-byte
                   vector stores
  k12_points4      K12 with 4 points a thread instead of 8 (the addition
                   chain shared by half as many points)
  k12_points12     ... with 12
  k12_points16     ... with 16
  k12_points32     ... with 32
  k12_threads256   K12 with 256 threads a block instead of 128
  k12_rolled       K12's squaring runs as loops that are not unrolled (a
                   shorter program, a counter and a branch a squaring)
  k12_reload       K12 loading each x again on the walk back (d_j = x_j - z
                   anew) instead of keeping the K denominators in registers
  k12_reload16     ... with 16 points a thread

Usage: python -m sezkp_tpu_torch.probes.ntt_variants [--variants base,mul] [--iters 50]
(needs nvcc and the card).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

from ..ops import _kernels
from ..ops import goldilocks as G
from ..ops import goldilocks_torch as FT
from ..ops import ntt_digits_torch as ND
from ..ops import ntt_torch as NT
from ._common import add_common_args, open_probe, rand_field, timeit

_K3_BOUND = "__launch_bounds__(Plan<L>::NT, Plan<L>::NT == 256 ? 3 : 1)\nntt_phase_batched_kernel"
_K2_BOUND = "__launch_bounds__(Plan<L>::NT)\nntt_phase_axis_kernel"
_K23, _K4, _K5 = ("ntt_phases.cu",), ("ntt_last.cu",), ("ntt_small.cu",)
_K9, _K10, _K11 = ("gl_digits.cu",), ("digit_dft.cu",), ("digit_dft_last.cu",)
_K12 = ("deep_divide.cu",)
# K12's walk back with d_j formed anew from a second load of x_j
_K12_RELOAD = ("deep_divide.cu", "    if (j) inv = gl::mul_cc(inv, d[j]);",
               "    if (j) inv = gl::mul_cc(inv, i0 + (long long)j * kThreads < n && !((zero >> j) & 1)\n"
               "                                     ? gl::sub(xs[i0 + (long long)j * kThreads], z) : 1);")
# K10's elements stage: the producer's load, the reader, the host's map
_K10_LOAD = "tma_load_2d(sX + ix * kXBytes, map_x, full_x + ix, h * kRows, kc * kChunk + (2 * sc + jj) * kXB);"
_K10_READ = """      const unsigned char* col = xs + (16 * w4 + g + 8 * rr) * 8;
      uint64_t e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) e[c] = *reinterpret_cast<const uint64_t*>(col + (4 * q4 + c) * kRows * 8);"""


def _k10_read(address):
    """The reader of element (b = 4 q4 + c, column ci = g + 8 rr of the warp's 16) at `address`."""
    return f"""      const int ci = g + 8 * rr;
      uint64_t e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {{
        const int b = 4 * q4 + c;
        e[c] = *reinterpret_cast<const uint64_t*>({address});
      }}"""


_K10_MAP = """  const cuuint64_t edims[2] = {oo, mm}, estr[1] = {oo * 8};
  const cuuint32_t ebox[2] = {kRows, kXB};"""
_K10_ENCODE = "tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT64, 2, x, edims, estr, ebox, false)"
_K11_PRODUCTS = """        for (int j = 0; j < kNdig; ++j)
#pragma unroll
          for (int k = 0; k < NP; ++k) {
            const int i = part_diag(WG, k) - j;"""
_K11_CHAINED = """        for (int k = 0; k < NP; ++k)
#pragma unroll
          for (int j = 0; j < kNdig; ++j) {
            const int i = part_diag(WG, k) - j;"""
_K5_REG4 = ("ntt_small.cu", "constexpr int kReg = 3;", "constexpr int kReg = 4;")


def _k5_cap(c):
    return ("ntt_small.cu", "constexpr int kClusterCap = 16;", f"constexpr int kClusterCap = {c};")


# k5_row_twiddle: s r^k1 with s = tw[j2] and r = w_n^j2 = tw[n2 + j2] / s (1/s = n = 2^L
# for the inverse); k1 = t*D + i + E*k2 for register q = i*T + k2
_K5_ROW = """  constexpr int E = PA::E, T = PA::T, D = E / T;
  const uint64_t s = __ldg(tw + j2);
  if constexpr (E == 1) {
    w[0] = s;
  } else {
    uint64_t r = __ldg(tw + n2 + j2);
    if constexpr (INV) r = gl::mul_pow2(r, L);
    uint64_t rd = r, re = r;  // r^D, r^E
    static_for<ntt_reg::ilog2(D)>([&](auto) { rd = gl::mul_cc(rd, rd); });
    static_for<ntt_reg::ilog2(E)>([&](auto) { re = gl::mul_cc(re, re); });
    uint64_t bi[D];  // s r^(t D + i)
    bi[0] = s;
    for (int e = t; e; e >>= 1) {
      if (e & 1) bi[0] = gl::mul_cc(bi[0], rd);
      rd = gl::mul_cc(rd, rd);
    }
    static_for<D - 1>([&](auto i) { bi[i + 1] = gl::mul_cc(bi[i], r); });
    uint64_t pk = re;  // r^(E k2)
    static_for<T>([&](auto k2) {
      static_for<D>([&](auto i) { w[i * T + k2] = k2 == 0 ? bi[i] : gl::mul_cc(bi[i], pk); });
      if (k2 > 0) pk = gl::mul_cc(pk, re);
    });
  }
"""


# k9_tma: tiles whose rows are a multiple of 128 leave through TMA stores of
# [8][16][128 bytes] boxes, one a 128-row half, from shared memory laid out
# as the 128-byte swizzle wants it (16-byte unit u of a 128-byte row of
# (plane, column c) at u ^ (c % 8)); smaller tiles as before
_K9_WORD = "  return (i * kCols + c) * kQ + (q ^ ((4 * (c >> 1)) & (kQ - 4)));"
_K9_TMA_WORD = """  if constexpr (kQ % 32) return (i * kCols + c) * kQ + (q ^ ((4 * (c >> 1)) & (kQ - 4)));
  else return (q / 32) * (8 * kCols * 32) + (i * kCols + c) * 32 + ((q % 32) ^ (4 * (c % 8)));"""
_K9_SIG = "long long m,\n                        long long other) {\n  extern __shared__ uint4 smem_v[];"
_K9_TMA_SIG = ("long long m,\n                        long long other, const __grid_constant__ CUtensorMap tm) {\n"
               "  extern __shared__ __align__(1024) uint4 smem_v[];")
_K9_STORE = "  __syncthreads();\n  constexpr int kVec = R / 16;"
_K9_TMA_STORE = """  if constexpr (R % 128 == 0) {
    hopper::fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      for (int h = 0; h < R / 128; ++h)
        hopper::tma_store_3d(&tm, s + h * 8 * kCols * 32, (int)(j0 + 128 * h), (int)c0, 0);
      hopper::tma_store_commit();
      hopper::tma_store_wait_read();
    }
    return;
  }
  __syncthreads();
  constexpr int kVec = R / 16;"""
_K9_LAUNCH = "  gl_digits_kmajor_kernel<R><<<grid, kThreads, smem, st>>>((const uint64_t*)x, (int8_t*)out, m, other);"
_K9_TMA_LAUNCH = """  CUtensorMap tm;
  const cuuint64_t dims[3] = {(cuuint64_t)m, (cuuint64_t)other, 8}, str[2] = {(cuuint64_t)m, (cuuint64_t)(other * m)};
  const cuuint32_t box[3] = {128, kCols, 8};
  if (R % 128 == 0 && !hopper::tensor_map(&tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, out, dims, str, box, true))
    return (int)cudaErrorNotSupported;
  gl_digits_kmajor_kernel<R><<<grid, kThreads, smem, st>>>((const uint64_t*)x, (int8_t*)out, m, other, tm);"""

# name: (the sources built, [(file, text, replacement)])
VARIANTS = {
    "base": (_K23 + _K4 + _K5 + _K9 + _K10 + _K11 + _K12, []),
    "add_sub": (_K23, [("ntt_reg.cuh", "gl::bfly(u, t, a, b);", "a = gl::add(u, t);\n  b = gl::sub(u, t);")]),
    "mul": (_K23, [("ntt_reg.cuh", "gl::mul_cc(", "gl::mul("), ("ntt_phases.cu", "gl::mul_cc(", "gl::mul(")]),
    "k3_two_blocks": (_K23, [("ntt_phases.cu", _K3_BOUND, "__launch_bounds__(Plan<L>::NT)\nntt_phase_batched_kernel")]),
    "k2_three_blocks": (_K23, [("ntt_phases.cu", _K2_BOUND,
                                "__launch_bounds__(Plan<L>::NT, Plan<L>::NT == 256 ? 3 : 1)\nntt_phase_axis_kernel")]),
    "k5_reg4": (_K5, [_K5_REG4]),
    "k5_cluster8": (_K5, [_k5_cap(8)]),
    "k5_cluster4": (_K5, [_k5_cap(4)]),
    "k5_pow2": (_K5, [("ntt_small.cu", "run_passes<S::LA, INV, false, true>", "run_passes<S::LA, INV, false, false>"),
                      ("ntt_small.cu", "run_passes<S::LB, INV, false, true>", "run_passes<S::LB, INV, false, false>")]),
    "k5_table_in_pass": (_K5, [("ntt_small.cu", "a, ta, rowa, ", "a, ta, pta, "),
                               ("ntt_small.cu", "b, tb, rowb, ", "b, tb, ptb, ")]),
    "k5_row_twiddle": (_K5, [
        ("ntt_small.cu", "template <class PA, int n2>\n__device__ __forceinline__ void four_step_twiddles(",
         "template <class PA, int n2, int L, bool INV>\n__device__ __forceinline__ void four_step_twiddles("),
        ("ntt_small.cu", "  static_for<PA::E>([&](auto q) { w[q] = __ldg(tw + emit_k<PA>(t, q) * n2 + j2); });\n",
         _K5_ROW),
        ("ntt_small.cu", "four_step_twiddles<PA, n2>(w, tw, ta, j2);", "four_step_twiddles<PA, n2, L, INV>(w, tw, ta, j2);")]),
    "k5_one_barrier": (_K5, [("ntt_small.cu", "  if constexpr (S::C > 1) cluster_arrive();\n  if (live_b)",
                              "  if (live_b)"),
                             ("ntt_small.cu", "  if constexpr (S::C > 1) cluster_wait();\n}",
                              "  if constexpr (S::C > 1) {\n    cluster_arrive();\n    cluster_wait();\n  }\n}")]),
    "k11_chained": (_K10 + _K11, [("digit_wgmma.cuh", _K11_PRODUCTS, _K11_CHAINED)]),
    "k11_wait0": (_K10 + _K11, [("digit_wgmma.cuh", "        wgmma_wait<1>();  // step s - 1 is done",
                                 "        wgmma_wait<0>();  // step s - 1 is done")]),
    "k10_cols_boxes": (_K10, [
        ("digit_wgmma.cuh", _K10_LOAD,
         "for (int u = 0; u < 4; ++u) tma_load_2d(sX + ix * kXBytes + u * (kXBytes / 4), map_x, full_x + ix, "
         "h * kRows + 16 * u, kc * kChunk + (2 * sc + jj) * kXB);"),
        ("digit_wgmma.cuh", _K10_READ,
         _k10_read("xs + w4 * (kXBytes / 4) + b * 128 + ((((ci >> 1) ^ (b & 7)) << 4) | ((ci & 1) << 3))")),
        ("digit_dft.cu", "ebox[2] = {kRows, kXB};", "ebox[2] = {16, kXB};"),
        ("digit_dft.cu", _K10_ENCODE, _K10_ENCODE.replace("false", "true"))]),
    "k10_cols_3d": (_K10, [
        ("digit_wgmma.cuh", _K10_LOAD,
         "tma_load_3d(sX + ix * kXBytes, map_x, full_x + ix, 0, 4 * h, kc * kChunk + (2 * sc + jj) * kXB);"),
        ("digit_wgmma.cuh", _K10_READ,
         _k10_read("xs + (4 * b + w4) * 128 + ((((ci >> 1) ^ ((4 * b + w4) & 7)) << 4) | ((ci & 1) << 3))")),
        ("digit_dft.cu", _K10_MAP, """  const cuuint64_t edims[3] = {16, oo / 16, mm}, estr[2] = {128, oo * 8};
  const cuuint32_t ebox[3] = {16, 4, kXB};"""),
        ("digit_dft.cu", _K10_ENCODE, _K10_ENCODE.replace(", 2, x,", ", 3, x,").replace("false", "true"))]),
    "k9_rows128": (_K9, [("gl_digits.cu", "constexpr int kMaxRows = 256;", "constexpr int kMaxRows = 128;")]),
    "k9_cols32": (_K9, [("gl_digits.cu", "constexpr int kCols = 16;", "constexpr int kCols = 32;")]),
    "k9_threads128": (_K9, [("gl_digits.cu", "constexpr int kThreads = 256;", "constexpr int kThreads = 128;")]),
    "k9_threads512": (_K9, [("gl_digits.cu", "constexpr int kThreads = 256;", "constexpr int kThreads = 512;")]),
    "k9_tma": (_K9, [("gl_digits.cu", '#include "smem_opt_in.cuh"', '#include "smem_opt_in.cuh"\n#include "tma_wgmma.cuh"'),
                     ("gl_digits.cu", _K9_WORD, _K9_TMA_WORD), ("gl_digits.cu", _K9_SIG, _K9_TMA_SIG),
                     ("gl_digits.cu", _K9_STORE, _K9_TMA_STORE), ("gl_digits.cu", _K9_LAUNCH, _K9_TMA_LAUNCH)]),
    "k12_points4": (_K12, [("deep_divide.cu", "constexpr int kPoints = 8;", "constexpr int kPoints = 4;")]),
    "k12_points12": (_K12, [("deep_divide.cu", "constexpr int kPoints = 8;", "constexpr int kPoints = 12;")]),
    "k12_points16": (_K12, [("deep_divide.cu", "constexpr int kPoints = 8;", "constexpr int kPoints = 16;")]),
    "k12_points32": (_K12, [("deep_divide.cu", "constexpr int kPoints = 8;", "constexpr int kPoints = 32;")]),
    "k12_threads256": (_K12, [("deep_divide.cu", "constexpr int kThreads = 128;", "constexpr int kThreads = 256;")]),
    "k12_rolled": (_K12, [("deep_divide.cu", "  for (int i = 0; i < n; ++i) x = gl::mul_cc(x, x);",
                           "#pragma unroll 1\n  for (int i = 0; i < n; ++i) x = gl::mul_cc(x, x);")]),
    "k12_reload": (_K12, [_K12_RELOAD]),
    "k12_reload16": (_K12, [_K12_RELOAD, ("deep_divide.cu", "constexpr int kPoints = 8;", "constexpr int kPoints = 16;")]),
}


def _build(names):
    """{variant: ctypes library}; prints ptxas's registers and spills."""
    nvcc = _kernels._find_nvcc()
    root = os.path.join(_kernels._BUILD_DIR, "variants")
    procs = {}
    for name in names:
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_kernels._CSRC, d)
        for fn, old, new in VARIANTS[name][1]:
            path = os.path.join(d, fn)
            with open(path) as f:
                text = f.read()
            if old not in text:
                raise RuntimeError(f"variant {name}: {fn} has no {old!r}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [nvcc, *_kernels._NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", d,
             *(os.path.join(d, src) for src in VARIANTS[name][0]), "-o", os.path.join(d, "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {name} did not build\n{out[-4000:]}")
        func = None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                k = re.search(r"ntt_(phase_axis|phase_batched|phase_last|small)_kernelI((?:L[ib]\d+E)+)E", m.group(1))
                args = re.findall(r"L[ib](\d+)E", k.group(2)) if k else []
                # the main path's instantiations: K2 axis 0 at m = 64, 128; K3 at 128, 256; K4 at 128, 256;
                # K5 at 2^13
                main = k and (args[2:] in ([], ["0"]) or k.group(1) == "phase_last") and args[0] in (
                    ("6", "7") if k.group(1) == "phase_axis" else ("13",) if k.group(1) == "small" else ("7", "8"))
                func = f"ntt_{k.group(1)}_kernel<{','.join(args)}>" if main else None
                if "digit_dft_last_kernel" in m.group(1):
                    func = "digit_dft_last_kernel"
                if "deep_divide_kernel" in m.group(1):
                    func = "deep_divide_kernel"
                d = re.search(r"digit_dft_kernelILi(\d)ELi(\d)E", m.group(1))
                if d:
                    func = f"digit_dft_kernel<{d.group(1)},{d.group(2)}>"
            elif func and "Used" in line:
                print(f"{name:16s} {func}: {line.split(':', 1)[1].strip()}")
        lib = ctypes.CDLL(os.path.join(root, name, "lib.so"))
        vp, ll, i, ull = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong
        if "ntt_phases.cu" in VARIANTS[name][0]:
            lib.sezkp_ntt_phase_axis.argtypes = [vp, vp, i, ll, i, i, vp, vp, ll, ull, vp]
            lib.sezkp_ntt_phase_batched.argtypes = [vp, vp, i, i, i, i, vp, vp, vp, vp]
        if "ntt_last.cu" in VARIANTS[name][0]:
            lib.sezkp_ntt_phase_last.argtypes = [vp, vp, i, i, i, i, vp, ull, vp]
        if "ntt_small.cu" in VARIANTS[name][0]:
            lib.sezkp_ntt_small.argtypes = [vp, vp, i, i, vp, vp, vp, vp]
            lib.sezkp_ntt_small_cluster.argtypes = [i]
            with open(os.path.join(root, name, "ntt_small.cu")) as f:
                lib.k5_reg_log2 = int(re.search(r"constexpr int kReg = (\d+);", f.read()).group(1))
            print(f"{name:16s} ntt_small_kernel<13,*>: a cluster of {lib.sezkp_ntt_small_cluster(13)} CTAs")
        if "gl_digits.cu" in VARIANTS[name][0]:
            lib.sezkp_gl_digits.argtypes = [vp, vp, ll, ll, ll, vp]
        if "digit_dft.cu" in VARIANTS[name][0]:
            lib.sezkp_digit_dft.argtypes = [vp, vp, vp, vp, i, ll, i, vp]
        if "digit_dft_last.cu" in VARIANTS[name][0]:
            lib.sezkp_digit_dft_last.argtypes = [vp, vp, vp, i, i, i, vp]
        if "deep_divide.cu" in VARIANTS[name][0]:
            lib.sezkp_deep_divide.argtypes = [vp, vp, vp, ll, ull, vp]
        libs[name] = lib
    return libs


def _cases(dev):
    """(label, source, call(lib), output, the port's own kernel's output,
    calls captured into a graph for each iteration, 0 for issued ones) at the
    main path's shapes."""
    cases = []
    for n_log2, inverse in ((23, False), (20, True)):
        l1, l2, l3 = NT._factor_logs(n_log2)
        m1, m2, m3 = 1 << l1, 1 << l2, 1 << l3
        ta, tb = NT._t_outer(l1, l2, l3, inverse, dev)
        tm = NT._t_mid(l2, l3, inverse, dev)
        x0, x1 = rand_field((m1, m2 * m3), n_log2, dev), rand_field((m1, m2, m3), n_log2 + 1, dev)
        y0, y1 = torch.empty_like(x0), torch.empty_like(x1)
        pt1 = NT._pass_twiddles(l1, inverse, dev).data_ptr() if l1 >= 7 else None
        pt2 = NT._pass_twiddles(l2, inverse, dev).data_ptr() if l2 >= 7 else None

        def k2(lib, x0=x0, y0=y0, l1=l1, cols=m2 * m3, m3=m3, inverse=inverse, pt1=pt1, tb=tb):
            return lib.sezkp_ntt_phase_axis(x0.data_ptr(), y0.data_ptr(), l1, cols, 0, int(inverse), pt1,
                                            tb.data_ptr(), m3, 1, _kernels.stream_ptr())

        def k3(lib, x1=x1, y1=y1, m1=m1, l2=l2, m3=m3, inverse=inverse, pt2=pt2, ta=ta, tm=tm):
            return lib.sezkp_ntt_phase_batched(x1.data_ptr(), y1.data_ptr(), m1, l2, m3, int(inverse), pt2,
                                               ta.data_ptr(), tm.data_ptr(), _kernels.stream_ptr())

        scale = G.inv(1 << n_log2) if inverse else 1
        pt3 = NT._pass_twiddles(l3, inverse, dev).data_ptr() if l3 >= 7 else None
        y2 = torch.empty((m3, m2, m1), dtype=torch.int64, device=dev)

        def k4(lib, x1=x1, y2=y2, m1=m1, m2=m2, l3=l3, inverse=inverse, pt3=pt3, scale=scale):
            return lib.sezkp_ntt_phase_last(x1.data_ptr(), y2.data_ptr(), m1, m2, l3, int(inverse), pt3, scale,
                                            _kernels.stream_ptr())

        cases.append((f"K2 [{m1}, {m2 * m3}] 2^{n_log2}", "ntt_phases.cu", k2, y0,
                       NT.phase_axis(x0, 0, inverse, tw=tb, tw_period=m3), 0))
        cases.append((f"K3 [{m1}, {m2}, {m3}] 2^{n_log2}", "ntt_phases.cu", k3, y1,
                       NT.phase_batched(x1, inverse, ta=ta, t=tm), 0))
        cases.append((f"K4 [{m1}, {m2}, {m3}] 2^{n_log2}", "ntt_last.cu", k4, y2,
                       NT.phase_last(x1, inverse, scale=scale), 0))
    for inverse in (True, False):
        p = NT.small_plan(13)
        x, y = rand_field((1 << 13,), 13 + inverse, dev), torch.empty(1 << 13, dtype=torch.int64, device=dev)
        tw = NT._small_twiddles(p["l1"], p["l2"], inverse, dev)

        def k5(lib, x=x, y=y, tw=tw, inverse=inverse, p=p):
            # the pass tables for the variant's registers a vector, for every phase of two passes or more
            pta, ptb = (NT._pass_twiddles(l, inverse, dev, lib.k5_reg_log2).data_ptr() if l > lib.k5_reg_log2
                        else None for l in (p["l1"], p["l2"]))
            return lib.sezkp_ntt_small(x.data_ptr(), y.data_ptr(), 13, int(inverse), tw.data_ptr(), pta, ptb,
                                       _kernels.stream_ptr())

        cases.append((f"K5 [8192] {'inverse' if inverse else 'forward'}", "ntt_small.cu", k5, y,
                       NT.small_ntt(x, inverse), 20))
    # K9's k-major stack and K10 on one phase of 2^23 (m = 256, other = 32768): stack in, recombined and
    # summed; elements in
    m, other = 256, 32768
    w, a = ND.w_digits(8, False, 1, dev), rand_field((m, other), 8, dev)
    stack = ND.gl_digits(a)
    y9 = torch.empty_like(stack)

    def k9(lib):
        return lib.sezkp_gl_digits(a.data_ptr(), y9.data_ptr(), m, other, 0, _kernels.stream_ptr())

    cases.append((f"K9 [{m}, {other}] k-major", "gl_digits.cu", k9, y9, stack, 1))
    for label, src, elements, epilogue in (("stack, recombined", stack, False, 1), ("stack, summed", stack, False, 0),
                                           ("elements, recombined", a, True, 1)):
        yk = torch.empty((m, other), dtype=torch.int64 if epilogue else torch.int32, device=dev)

        def k10(lib, src=src, elements=elements, epilogue=epilogue, yk=yk):
            return lib.sezkp_digit_dft(w.data_ptr(), None if elements else src.data_ptr(),
                                       src.data_ptr() if elements else None, yk.data_ptr(), m, other, epilogue,
                                       _kernels.stream_ptr())

        cases.append((f"K10 {label}", "digit_dft.cu", k10, yk,
                      ND.digit_dft(src, w, "recombine" if epilogue else "sum", elements), 1))
    # K11 on phase C of the folded forward NTT at 2^23
    l1, l2, l3 = ND._factor_logs(23)
    cols, m2, mc = 1 << l1, 1 << l2, 1 << l3
    x, wf = rand_field((cols, m2 * mc), 23, dev), ND.folded_table(l2, l3, False, 1, dev)
    y = torch.empty((mc, m2 * cols), dtype=torch.int64, device=dev)

    def k11(lib, x=x, wf=wf, y=y):
        return lib.sezkp_digit_dft_last(wf.data_ptr(), x.data_ptr(), y.data_ptr(), cols, m2, mc, _kernels.stream_ptr())

    cases.append((f"K11 [{cols}, {m2}*{mc}] 2^23", "digit_dft_last.cu", k11, y, ND.digit_dft_last(x, wf), 1))
    # K12 over the LDE's coset of a T = 2^20 prove, z on the coset (one zero denominator)
    xs = NT._deep_lde_tables(20, 23, 3, dev)[1]
    yd, z = rand_field((1 << 23,), 12, dev), int(FT.unpack(xs[7:8])[0])
    od = torch.empty_like(yd)

    def k12(lib):
        return lib.sezkp_deep_divide(yd.data_ptr(), xs.data_ptr(), od.data_ptr(), 1 << 23, z, _kernels.stream_ptr())

    cases.append(("K12 [2^23] coset", "deep_divide.cu", k12, od, NT.deep_divide(yd, z, xs), 0))
    return cases


def _replayed(fn, iters: int) -> float:
    """Seconds per call on the card alone: `iters` calls captured into one
    CUDA graph, replayed five times (the host's cost of each launch drops out)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return timeit(graph.replay, torch.device("cuda"), 5) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated subset of " + ", ".join(VARIANTS))
    add_common_args(ap)
    ap.set_defaults(iters=50)
    args = ap.parse_args(argv)
    dev = open_probe(args)
    if dev.type != "cuda":
        print("ntt_variants builds and times CUDA kernels: it needs nvcc and the card")
        return 0
    names = [v for v in args.variants.split(",") if v]
    for v in names:
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v}")
    libs = _build(names)
    cases = _cases(dev)
    ok = True
    times = {}
    for name in names + names[::-1]:
        for label, src, call, y, want, per_iter in cases:
            if src not in VARIANTS[name][0]:
                continue
            y.zero_()
            rc = call(libs[name])
            torch.cuda.synchronize(dev)
            if rc != 0 or not torch.equal(y, want):
                ok = False
                print(f"{name} {label}: rc {rc}, equal to the port's kernel: {torch.equal(y, want)}")
            fn = lambda: call(libs[name])
            ms = (_replayed(fn, per_iter * args.iters) if per_iter else timeit(fn, dev, args.iters)) * 1e3
            times.setdefault((label, name), []).append(ms)
    for (label, name), ms in times.items():
        how = "replayed" if label.startswith(("K5", "K9", "K10", "K11")) else ""
        print(f"{label:26s} {name:16s} " + " ".join(f"{t:.4f}" for t in ms) + f" ms {how}")
    print(f"equality (every variant == the port's kernels at every shape): {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
