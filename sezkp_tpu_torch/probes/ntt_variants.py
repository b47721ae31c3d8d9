"""A/B of the design choices of K2 ntt_phase_axis, K3 ntt_phase_batched and
K4 ntt_phase_last.

Each variant is this checkout's ops/csrc with one text edit, the sources it
concerns (ntt_phases.cu for K2/K3, ntt_last.cu for K4) built into a library
of its own (nvcc, all variants at once, under
sezkp_tpu_torch/_build/variants/). The main-path shapes of a T = 2^20 prove
(the coset NTT at 2^23, the base inverse NTT at 2^20) are timed with CUDA
events in turns: every variant, then every variant again in reverse order.
Each variant's outputs must equal the port's own kernels'. ptxas's registers
and spills of the main-path instantiations are printed.

  base             the sources as they are
  add_sub          butterflies as gl::add + gl::sub (64-bit compares and
                   selects) instead of gl::bfly's carry chains
  mul              general products as gl::mul instead of gl::mul_cc
  k3_two_blocks    K3 without the launch bound of three blocks an SM
  k2_three_blocks  K2 with it

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
from ..ops import ntt_torch as NT
from ._common import add_common_args, open_probe, rand_field, timeit

_K3_BOUND = "__launch_bounds__(Plan<L>::NT, Plan<L>::NT == 256 ? 3 : 1)\nntt_phase_batched_kernel"
_K2_BOUND = "__launch_bounds__(Plan<L>::NT)\nntt_phase_axis_kernel"
_K23, _K4 = ("ntt_phases.cu",), ("ntt_last.cu",)
# name: (the sources built, [(file, text, replacement)])
VARIANTS = {
    "base": (_K23 + _K4, []),
    "add_sub": (_K23, [("ntt_reg.cuh", "gl::bfly(u, t, a, b);", "a = gl::add(u, t);\n  b = gl::sub(u, t);")]),
    "mul": (_K23, [("ntt_reg.cuh", "gl::mul_cc(", "gl::mul("), ("ntt_phases.cu", "gl::mul_cc(", "gl::mul(")]),
    "k3_two_blocks": (_K23, [("ntt_phases.cu", _K3_BOUND, "__launch_bounds__(Plan<L>::NT)\nntt_phase_batched_kernel")]),
    "k2_three_blocks": (_K23, [("ntt_phases.cu", _K2_BOUND,
                                "__launch_bounds__(Plan<L>::NT, Plan<L>::NT == 256 ? 3 : 1)\nntt_phase_axis_kernel")]),
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
                k = re.search(r"ntt_phase_(axis|batched|last)_kernelI((?:L[ib]\d+E)+)E", m.group(1))
                args = re.findall(r"L[ib](\d+)E", k.group(2)) if k else []
                # the main path's instantiations: K2 axis 0 at m = 64, 128; K3 at 128, 256; K4 at 128, 256
                main = k and (args[2:] in ([], ["0"]) or k.group(1) == "last") and args[0] in (
                    ("6", "7") if k.group(1) == "axis" else ("7", "8"))
                func = f"ntt_phase_{k.group(1)}_kernel<{','.join(args)}>" if main else None
            elif func and "Used" in line:
                print(f"{name:16s} {func}: {line.split(':', 1)[1].strip()}")
        lib = ctypes.CDLL(os.path.join(root, name, "lib.so"))
        vp, ll, i, ull = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong
        if "ntt_phases.cu" in VARIANTS[name][0]:
            lib.sezkp_ntt_phase_axis.argtypes = [vp, vp, i, ll, i, i, vp, vp, ll, ull, vp]
            lib.sezkp_ntt_phase_batched.argtypes = [vp, vp, i, i, i, i, vp, vp, vp, vp]
        if "ntt_last.cu" in VARIANTS[name][0]:
            lib.sezkp_ntt_phase_last.argtypes = [vp, vp, i, i, i, i, vp, ull, vp]
        libs[name] = lib
    return libs


def _cases(dev):
    """(label, source, call(lib), output, the port's own kernel's output) at the main path's shapes."""
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
                       NT.phase_axis(x0, 0, inverse, tw=tb, tw_period=m3)))
        cases.append((f"K3 [{m1}, {m2}, {m3}] 2^{n_log2}", "ntt_phases.cu", k3, y1,
                       NT.phase_batched(x1, inverse, ta=ta, t=tm)))
        cases.append((f"K4 [{m1}, {m2}, {m3}] 2^{n_log2}", "ntt_last.cu", k4, y2,
                       NT.phase_last(x1, inverse, scale=scale)))
    return cases


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
        for label, src, call, y, want in cases:
            if src not in VARIANTS[name][0]:
                continue
            rc = call(libs[name])
            torch.cuda.synchronize(dev)
            if rc != 0 or not torch.equal(y, want):
                ok = False
                print(f"{name} {label}: rc {rc}, equal to the port's kernel: {torch.equal(y, want)}")
            times.setdefault((label, name), []).append(timeit(lambda: call(libs[name]), dev, args.iters) * 1e3)
    for (label, name), ms in times.items():
        print(f"{label:26s} {name:16s} " + " ".join(f"{t:.4f}" for t in ms) + " ms")
    print(f"equality (every variant == the port's kernels at every shape): {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
