"""The int8 rate of `wgmma.mma_async` by its N on the card.

K11 (ops/csrc/digit_dft_last.cu) accumulates 15 diagonals of N / 2 registers
each; at N = 16 all 15 fit one warpgroup, at N = 32 they must be split over
two. This probe (wgmma_rate.cu beside it, built here with nvcc) measures what
decides between them: one block of two warpgroups on every SM issuing groups
of m64nNk32 products (A from registers, B from shared memory), each group the
same int8 operations, at N = 16, 32 and 64. It prints the operations a second
against the data sheet's dense rate, and the SM clocks a product takes.

Usage: python -m sezkp_tpu_torch.probes.wgmma_rate [--iters 10] (the card only)
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

from ..ops import _kernels
from ._common import INT8_PEAK_OPS, add_common_args, open_probe, timeit

# a group's int8 operations: 64 products of m64n16k32, 32 of m64n32k32, 16 of m64n64k32
GROUP_OPS = 2 * 64 * 16 * 32 * 64
PRODUCTS = {16: 64, 32: 32, 64: 16}


def _build() -> ctypes.CDLL:
    out = os.path.join(_kernels._BUILD_DIR, "wgmma_rate.so")
    os.makedirs(_kernels._BUILD_DIR, exist_ok=True)
    subprocess.run([_kernels._find_nvcc(), *_kernels._NVCC_FLAGS, "-shared", "-I", _kernels._CSRC,
                    os.path.join(os.path.dirname(os.path.abspath(__file__)), "wgmma_rate.cu"), "-o", out], check=True)
    lib = ctypes.CDLL(out)
    lib.sezkp_wgmma_rate.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.sezkp_wgmma_rate.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap)
    args = ap.parse_args(argv)
    dev = open_probe(args)
    if dev.type != "cuda":
        print("wgmma_rate times wgmma on the card: it needs nvcc and the card")
        return 0
    lib = _build()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(sms * 256, dtype=torch.int32, device=dev)
    groups = 4096
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True).stdout.split()
    for n in (16, 32, 64):
        call = lambda: lib.sezkp_wgmma_rate(n, sms, groups, out.data_ptr(), _kernels.stream_ptr())
        rc = call()
        torch.cuda.synchronize(dev)
        if rc:
            print(f"N={n}: launch failed with cudaError {rc}")
            return 1
        s = timeit(call, dev, args.iters)
        ops = GROUP_OPS * groups * 2 * sms
        clocks = f", {s * float(clock[0]) * 1e6 / (PRODUCTS[n] * groups * 2):.2f} SM clocks a product at " \
                 f"{clock[0]} MHz" if clock else ""
        print(f"m64n{n}k32 s8: {s * 1e3:.3f} ms, {ops / s * 1e-12:.1f} TOPS, "
              f"{ops / s / INT8_PEAK_OPS:.3f} of the dense {INT8_PEAK_OPS * 1e-12:.0f}{clocks}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
