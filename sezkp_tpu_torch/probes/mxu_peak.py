"""Probe the int8 tensor-core rate that a hand-written kernel reaches.

Counterpart of scripts/exp_mxu_peak.py for K8 `i8_gemm`: times the stacked
digit-style products (nrep weight blocks against one wide operand, as nrep
products and as one fused product), the large square products with int32 and
with `& 127` int8 output, and `torch._int_mm` (cuBLASLt) at the same shapes
as the library's yardstick. Rates are stated against the H100 data sheet.

The script's stale "9 digits" is NDIG = 8 here, and the column count of the
large products is cut from the script's 2^24 to what one 80 GB card holds
(int8 [1024, 2^24] is 17.2 GB and its int32 product 68.7 GB).

Usage: python -m sezkp_tpu_torch.probes.mxu_peak [--other-log2 16] [--big-log2 22]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops import ntt_digits_torch as ND
from ._common import add_common_args, int_mm_sum, open_probe, rand_i8, timeit, tops

SCRIPT_BIG_LOG2 = 24  # the column count of the script's large products
CHECK_SLAB = 1 << 18  # the whole width is held against the plain version, this many columns at a time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other-log2", type=int, default=16, help="columns of the digit-style phase (2^16: the 2^24 phase)")
    ap.add_argument("--big-log2", type=int, default=22, help="columns of the large square products")
    add_common_args(ap)
    args = ap.parse_args(argv)
    dev = open_probe(args)
    on_card = dev.type == "cuda"
    ok = True

    def bench(name, w, x, nrep, epilogue, fuse, macs):
        nonlocal ok
        # every column of the timed product against the plain version (whose
        # float64 operands do not fit at full width: in column slabs)
        got = ND.i8_gemm(w, x, nrep, epilogue, fuse)
        for c in range(0, x.shape[1], CHECK_SLAB):
            xs = x[:, c : c + CHECK_SLAB].contiguous()
            gs = got[:, c : c + CHECK_SLAB]
            if not torch.equal(gs, ND.i8_gemm_plain(w, xs, nrep, epilogue)):
                ok = False
                print(f"{name}: K8 != plain version in columns {c}..{c + xs.shape[1]}")
            if on_card and epilogue == "int32" and not torch.equal(gs, int_mm_sum(w, xs, nrep)):
                ok = False
                print(f"{name}: K8 != torch._int_mm in columns {c}..{c + xs.shape[1]}")
        del got
        dt = timeit(lambda: ND.i8_gemm(w, x, nrep, epilogue, fuse), dev, args.iters)
        print(f"{name:46s}: {dt * 1e3:8.3f} ms {tops(macs, dt)}", flush=True)

    def bench_library(name, w, x, nrep, macs):
        if not on_card:
            return
        dt = timeit(lambda: int_mm_sum(w, x, nrep), dev, args.iters)
        print(f"{name:46s}: {dt * 1e3:8.3f} ms {tops(macs, dt)}", flush=True)

    # the digit-style phase: m = 256, NDIG weight blocks, NDIG planes side by side
    m, other, nd = 256, 1 << args.other_log2, ND.NDIG
    w = rand_i8((nd * m, m), 1, dev)
    x = rand_i8((m, nd * other), 2, dev)
    macs = nd * m * m * nd * other
    bench(f"{nd} dots [{m},{m}]@[{m},{nd}*{other}]", w, x, nd, "int32", False, macs)
    bench(f"1 dot [{nd * m},{m}]@[{m},{nd}*{other}] row blocks summed", w, x, nd, "int32", True, macs)
    bench_library(f"torch._int_mm x{nd} + adds, same shapes", w, x, nd, macs)
    del w, x

    big = 1 << args.big_log2
    if args.big_log2 < SCRIPT_BIG_LOG2:
        print(f"large products: 2^{args.big_log2} columns in place of the script's 2^{SCRIPT_BIG_LOG2} "
              f"(what one 80 GB card holds)")
    for mm in (1024, 512):
        w = rand_i8((mm, mm), 3 + mm, dev)
        x = rand_i8((mm, big), 4 + mm, dev)
        bench(f"1 dot [{mm},{mm}]@[{mm},2^{args.big_log2}] i32-out", w, x, 1, "int32", False, mm * mm * big)
        bench_library(f"torch._int_mm [{mm},{mm}]@[{mm},2^{args.big_log2}]", w, x, 1, mm * mm * big)
        if mm == 1024:
            bench(f"1 dot [{mm},{mm}]@[{mm},2^{args.big_log2}] i8-out (&127)", w, x, 1, "and127", False,
                  mm * mm * big)
        del w, x
    print("equality over every column (K8 == plain version" + (" == torch._int_mm" if on_card else "") + f"): {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
