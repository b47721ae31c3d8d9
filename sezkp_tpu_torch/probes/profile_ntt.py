"""Phase-level timing breakdown of the port's forward NTT at a given size.

Counterpart of scripts/profile_ntt_mxu.py for ops/ntt_torch: the full forward
transform, one DFT phase in isolation (K2), the digit decomposition alone
(K9), and the int8 products of one digit-form phase at the same shapes, by
the hand-written K8 and by the bare library matmul (`torch._int_mm`, cuBLASLt;
timed here, used nowhere in the port). With --trace DIR a torch.profiler
trace of one chained run is written there (Chrome trace format) and the
kernels are listed by device time.

Usage: python -m sezkp_tpu_torch.probes.profile_ntt [--k 23] [--trace DIR]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops import ntt_digits_torch as ND
from ..ops import ntt_torch as NT
from ..utils.tracing import device_trace
from ._common import add_common_args, int_mm_sum, open_probe, rand_field, rand_i8, timeit, tops

CHAIN = 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--k", type=int, default=23)
    ap.add_argument("--trace", default=None, help="directory for a torch.profiler Chrome trace")
    add_common_args(ap)
    args = ap.parse_args(argv)
    dev = open_probe(args)

    k = args.k
    n = 1 << k
    a = rand_field((n,), 0, dev)
    logs = ND._factor_logs(k)
    print(f"n=2^{k} factors={logs}")

    def chained():
        x = a
        for _ in range(CHAIN):
            x = NT.forward_ntt(x)
        return x

    dt = timeit(chained, dev, args.iters) / CHAIN
    print(f"full forward: {dt * 1e3:.3f} ms  ({n / dt / 1e9:.2f} Gpts/s)", flush=True)

    m_log2 = max(logs)
    m = 1 << m_log2
    other = n // m
    x2 = a.reshape(m, other)
    dt_p = timeit(lambda: NT.phase_axis(x2, 0, False), dev, args.iters)
    print(f"one phase (K2, m=2^{m_log2}): {dt_p * 1e3:.3f} ms "
          f"(x{len(logs)} phases = {len(logs) * dt_p * 1e3:.3f} ms)", flush=True)

    # the int8 products of one digit-form phase: NDIG products of [m, m] @
    # [m, NDIG * other], summed
    w8 = rand_i8((ND.NDIG * m, m), 1, dev)
    x8 = rand_i8((m, ND.NDIG * other), 2, dev)
    macs = ND.NDIG * ND.NDIG * m * m * other
    xs = x8[:, : min(4096, x8.shape[1])].contiguous()
    ok = torch.equal(ND.i8_gemm(w8, xs, ND.NDIG, "int32", True), ND.i8_gemm_plain(w8, xs, ND.NDIG))
    if dev.type == "cuda" and m % 64 == 0:
        def bare():
            return int_mm_sum(w8, x8, ND.NDIG)

        dt_m = timeit(bare, dev, args.iters)
        print(f"bare {ND.NDIG * ND.NDIG}-dot int8 matmul (torch._int_mm, same shapes): "
              f"{dt_m * 1e3:.3f} ms {tops(macs, dt_m)}", flush=True)
        ok = ok and torch.equal(bare(), ND.i8_gemm(w8, x8, ND.NDIG, "int32", True))
    dt_k = timeit(lambda: ND.i8_gemm(w8, x8, ND.NDIG, "int32", True), dev, args.iters)
    print(f"the same products by K8 i8_gemm: {dt_k * 1e3:.3f} ms {tops(macs, dt_k)}", flush=True)
    del w8, x8

    dt_d = timeit(lambda: ND.gl_digits(x2), dev, args.iters)
    print(f"digit decomposition alone (K9): {dt_d * 1e3:.3f} ms", flush=True)

    if args.trace:
        with device_trace(args.trace) as prof:
            chained()
        rows = sorted(prof.key_averages(), key=lambda e: -getattr(e, "device_time_total", 0))
        print(f"trace written to {args.trace}; kernels by device time over {CHAIN} transforms:")
        for e in rows[:8]:
            us = getattr(e, "device_time_total", 0)
            if us > 0:
                print(f"  {e.key[:72]:72s} {us / 1e3:9.3f} ms  x{e.count}")
    print("equality (K8 == plain version" + (" == torch._int_mm" if dev.type == "cuda" else "") + f"): {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
