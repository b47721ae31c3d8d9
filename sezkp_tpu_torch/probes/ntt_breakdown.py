"""Decompose one digit-form DFT phase into digits / dots / recombine costs,
beside the butterfly kernels on the same input.

Counterpart of scripts/exp_ntt_breakdown.py, following the production
functions that script meant to time (ntt_mxu._digits, _dot_digits with NDIG = 8
and 64 products, _recombine):

  digits      : elements -> 8 int8 digit planes (K9), k-major and, with
                --tile, the tiled stack
  dots        : int8 digit stack -> 64 digit products -> sum of the diagonals (K10)
  dots+rec    : int8 digit stack -> products -> recombination mod p (K10)
  full digit  : elements -> digits + products + recombination in one launch (K10)
  K2          : the same phase on the butterfly kernel (ntt_phase_axis)
  phase A/B/C : the three phases of the production transform (K2, K3, K4)
  transpose   : a separate order-restoring [m1,m2,m3] -> [m3,m2,m1] pass

The full digit phase and dots+rec over K9's stack must equal K2 bit for bit;
the probe exits 1 if they do not.

Usage: python -m sezkp_tpu_torch.probes.ntt_breakdown [--k 23] [--tile N]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops import ntt_digits_torch as ND
from ..ops import ntt_torch as NT
from ._common import HBM_BYTES_PER_S, add_common_args, open_probe, rand_field, rand_i8, timeit, tops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--k", type=int, default=23)
    ap.add_argument("--tile", type=int, default=None, help="also time K9's tiled stack with this tile")
    add_common_args(ap)
    args = ap.parse_args(argv)
    dev = open_probe(args)

    k = args.k
    n = 1 << k
    logs = ND._factor_logs(k)
    m_log2 = max(logs)
    m = 1 << m_log2
    other = n // m
    print(f"n=2^{k} factors={logs} m=2^{m_log2} other={other}")

    def line(name, fn, extra=lambda dt: ""):
        dt = timeit(fn, dev, args.iters)
        print(f"{name:18s}: {dt * 1e3:8.3f} ms  {extra(dt)}", flush=True)
        return dt

    a = rand_field((m, other), 0, dev)
    w = ND.w_digits(m_log2, False, 1, dev)
    x8 = rand_i8((ND.NDIG, other, m), 1, dev)
    macs = ND.NDIG * ND.NDIG * m * n
    gbs = lambda nbytes: (lambda dt: f"({nbytes / dt / 1e9:7.1f} GB/s of {HBM_BYTES_PER_S / 1e9:.0f} data-sheet)")

    line("digits (k-major)", lambda: ND.gl_digits(a), gbs(16 * n))
    if args.tile:
        line(f"digits (tile {args.tile})", lambda: ND.gl_digits(a, args.tile), gbs(16 * n))
    line("dots only", lambda: ND.digit_dft(x8, w, "sum"), lambda dt: tops(macs, dt))
    line("dots + recombine", lambda: ND.digit_dft(x8, w, "recombine"), lambda dt: tops(macs, dt))
    line("full digit phase", lambda: ND.digit_dft(a, w, "recombine", elements=True), lambda dt: tops(macs, dt))
    line("K2 (butterflies)", lambda: NT.phase_axis(a, 0, False), gbs(16 * n))

    want = NT.phase_axis(a, 0, False)
    ok = torch.equal(ND.digit_dft(a, w, "recombine", elements=True), want)
    ok = ok and torch.equal(ND.digit_dft(ND.gl_digits(a), w, "recombine"), want)
    print(f"bit_equal={ok} (full digit phase == dots+rec over K9's stack == K2)", flush=True)

    if len(logs) == 3:
        l1, l2, l3 = logs
        m1, m2, m3 = 1 << l1, 1 << l2, 1 << l3
        ta, tb = NT._t_outer(l1, l2, l3, False, dev)
        tm = NT._t_mid(l2, l3, False, dev)
        x2 = a.reshape(m1, m2 * m3)
        x3 = a.reshape(m1, m2, m3)
        line("phase A (K2, +tw)", lambda: NT.phase_axis(x2, 0, False, tw=tb, tw_period=m3), gbs(16 * n))
        line("phase B (K3)", lambda: NT.phase_batched(x3, False, ta=ta, t=tm), gbs(16 * n))
        line("phase C (K4)", lambda: NT.phase_last(x3, False), gbs(16 * n))
        line("phase C (K11)", lambda: ND.digit_dft_last(x2, ND.folded_table(l2, l3, False, 1, dev)),
             lambda dt: tops(ND.NDIG * ND.NDIG * m3 * n, dt))
        line("final transpose", lambda: x3.permute(2, 1, 0).contiguous(), gbs(16 * n))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
