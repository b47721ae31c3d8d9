"""Same-process A/B of the twiddle-folded last phase against the production
forward NTT.

Counterpart of scripts/ntt_twiddle_fold_ab.py. The production three-factor
transform (ops/ntt_torch.forward_ntt) applies the middle twiddle
Tmid[k2, b3] = w_r^(k2 b3) at the end of phase B (K3). From phase C's point of
view that is a scaling of its input columns, so it folds into per-k2 tables

    W3'[k2][k3, b3] = W3[k3, b3] * Tmid[k2, b3]   (canonical mod p)

and phase C becomes the digit-form kernel K11 reading NDIG * n table bytes
(ops/ntt_digits_torch.forward_ntt_folded). Bit equality is checked first
(exit 1 if it fails); then both are timed in turns, A/B/A/B, each the median
of min(REPS, --iters) runs of CHAIN transforms, and one JSON line is printed.

Usage: python -m sezkp_tpu_torch.probes.twiddle_fold_ab [--k 23] [--skip-timing]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from ..ops import ntt_digits_torch as ND
from ..ops import ntt_torch as NT
from ._common import add_common_args, device_line, open_probe, rand_field, timeit

CHAIN = 4
REPS = 7


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--k", type=int, default=23)
    ap.add_argument("--skip-timing", action="store_true")
    add_common_args(ap)
    args = ap.parse_args(argv)
    dev = open_probe(args)

    n = 1 << args.k
    a = rand_field((n,), 0, dev)
    l1, l2, l3 = ND._factor_logs(args.k)
    wf = ND.folded_table(l2, l3, False, 1, dev)

    ok = torch.equal(ND.forward_ntt_folded(a), NT.forward_ntt(a))
    print(f"bit_equal={ok}", flush=True)
    if not ok:
        print(json.dumps({"error": "folded variant not bit-identical"}))
        return 1
    if args.skip_timing:
        return 0

    def chain(f):
        def run():
            x = a
            for _ in range(CHAIN):
                x = f(x)
            return x
        return run

    def med(f):
        ts = sorted(timeit(chain(f), dev, 1) / CHAIN for _ in range(max(1, min(REPS, args.iters))))
        return ts[len(ts) // 2], (ts[-1] - ts[0]) / ts[len(ts) // 2]

    # in turns, to share any drift
    b1, bs1 = med(NT.forward_ntt)
    f1, fs1 = med(ND.forward_ntt_folded)
    b2, bs2 = med(NT.forward_ntt)
    f2, fs2 = med(ND.forward_ntt_folded)
    base_s, fold_s = min(b1, b2), min(f1, f2)
    print(json.dumps({
        "k": args.k,
        "device": device_line(dev),
        "base_ms": round(base_s * 1e3, 3),
        "fold_ms": round(fold_s * 1e3, 3),
        "speedup": round(base_s / fold_s, 4),
        "base_pts_per_sec": round(n / base_s),
        "fold_pts_per_sec": round(n / fold_s),
        "spreads": [round(x, 3) for x in (bs1, fs1, bs2, fs2)],
        "table_bytes": int(wf.numel()),
        "loadavg_1m": round(os.getloadavg()[0], 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
