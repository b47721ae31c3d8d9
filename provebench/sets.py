"""Run one cell several times and report each metric's median and spread.

    python3 provebench/sets.py --workload <cell> --seeds 1,2,3 [--seconds 30]
        [--trace 0] [--sets 1] [--out FILE]

Each run is `provebench/run.py` in a process of its own, one after another,
with the seeds in the order given; `--sets 2` runs the same seeds twice. It
prints every run's result line and, for each set, each metric's median and
its spread: the distance between the first and third quartiles
(`statistics.quantiles(values, n=4)`) as a share of the median. `--out`
appends every run's result and its standard error's tail as JSON lines.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    here = os.path.dirname(os.path.abspath(__file__))
    bad = 0
    for k in range(args.sets):
        values = {}
        for seed in seeds:
            cmd = [sys.executable, os.path.join(here, "run.py"), "--workload", args.workload,
                   "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
            t0 = time.time()
            p = subprocess.run(cmd, capture_output=True, text=True)
            wall = time.time() - t0
            lines = p.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1])
            except (IndexError, json.JSONDecodeError):
                res = None
            tail = p.stderr[-3000:]
            print(f"set {k} seed {seed} rc {p.returncode} wall {wall:.1f} s: "
                  f"{json.dumps(res) if res else tail}", flush=True)
            if res is None or not res.get("correct"):
                bad += 1
                print(tail, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps({"set": k, "seed": seed, "rc": p.returncode, "wall": wall,
                                        "result": res, "stderr_tail": tail}) + "\n")
            for name, m in (res or {}).get("metrics", {}).items():
                values.setdefault(name, []).append(m["value"])
        for name, vals in sorted(values.items()):
            s = spread(vals)
            print(f"set {k} {name}: n {len(vals)} median {statistics.median(vals)!r} "
                  f"spread {s!r} values {vals!r}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
