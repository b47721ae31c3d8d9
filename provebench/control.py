"""The control's readings at a cell's own size, on the card.

    python3 provebench/control.py --workload <cell> --seeds 1,2,3 [--seconds 5]

For each seed, a run of the cell with the control (the reference with one
guarantee of the configuration broken, backends/<backend>.py) in the
program's place: the same inputs, a short window, the same check. Prints
each run's compared numbers and whether the run came out correct, which it
must not. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(1, root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        benchmark = json.load(f)
    import harness

    wrong = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(benchmark, args.workload, seed, args.seconds, False, args.device,
                             time.perf_counter(), use_control=True)
        print(json.dumps({"control": args.workload, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "checks": r["checks"]}), flush=True)
        wrong += not r["correct"]
    return 0 if wrong == len(args.seeds.split(",")) else 1


if __name__ == "__main__":
    sys.exit(main())
