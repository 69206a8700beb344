"""The readings that the limits of `correct` are set from, for one cell, on
several seeds in one process: each seed runs the cell with a short window
and compares the program, the control (the reference under TF32 in the
program's place) and each planted fault with the float32 reference on the
same captures.

    python3 benchmark/tools/readings.py --workload <name> --seconds 10 --seeds 1 2 3 \\
        [--count densify=6]
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

VARIANTS = ("program", "control", "unchanged", "half_batch", "altered")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--count", nargs="*", default=[],
                        help="kind=n: check n of the kind's first `within` calls")
    args = parser.parse_args()

    from benchmark.harness.episode import cell_files, run_cell

    traffic = cell_files(args.workload)["traffic"]
    for item in args.count:
        kind, n = item.split("=")
        traffic["sample"][kind]["count"] = int(n)

    for seed in args.seeds:
        t = time.perf_counter()
        readings = {}
        result = run_cell(args.workload, seed, args.seconds, False, variants=VARIANTS,
                          traffic=traffic,
                          readings=readings, log=lambda m: print(m, flush=True))
        print("readings " + json.dumps({"workload": args.workload, "seed": seed,
                                        "correct": result["correct"], "readings": readings,
                                        "seconds": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
