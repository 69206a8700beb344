"""The map's growth against the action count in one cell: a diagnostic run
with no warm prefix that reads the Gaussian count every `--every` actions
(each read synchronizes, so its times are not the benchmark's).

    python3 benchmark/tools/growth.py --workload <name> --seed <n> --seconds <s>
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=120.0)
    parser.add_argument("--every", type=int, default=10)
    args = parser.parse_args()

    import torch

    from benchmark.harness.episode import cell_files, run_cell

    conf = cell_files(args.workload)["config"]
    conf["benchmark"]["warm_actions"] = 0
    t0 = time.perf_counter()

    def probe(step, node):
        if node is not None and step % args.every == 0:
            torch.cuda.synchronize()
            print(f"growth {args.workload} action {step} gaussians "
                  f"{int(node.mapper.num_gaussians())} t {time.perf_counter() - t0:.2f}",
                  flush=True)

    result = run_cell(args.workload, args.seed, args.seconds, False, config=conf, probe=probe)
    print("growth done", result["metrics"], result["checks"])


if __name__ == "__main__":
    main()
