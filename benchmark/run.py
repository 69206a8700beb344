"""Run one cell of the benchmark once and print its result as the last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program
(activesplat_tpu_torch) beside this folder. It needs as many CUDA devices as
the cell asks for, and exits with another code than 0, printing no result,
when they are missing, when the program cannot be imported, or when a module
of JAX or the JAX package is loaded once the window has closed. Each number
compared with the plain reference is printed beside its limit as the last
lines of standard error and under "checks", the last key of the result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = parser.parse_args(argv)

    # the program runs with its defaults: no ACTIVESPLAT_* switch
    for key in [k for k in os.environ if k.startswith("ACTIVESPLAT_")]:
        del os.environ[key]
    # build and kernel caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "benchmark" / "cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "benchmark" / "cache" / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness.episode import cell_files, forbidden_modules, run_cell

    chips = int(cell_files(args.workload)["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2

    def log(msg):
        print(msg, flush=True)

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_process=T_PROCESS, log=log)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
