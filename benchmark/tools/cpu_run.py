"""A whole run of a cell on the CPU at a tiny size (64x64, short window), for
the benchmark's tests: the harness's path with the program's CPU twins in
place of the card. Prints the result, the modules of JAX or the JAX package
loaded, and with --readings the numbers of each variant.

    python3 benchmark/tools/cpu_run.py --workload gibson_high_resolution.explore --seed 3 \\
        [--fault half_batch] [--warm 20] [--seconds 5] [--trace 1]
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def tiny_config(workload: str, res: int, warm: int, tmp: Path):
    from benchmark.harness.episode import BENCH, cell_files

    conf = cell_files(workload)["config"]
    yaml = BENCH / "configs" / "env" / Path(conf["env"]["config"]).name
    text = yaml.read_text()
    for key in ("width", "height"):
        text = text.replace(f"{key}: {conf['benchmark']['camera'][key]}", f"{key}: {res}")
    tmp.mkdir(parents=True, exist_ok=True)
    small = tmp / f"tiny-{res}.yaml"
    small.write_text(text)
    conf["env"]["config"] = str(small)
    conf["benchmark"]["camera"].update(width=res, height=res)
    conf["benchmark"]["warm_actions"] = warm
    return conf


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", default="gibson_high_resolution.explore")
    parser.add_argument("--seed", type=int, default=3)
    parser.add_argument("--res", type=int, default=64)
    parser.add_argument("--warm", type=int, default=20)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--trace", type=int, default=0)
    parser.add_argument("--fault", default=None)
    parser.add_argument("--tmp", default=None)
    args = parser.parse_args()

    import tempfile

    import torch

    torch.set_num_threads(2)
    from benchmark.harness.episode import cell_files, forbidden_modules, run_cell
    from benchmark.harness.faults import FAULTS

    tmp = Path(args.tmp or tempfile.mkdtemp())
    conf = tiny_config(args.workload, args.res, args.warm, tmp)
    # a few actions a second on the CPU: check the window's first calls
    traffic = cell_files(args.workload)["traffic"]
    traffic["sample"] = {kind: {"within": min(s["within"], 4), "count": 1}
                         for kind, s in traffic["sample"].items()}
    fault = FAULTS[args.fault]() if args.fault else None
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device="cpu",
                      config=conf, traffic=traffic, fault=fault,
                      log=lambda m: print(m, file=sys.stderr))
    print(json.dumps({"forbidden": forbidden_modules()}))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
