#!/usr/bin/env python3
"""Score one finished episode of the PyTorch/CUDA port with its judges.

    python -m activesplat_tpu_torch.runtime.launch --scene_id two_room --results_dir DIR
    python3 scripts/judge_episode.py DIR [--scene_id two_room --seed 0 --steps 500 --res 256]

Reads DIR/actions.txt and DIR/gaussians_data/, which the launcher writes,
and prints the coverage judge's row (eval_actions in a fresh dataset of the
episode's configuration: 200,000 GT samples, 5 cm), the map-quality judge
(eval_map_quality, exact at k_per_tile --k over every --stride-th dumped
frame) and the NVS judge (eval_nvs_from_dump, hold-out every 5th frame),
each with its wall time, the card's name and power limit, and one JSON line
of everything last. The scene arguments must be the episode's: the
coverage judge replays the actions in a dataset made from them.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("results_dir")
    parser.add_argument("--scene_id", default="two_room", choices=["two_room", "single_room"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--res", type=int, default=256)
    parser.add_argument("--k", type=int, default=1024, help="k_per_tile of the exact renders")
    parser.add_argument("--stride", type=int, default=10, help="score every stride-th frame")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from activesplat_tpu_torch.eval.nvs import eval_nvs_from_dump
    from activesplat_tpu_torch.eval.replay import eval_actions, eval_map_quality
    from activesplat_tpu_torch.runtime.launch import make_synthetic_dataset

    card = "cpu"
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    gdir = os.path.join(args.results_dir, "gaussians_data")
    params = os.path.join(gdir, "params.npz")

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        if args.device != "cpu":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cov, cov_s = timed(lambda: eval_actions(
        make_synthetic_dataset(args.scene_id, args.seed, args.steps, args.res, args.res),
        os.path.join(args.results_dir, "actions.txt")))
    print(f"coverage (completeness m, completeness_ratio, accuracy m, path_length m): "
          f"{cov.as_row()}, {cov.num_observed_points} observed points, {cov_s:.1f} s on the host")
    quality, q_s = timed(lambda: eval_map_quality(params, gdir, frame_stride=args.stride,
                                                  k_per_tile=args.k, device=args.device))
    print(f"map quality (every {args.stride}th frame, exact at k={args.k}): "
          f"{json.dumps(quality)}, {q_s:.1f} s on {card}")
    nvs, n_s = timed(lambda: eval_nvs_from_dump(params, gdir, k_per_tile=args.k,
                                                device=args.device))
    print(f"NVS (hold-out every 5th frame): {json.dumps(nvs)}, {n_s:.1f} s on {card}")
    print(json.dumps({"card": card, "coverage": {
        "completeness": cov.completeness, "completeness_ratio": cov.completeness_ratio,
        "accuracy": cov.accuracy, "path_length": cov.path_length,
        "num_observed_points": cov.num_observed_points}, "map_quality": quality, "nvs": nvs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
