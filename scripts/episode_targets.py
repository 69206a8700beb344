#!/usr/bin/env python3
"""Run one hermetic exploration episode and report where the planner's
targets went.

    python3 scripts/episode_targets.py [--steps N] [--res R] [--bin_kernel]
        [--deterministic] [--device cuda|cpu] [--lean] [--package NAME] [--poison BYTE]
        [--out FILE]

The episode is `run_episode` at `make_synthetic_dataset`'s configuration
(two_room seed 0, 256x256, MapperConfig(), pixel_max 360), cut to N steps
(default 500, the uncut budget). By default it is the PyTorch port's on one
CUDA card. With --bin_kernel the bin kernel route (B6) is on; with
--deterministic PyTorch's deterministic algorithms are on (warn_only: the
operators without one are listed on standard error). For a run on the CPU,
--device cpu, a smaller sensor (--res) and --lean (a 16,384-to-131,072
Gaussian buffer, k_per_tile 1,024 from the start, no exact online metrics)
keep it to minutes; with --package activesplat_tpu the JAX package runs the
same episode (the planner's top-down map keeps its 360 px). With --poison
BYTE the card's cached memory is filled with BYTE before the episode (about
7 GB, in blocks of the allocator's small and large pools, then freed): a
read of memory no one wrote then shows as a different trajectory from a run
without it.

Prints, as one JSON object on the last line (and into FILE if given): the
wall, the Gaussian count, the explored free area, each planned target with
its closest approach and whether it was reached (chip_smoke.py's
target_timeline), and digests of the visited pixels after every 50 actions
and of the final parameters, so that two runs can be compared for where
their trajectories part. Several copies can run at once on one card to
sample run-to-run spread.
"""

import argparse
import hashlib
import importlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
LEAN = dict(initial_capacity=1 << 14, max_capacity=1 << 17, k_per_tile=1024,
            exact_online_metrics=False)


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--bin_kernel", action="store_true")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lean", action="store_true")
    ap.add_argument("--package", default="activesplat_tpu_torch")
    ap.add_argument("--poison", type=lambda v: int(v, 0), default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np

    import chip_smoke

    pkg = a.package
    launch = importlib.import_module(f"{pkg}.runtime.launch")
    planner_fsm = importlib.import_module(f"{pkg}.runtime.planner_fsm")
    config = importlib.import_module(f"{pkg}.mapper.config")
    load_params = importlib.import_module(f"{pkg}.io.params_io").load_params
    kwargs = {"mapper_cfg": config.MapperConfig(**(LEAN if a.lean else {}))}
    port = pkg == "activesplat_tpu_torch"
    if port:
        import torch

        if a.device == "cuda" and not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 1
        if a.deterministic:
            torch.use_deterministic_algorithms(True, warn_only=True)
        importlib.import_module(f"{pkg}.ops.raster_tiled")._BIN_KERNEL = a.bin_kernel
        kwargs["device"] = a.device
        if a.poison is not None:
            blocks = [torch.full((size,), a.poison, dtype=torch.uint8, device="cuda")
                      for size, count in ((1 << 19, 2000), (1 << 23, 250), (1 << 26, 64))
                      for _ in range(count)]
            torch.cuda.synchronize()
            del blocks
    with tempfile.TemporaryDirectory() as tmp:
        ds = launch.make_synthetic_dataset("two_room", 0, a.steps, a.res, a.res, results_dir=tmp)
        t0 = time.perf_counter()
        with chip_smoke.recorded_targets(planner_fsm) as targets:
            node, planner = launch.run_episode(ds, tmp, **kwargs)
        if port and a.device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        params = load_params(os.path.join(tmp, "gaussians_data", "params.npz"))
        visited = np.ascontiguousarray(planner.visited_px)
        out = {
            "package": pkg, "device": a.device, "steps": a.steps, "res": a.res,
            "lean": a.lean, "bin_kernel": a.bin_kernel, "deterministic": a.deterministic,
            "poison": a.poison,
            "wall_s": round(wall, 3), "gaussians": node.mapper.num_gaussians(),
            "area_m2": float(np.count_nonzero(planner.free_map)
                             * planner.topdown_cfg.meter_per_pixel ** 2),
            "ticks": planner._tick_count, "px_as_arrived": planner.px_as_arrived,
            "targets": chip_smoke.target_timeline(np, planner, targets),
            "visited_digest": {k: digest(visited[:k + 1])
                               for k in range(50, len(visited), 50)},
            "params_digest": digest(*(params[k] for k in sorted(params))),
            "shape_history": node.mapper.shape_history,
        }
    line = json.dumps(out)
    if a.out:
        Path(a.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
