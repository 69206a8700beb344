#!/usr/bin/env python3
"""Trace the bin's two routes of one tree of the PyTorch port on one card.

    python3 scripts/bin_route_trace.py [--root DIR] [--inputs FILE] [--iterations N]

Imports `activesplat_tpu_torch` from DIR (default: this checkout; an older
tree unpacked with `git archive` compares two versions in one run), then:
  - with --iterations N (default 30; 0 skips it): builds the mapping
    benchmark's map (200,000 Gaussians, 256x256, k=256) and times N
    chained mapping_iterations with each route in turns (sort, kernel,
    kernel, sort), profiles 10 iterations of each route (device busy, idle
    share, the top operators by device and by host time), and times the
    same turns again after the profiler has run;
  - for each bin that chip_smoke.py saved in FILE (default
    build/bin_route_inputs.pt: the main path's bin and the driver's last,
    k=1,024), traces 20 calls of the kernel route and of the sort route of
    `bin_gaussians` with chip_smoke.py's route_trace: each device
    operation's launches and device ms a call, the host's operators, and
    the host ms a call.
Prints the card's name and power limit, and one JSON object of the numbers
last. Needs one CUDA card; run chip_smoke.py first for FILE.
"""

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--inputs", default=str(HERE / "build" / "bin_route_inputs.pt"))
    ap.add_argument("--iterations", type=int, default=30)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bin_route_trace: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(a.root).resolve()))
    from activesplat_tpu_torch.ops import raster_tiled as rt

    card = smoke.nvidia_smi("name,power.limit")
    print(card)
    print(f"tracing the port at {Path(rt.__file__).resolve().parent.parent}")
    out = {"root": a.root, "card": card, "bins": {}, "iterations": {}}
    if a.iterations:
        out["iterations"] = iterations(torch, smoke, rt, card, a.iterations)
    for name, bin_in in torch.load(a.inputs).items():
        bin_in = tuple(x.cuda() if torch.is_tensor(x) else x for x in bin_in)
        k, off = bin_in[5], bin_in[6]
        out["bins"][name] = {
            route: smoke.route_trace(
                torch, lambda on=on: rt.bin_gaussians(*bin_in, use_kernel=on),
                smoke.ROUTE_TRACE_CALLS, f"the {route} route, {name} bin (k={k}, offset {off})", card)
            for route, on in (("kernel", True), ("sort", False))}
    print(json.dumps(out))
    return 0


def iterations(torch, smoke, rt, card, iters):
    """Mapping iterations/s with each bin route in turns, a profile of
    each, and the same turns after the profile: {"before", "after":
    {route: [it/s, it/s]}}."""
    from activesplat_tpu_torch.mapper.adam import AdamState
    from activesplat_tpu_torch.mapper.step import mapping_iteration
    from activesplat_tpu_torch.runtime.bench_scene import build_map

    scene = build_map(smoke.N_GAUSSIANS, smoke.RES, k_per_tile=smoke.K_PER_TILE)
    buf, cam, cfg = scene.buf, scene.cam, scene.cfg
    rgb0, depth0 = scene.frame(scene.c2w)
    state = [buf, AdamState.init(buf.params)]

    def step():
        state[0], state[1], m = mapping_iteration(state[0], state[1], cam, rgb0, depth0, cfg)
        return m

    def turns(when):
        rates = {"sort": [], "kernel": []}
        for route in ("sort", "kernel", "kernel", "sort"):
            rt._BIN_KERNEL = route == "kernel"
            step()  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acc = torch.zeros((), device="cuda")
            for _ in range(iters):
                acc = acc + step()["loss"]
            float(acc)
            rates[route].append(iters / (time.perf_counter() - t0))
        print(f"mapping iterations/s {when}: sort route {rates['sort']}, kernel route "
              f"{rates['kernel']} ({iters} iterations a run, in turns sort, kernel, kernel, "
              f"sort) on {card}")
        return rates

    rates = {"before": turns("before any profiler session")}
    for route in ("sort", "kernel"):
        rt._BIN_KERNEL = route == "kernel"
        smoke.profile_calls(torch, step, 10, 1000.0 / rates["before"][route][-1], card,
                            f"mapping_iteration, {route} route", ("device", "host"))
    rates["after"] = turns("after the profiler sessions")
    rt._BIN_KERNEL = False
    return rates


if __name__ == "__main__":
    sys.exit(main())
