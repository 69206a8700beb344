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
    build/bin_route_inputs.pt: the bins of its k-capped renders at 256x256,
    k=256, and at 512x512, k=1,024), traces ROUTE_TRACE_CALLS calls of the
    kernel route and of the sort route of `bin_gaussians` (route_trace):
    each device operation's launches and device ms a call, the host's
    operators, and the host ms a call.
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
ROUTE_TRACE_CALLS = 20


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
            route: route_trace(
                torch, lambda on=on: rt.bin_gaussians(*bin_in, use_kernel=on),
                ROUTE_TRACE_CALLS, f"the {route} route, {name} bin (k={k}, offset {off})", card)
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
        profile_calls(torch, step, 10, 1000.0 / rates["before"][route][-1], card,
                      f"mapping_iteration, {route} route")
    rates["after"] = turns("after the profiler sessions")
    rt._BIN_KERNEL = False
    return rates


def device_kernels(prof) -> list:
    """A trace's device activity, less the device-side spans of the tracing
    stages (record_function ranges), which cover the kernels they enclose."""
    from torch.autograd import DeviceType

    from activesplat_tpu_torch.utils.tracing import stage_report

    stages = set(stage_report())
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name not in stages]


def profile_calls(torch, fn, calls: int, timed_ms: float, card: str, label: str) -> None:
    """Run `calls` calls of `fn` under torch.profiler; print the device's
    busy time and idle share per call and the top operators by device and
    host time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / calls * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / calls
    print(f"profile of {calls} {label} calls on {card}: wall {wall_ms:.3f} ms/call "
          f"under the profiler ({timed_ms:.3f} without), device busy {busy_ms:.3f} ms/call "
          f"in {len(kernels) / calls:.0f} kernels/call, idle share {1.0 - busy_ms / wall_ms:.3f} "
          f"of the profiled wall time, {1.0 - busy_ms / timed_ms:.3f} of the unprofiled one")
    averages = prof.key_averages()
    for sort_by in ("self_device_time_total", "self_cpu_time_total"):
        print(averages.table(sort_by=sort_by, row_limit=20))


def route_trace(torch, run, calls: int, label: str, card: str) -> dict:
    """A trace of `calls` calls of one bin route (`run`): every device
    operation with its launches and device ms a call (torch.profiler), the
    host's self ms a call of the operators that launch them, and the
    host ms a call unprofiled (the calls enqueued back to back, then one
    synchronize: "enqueue", and to its end: "wall")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        run()
    enqueue = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / calls * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    device = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            n_e, us = device.get(e.name, (0, 0.0))
            device[e.name] = (n_e + 1, us + e.time_range.elapsed_us())
    host = sorted(((a.self_cpu_time_total / calls / 1e3, a.key, a.count / calls)
                   for a in prof.key_averages() if a.self_cpu_time_total > 0), reverse=True)
    busy = sum(us for _, us in device.values()) / calls / 1e3
    ops = sum(c for c, _ in device.values()) / calls
    print(f"route trace, {label}: {ops:.1f} device operations a call, device busy {busy:.4f} ms a "
          f"call; host {enqueue:.4f} ms a call to enqueue, {wall:.4f} ms to the end of the last "
          f"({calls} calls, unprofiled) on {card}")
    for name, (c, us) in sorted(device.items(), key=lambda x: -x[1][1]):
        print(f"    device {us / calls / 1e3:9.4f} ms  {c / calls:5.1f}x  {name[:110]}")
    for ms, key, c in host[:12]:
        print(f"    host   {ms:9.4f} ms  {c:5.1f}x  {key[:110]}")
    return {"device_ops": ops, "device_ms": busy, "host_enqueue_ms": enqueue, "host_wall_ms": wall}


if __name__ == "__main__":
    sys.exit(main())
