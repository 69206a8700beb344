"""One run of one cell: build the cell's episode, run its warm prefix,
measure the window, close it, then judge what the window produced.

The traffic mix's `kind` names the driver, `harness/kinds/<kind>.py`, whose
`run` composes and drives the program's episode with the benchmark's frozen
simulator passed as `sim_factory` (`explore`: the planner-driven
exploration episode).

Timing: the simulator's clock stamps every `step` on the host clock. The
first `warm_actions` steps are set-up; the window opens at the next step and
holds every action whose step starts in it. At the first step at or after
`seconds`, one synchronize closes the window and the clock ends the episode
by raising `WindowClosed` out of that step.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "activesplat_tpu")


class WindowClosed(Exception):
    """Raised out of the simulator's step that closes the window."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def cell_files(workload: str, manifest: Optional[Dict] = None) -> Dict:
    """The cell's configuration, traffic and limits, found by name."""
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    cell = next(w for w in manifest["workloads"] if w["name"] == workload)
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    return {
        "cell": cell,
        "config": load_json(ROOT / conf["file"]),
        "traffic": load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(BENCH / "limits" / f"{workload}.json"),
        "manifest": manifest,
    }


class Clock:
    """The simulator's step hook: stamps, the window, the traced stretch."""

    def __init__(self, warm: int, seconds: float, sync, trace: Optional[Dict] = None,
                 on_open=None, on_close=None, probe=None) -> None:
        self.warm, self.seconds, self.sync = warm, seconds, sync
        self.trace = trace
        self.on_open, self.on_close = on_open, on_close
        self.steps = 0
        self.stamps: List[float] = []
        self.actions: List[int] = []
        self.t0: Optional[float] = None
        self.first: Optional[float] = None
        self.end: Optional[float] = None
        self.profiler = None
        self.probe = probe

    def __call__(self, action: int) -> None:
        if self.probe is not None:
            self.probe(self.steps)
        now = time.perf_counter()
        if self.first is None:
            self.first = now
        if self.steps == self.warm:
            if self.on_open is not None:
                self.on_open()
            now = time.perf_counter()
            self.t0 = now
        self.steps += 1
        if self.t0 is None:
            return
        # a traced run's window lasts at least until its stretch has ended
        tracing = self.trace is not None and "profiler" not in self.trace
        if self.stamps and now - self.t0 >= self.seconds and not tracing:
            self.sync()
            self.end = time.perf_counter()
            if self.on_close is not None:
                self.on_close()
            raise WindowClosed()
        self.stamps.append(now)
        self.actions.append(int(action))
        if self.trace is not None and "profiler" not in self.trace:
            self._trace_step(len(self.stamps) - 1)

    def _trace_step(self, i: int) -> None:
        """Profile from the window's first action; the stretch is the
        `actions` actions that follow the first `lead`."""
        import torch

        if i == 0:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.profiler = torch.profiler.profile(activities=acts)
            self.profiler.start()
        with torch.profiler.record_function("bench/action"):
            pass
        t = self.trace
        if i == t["lead"]:
            t["io_before"] = t["io"]()
        if i == t["lead"] + t["actions"]:
            t["io_after"] = t["io"]()
            self.sync()
            self.profiler.stop()
            t["profiler"], self.profiler = self.profiler, None


def load_kind(kind: str):
    """The driver of a traffic kind, found by name."""
    import importlib.util

    path = BENCH / "harness" / "kinds" / f"{kind}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_kind_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fingerprint(actions: List[int], n: int) -> str:
    """A digest of the window's first `n` actions: equal digests, equal paths."""
    return hashlib.sha1(bytes(actions[:n])).hexdigest()[:12] if len(actions) >= n else "-"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_process: Optional[float] = None, manifest: Optional[Dict] = None,
             config: Optional[Dict] = None, traffic: Optional[Dict] = None, fault=None,
             log=print, probe=None, variants=("program",),
             readings: Optional[Dict] = None) -> Dict:
    """Run one cell once; returns the result object (the last line).
    `config` and `traffic` replace the cell's files (the CPU tests' tiny
    runs), `fault` plants a fault under the capture hooks, and `readings`
    receives the compared numbers of each of `variants`."""
    import torch

    from benchmark.harness import stats
    from benchmark.harness.capture import Captures, sample_plan
    from benchmark.sim.boxworld import BoxWorld, BoxWorldSim, compute_intrinsics, default_start

    t_process = time.perf_counter() if t_process is None else t_process
    files = cell_files(workload, manifest)
    conf = config or files["config"]
    traffic = traffic or files["traffic"]
    limits = files["limits"]
    bench = conf["benchmark"]
    scene_cfg = {k: v for k, v in conf.items() if k != "benchmark"}
    env_yaml = Path(scene_cfg["env"]["config"])
    if not env_yaml.is_absolute():
        env_yaml = BENCH / "configs" / "env" / env_yaml.name
    scene_cfg["env"] = dict(scene_cfg["env"], config=str(env_yaml))

    from activesplat_tpu_torch.runtime import mapper_node
    from activesplat_tpu_torch.utils import tracing

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    world = getattr(BoxWorld, bench["scene"]["room"])(seed=int(bench["scene"]["seed"]))
    sim_time = [0.0, 0]
    holder: Dict = {}

    class TimedSim(BoxWorldSim):
        def get_sensor_observations(self):
            t = time.perf_counter()
            obs = super().get_sensor_observations()
            if clock.t0 is not None:
                sim_time[0] += time.perf_counter() - t
                sim_time[1] += 1
            return obs

    def io_syncs():
        return sum(v.get("sync", 0) for v in tracing.stage_report_io().values())

    def sim_factory(payload):
        # every seed starts at the scene's start spot with yaw 0, so every
        # seed does the same work; the seed picks the calls the check copies
        spec = payload["spec"]
        return TimedSim(spec, world, default_start(world, spec.agent_radius), 0.0, on_step=clock)

    def count_gaussians():
        node = holder.get("node")
        return int(node.mapper.num_gaussians()) if node is not None else None

    def on_open():
        sync()
        holder["gaussians_start"] = count_gaussians()
        caps.open = True

    def on_close():
        caps.open = False

    trace_spec = None
    if trace:
        t = traffic["trace"]
        trace_spec = {"lead": int(t["lead_actions"]), "actions": int(t["actions"]),
                      "io": io_syncs}
    clock = Clock(int(bench["warm_actions"]), seconds, sync, trace_spec, on_open, on_close,
                  None if probe is None else lambda step: probe(step, holder.get("node")))

    # the mapper's camera, from the configuration (as the Habitat adapter
    # derives it: fx = fy = W / (2 tan(hfov / 2)), cx = W/2 - 1, cy = H/2 - 1)
    cam_conf = bench["camera"]
    width, height = int(cam_conf["width"]), int(cam_conf["height"])
    fx, fy, cx, cy = compute_intrinsics(width, height, np.deg2rad(float(cam_conf["hfov"])))
    f32 = np.float32
    intr = {"fx": float(f32(fx)), "fy": float(f32(fy)), "cx": float(f32(cx)),
            "cy": float(f32(cy)), "width": width, "height": height, "near": 0.01, "far": 100.0}
    caps = Captures(sample_plan(seed, traffic["sample"]), intr)

    orig_init = mapper_node.MapperNode.__init__

    def node_init(self, *a, **k):
        holder["node"] = self
        orig_init(self, *a, **k)

    mapper_node.MapperNode.__init__ = node_init
    # a planted fault lies under the capture hooks: they copy what it made
    if fault is not None:
        fault.install()
    caps.install()
    tmp = tempfile.mkdtemp(prefix="activesplat-bench-")
    results = None
    try:
        results_dir = os.path.join(tmp, "results")
        drive = load_kind(traffic["kind"])
        try:
            drive.run(scene_cfg, results_dir, sim_factory, traffic, seed, device)
        except WindowClosed:
            pass
        if clock.end is None:
            raise RuntimeError(f"the episode ended after {clock.steps} steps, before the "
                               f"window closed")
        gaussians_end = count_gaussians()
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        found = forbidden_modules()
        if found:
            raise SystemExit(f"modules of JAX or the JAX package are loaded: {found}")
        walls = stats.action_walls(clock.stamps, clock.end)
        a_ms = stats.action_ms(clock.stamps, clock.end)
        p90 = stats.percentile(walls, 90) * 1e3
        setup_s = clock.t0 - t_process
        log(f"setup: {clock.first - t_process:.3f} s to the first action, "
            f"{clock.t0 - clock.first:.3f} s for the {clock.warm} warm actions")
        log(f"window: {len(walls)} actions in {clock.end - clock.t0:.3f} s, "
            f"{stats.beyond(walls, p90 * 1e-3)} beyond the p90; path of the first 50 and 60 "
            f"actions {fingerprint(clock.actions, 50)} {fingerprint(clock.actions, 60)}")
        log(f"simulator: {sim_time[0] / max(len(walls), 1) * 1e3:.3f} ms an action "
            f"(frozen BoxWorld raycaster, {sim_time[1]} frames)")
        log(f"gaussians: {holder.get('gaussians_start')} at the window's start, "
            f"{gaussians_end} at its end; device memory peak {peak} bytes")

        layer = None
        if trace:
            layer = per_layer_metrics(clock.trace, files, workload, tmp, log)

        # free the program's state before the reference runs
        holder.clear()
        caps.uninstall()
        if fault is not None:
            fault.uninstall()
            fault = None
        mapper_node.MapperNode.__init__ = orig_init
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        from benchmark.reference import checks

        numbers = checks.evaluate(caps.finalized(), variants)
        if readings is not None:
            readings.update(numbers)
        numbers = numbers[variants[0]]
        verdict = {name: {"value": numbers[name], "limit": limits[name]} for name in limits
                   if name in numbers}
        # the mapping iteration is always due in the window; the other kinds
        # are judged where a call of theirs fell in it
        required = ("loss_gap", "grad_gap", "step_gap")
        correct = all(name in verdict for name in required) and all(
            v["value"] <= v["limit"] for v in verdict.values())
        for name in limits:
            if name not in numbers:
                log(f"check {name}: no call of its kind in the window")
        if trace:
            metrics, breakdown, busy_s, window_s = layer
            dev_extra = {"busy_s": busy_s, "window_s": window_s}
        else:
            metrics = {"action_ms": {"value": a_ms, "unit": "ms"},
                       "action_ms_p90": {"value": p90, "unit": "ms"},
                       "setup_s": {"value": setup_s, "unit": "s"}}
            dev_extra = {}
        results = {
            "correct": correct,
            "attempted": len(walls),
            "failed": 0,
            "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                       "count": 1, "memory_peak_bytes": peak, **dev_extra,
                       "power_limit": card_power_limit() if cuda else None},
        }
        if trace:
            results["breakdown"] = breakdown
        results["checks"] = verdict
    finally:
        if clock.profiler is not None:
            clock.profiler.stop()
        caps.uninstall()
        if fault is not None:
            fault.uninstall()
        mapper_node.MapperNode.__init__ = orig_init
        shutil.rmtree(tmp, ignore_errors=True)
    return results


def card_power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return None


class Context:
    """What a per-layer metric's reader reads: the traced stretch and the
    program's counters over it."""

    def __init__(self, stretch, host_syncs: Optional[int]) -> None:
        self.stretch = stretch
        self.actions = stretch.actions
        self.host_syncs = host_syncs


def load_metric(name: str):
    import importlib.util

    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer_metrics(trace: Dict, files: Dict, workload: str, tmp: str, log):
    from benchmark.harness import trace as T

    if "profiler" not in trace:
        raise RuntimeError("the window closed before the traced stretch ended")
    path = os.path.join(tmp, "trace.json")
    trace["profiler"].export_chrome_trace(path)
    stretch = T.load(path, int(trace["lead"]), int(trace["actions"]))
    os.unlink(path)
    syncs = None
    if trace.get("io_before") is not None and trace.get("io_after") is not None:
        syncs = trace["io_after"] - trace["io_before"]
    ctx = Context(stretch, syncs)
    metrics = {}
    for m in files["manifest"]["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = load_metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    busy_s = T.device_busy_us(stretch) * 1e-6
    window_s = stretch.wall_us * 1e-6
    log(f"traced stretch: {stretch.actions} actions, {window_s:.3f} s, device busy "
        f"{busy_s:.3f} s")
    return metrics, T.breakdown(stretch), busy_s, window_s
