"""Episode launcher (counterpart of activesplat_tpu/runtime/launch.py): the
roslaunch-equivalent entry point.

Wires the mapper node and the planner FSM over the in-process bus and runs a
full active-exploration episode on a synthetic scene (reference:
launch/habitat.launch starting mapper_node.py + planner_node.py). The mapper
and its queries run on CUDA unless the caller names another device; the
simulator and the planner run on the host. Outputs land in the reference's
result layout: results_dir/{gaussians_data/{params.npz, transforms.json,
rgb, depth}, actions.txt, visited_map.png, topdown_free_map.png,
voronoi_graph.png, planner_log.jsonl}.

    python -m activesplat_tpu_torch.runtime.launch --scene_id two_room --results_dir DIR
    python -m activesplat_tpu_torch.runtime.launch --mode replay --actions DIR/actions.txt \
        --results_dir DIR2
    python -m activesplat_tpu_torch.runtime.launch --mode manual --results_dir DIR3

--mode replay drives a recorded actions.txt through the mapper with no
planner; --mode manual maps while keys read from stdin drive the agent.
Not ported yet: scene configs (--config, --user_config), the Habitat
backends (--habitat_sim), the multi-device mesh (--mesh), the live view and
the runtime recorder (--save_runtime_data 1).
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from activesplat_tpu_torch.device import DeviceLike
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.runtime.bus import Bus
from activesplat_tpu_torch.runtime.dataloader import (
    RGBDSensor,
    SimAction,
    SyntheticDataset,
    action_to_twist,
)
from activesplat_tpu_torch.runtime.mapper_node import MapperNode
from activesplat_tpu_torch.runtime.planner_fsm import PlannerFSM
from activesplat_tpu_torch.runtime.synthetic import BoxWorld
from activesplat_tpu_torch.utils import GlobalState
from activesplat_tpu_torch.utils.tracing import format_stage_report, trace_capture


def _ensure_setup(dataset) -> None:
    """A dataset that builds its simulator lazily in setup() (the Habitat
    one in the JAX package) is set up once; SyntheticDataset has no setup.
    Idempotent."""
    if hasattr(dataset, "setup") and getattr(dataset, "_sim", None) is None:
        dataset.setup()


def make_synthetic_dataset(
    scene_id: str = "two_room",
    seed: int = 0,
    step_num: int = 500,
    width: int = 256,
    height: int = 256,
    hfov_deg: float = 90.0,
    depth_max: float = 10.0,
    turn_angle_deg: float = 10.0,
    tilt_angle_deg: float = 15.0,
    results_dir: Optional[str] = None,
) -> SyntheticDataset:
    maker = {"two_room": BoxWorld.two_room, "single_room": BoxWorld.single_room}[
        scene_id
    ]
    world = maker(seed=seed)
    sensor = RGBDSensor.from_fov(
        width, height, hfov_deg, depth_min=0.0, depth_max=depth_max
    )
    sx, _, sz = world.size
    # start near a free spot around the room center
    start = None
    for dx in np.linspace(0, min(sx, sz) / 2 - 0.5, 8):
        candidate = np.array([sx / 2 + dx, 0.0, sz / 4])
        if world.is_free(candidate[[0, 2]], 0.2):
            start = candidate
            break
    return SyntheticDataset(
        world,
        sensor,
        step_num=step_num,
        start_position=start,
        turn_angle_deg=turn_angle_deg,
        tilt_angle_deg=tilt_angle_deg,
        results_dir=results_dir,
        scene_id=f"{scene_id}-{seed}",
    )


def run_episode(
    dataset: SyntheticDataset,
    results_dir: str,
    mapper_cfg: Optional[MapperConfig] = None,
    pixel_max: int = 360,
    max_ticks: int = 100000,
    pano_scale: float = 1.0,
    device: DeviceLike = None,
):
    """Run one exploration episode to budget exhaustion. Returns
    (mapper_node, planner). Set ACTIVESPLAT_TRACE_DIR to capture a
    torch.profiler trace of the episode."""
    mapper_cfg = mapper_cfg or MapperConfig()
    _ensure_setup(dataset)
    bus = Bus()
    mapper_node = MapperNode(
        bus,
        dataset,
        mapper_cfg,
        results_dir,
        pixel_max=pixel_max,
        pano_scale=pano_scale,
        device=device,
    )
    planner = PlannerFSM(bus, live_view=mapper_node.live_view)
    with trace_capture():
        planner.run(max_ticks=max_ticks)
    mapper_node.finish()
    dataset.close()
    return mapper_node, planner


def _drive(dataset, results_dir, twists, state, mapper_cfg, pixel_max, save_dataset, pano_scale,
           device):
    """A mapper node with no planner, in `state`, fed the twists on cmd_vel
    until they run out or the node quits (the step budget spent)."""
    _ensure_setup(dataset)
    bus = Bus()
    mapper_node = MapperNode(bus, dataset, mapper_cfg or MapperConfig(), results_dir,
                             pixel_max=pixel_max, save_dataset=save_dataset,
                             pano_scale=pano_scale, device=device)
    mapper_node.global_state = state
    for twist in twists:
        if mapper_node.global_state == GlobalState.QUIT:
            break
        bus.publish("cmd_vel", twist)
    mapper_node.finish()
    dataset.close()
    return mapper_node


def run_replay(
    dataset: SyntheticDataset,
    actions_path: str,
    results_dir: str,
    mapper_cfg: Optional[MapperConfig] = None,
    pixel_max: int = 360,
    save_dataset: bool = True,
    pano_scale: float = 1.0,
    device: DeviceLike = None,
):
    """REPLAY mode: drive a recorded actions.txt through the full mapper via
    the live cmd_vel path, with no planner (reference: habitat.launch
    mode/actions args + GlobalState.REPLAY, visualizer.py frame loop).
    Returns the mapper node."""
    from activesplat_tpu_torch.io.actions import read_actions

    twists = (action_to_twist(SimAction(a)) for a in read_actions(actions_path))
    return _drive(dataset, results_dir, twists, GlobalState.REPLAY, mapper_cfg, pixel_max,
                  save_dataset, pano_scale, device)


# the reference's teleop SPEED/TURN (scripts/nodes/__init__.py) and its
# arrow-key table (visualizer.py:1934-1965) on w/a/d/r/f
_SPEED, _TURN = 0.2, 0.2
KEY_TO_TWIST = {
    "w": {"linear": np.array([_SPEED, 0.0, 0.0]), "angular": np.zeros(3)},
    "a": {"linear": np.zeros(3), "angular": np.array([0.0, 0.0, _TURN])},
    "d": {"linear": np.zeros(3), "angular": np.array([0.0, 0.0, -_TURN])},
    "r": {"linear": np.zeros(3), "angular": np.array([0.0, -_TURN, 0.0])},
    "f": {"linear": np.zeros(3), "angular": np.array([0.0, _TURN, 0.0])},
}


def _stdin_keys():
    print("manual control: w=forward a=left d=right r=up f=down q=quit")
    for line in sys.stdin:
        yield from line.strip()


def run_manual(
    dataset: SyntheticDataset,
    results_dir: str,
    mapper_cfg: Optional[MapperConfig] = None,
    pixel_max: int = 360,
    save_dataset: bool = True,
    action_source=None,
    pano_scale: float = 1.0,
    device: DeviceLike = None,
):
    """MANUAL_CONTROL mode: teleoperation drives cmd_vel while the mapper
    maps every frame, the headless equivalent of the reference's arrow-key
    teleop. `action_source` yields single-character commands; None reads
    them from stdin (w=forward a=left d=right r=look-up f=look-down q=quit;
    other keys are ignored). Returns the mapper node."""
    keys = itertools.takewhile(lambda k: k != "q",
                               _stdin_keys() if action_source is None else action_source)
    twists = (KEY_TO_TWIST[k] for k in keys if k in KEY_TO_TWIST)
    return _drive(dataset, results_dir, twists, GlobalState.MANUAL_CONTROL, mapper_cfg,
                  pixel_max, save_dataset, pano_scale, device)


NOT_PORTED = "is not ported to activesplat_tpu_torch yet (ROADMAP.md, queue A, item 10.3)"


def main(argv=None):
    parser = argparse.ArgumentParser(description="ActiveSplat episode launcher (PyTorch/CUDA)")
    parser.add_argument("--scene_id", default="two_room", choices=["two_room", "single_room"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--step_num", type=int, default=500)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--results_dir", required=True)
    parser.add_argument("--pixel_max", type=int, default=360)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument(
        "--mode", default="auto", choices=["auto", "replay", "manual"],
        help="auto: planner-driven exploration; replay: re-run --actions through the mapper; "
        "manual: stdin keyboard teleop",
    )
    parser.add_argument("--actions", default=None, help="actions.txt for replay mode")
    # the JAX launcher's other options, refused until they are ported
    parser.add_argument("--config", default=None)
    parser.add_argument("--user_config", default=None)
    parser.add_argument("--habitat_sim", default=None)
    parser.add_argument("--mesh", type=int, default=None)
    parser.add_argument("--live_view_port", type=int, default=None)
    parser.add_argument("--save_runtime_data", type=int, default=0)
    args = parser.parse_args(argv)

    for flag, value, default in (
        ("--config", args.config, None), ("--user_config", args.user_config, None),
        ("--habitat_sim", args.habitat_sim, None), ("--mesh", args.mesh, None),
        ("--live_view_port", args.live_view_port, None),
        ("--save_runtime_data", args.save_runtime_data, 0),
    ):
        if value != default:
            parser.exit(2, f"{flag} {value} {NOT_PORTED}\n")

    if args.mode == "replay" and not args.actions:
        parser.error("--mode replay requires --actions")

    os.makedirs(args.results_dir, exist_ok=True)
    # the replayed actions are read, not written: the replay's dataset logs none
    dataset = make_synthetic_dataset(
        args.scene_id, args.seed, args.step_num, args.width, args.height,
        results_dir=None if args.mode == "replay" else args.results_dir,
    )
    common = dict(pixel_max=args.pixel_max, device=args.device)
    start = time.perf_counter()
    if args.mode == "replay":
        mapper_node = run_replay(dataset, args.actions, args.results_dir, **common)
    elif args.mode == "manual":
        mapper_node = run_manual(dataset, args.results_dir, **common)
    else:
        mapper_node, planner = run_episode(dataset, args.results_dir, **common)
    if args.device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - start
    steps, _ = dataset.get_step_info()
    if args.mode != "auto":
        print(f"{args.mode} finished: {steps} steps in {wall:.1f} s, "
              f"{mapper_node.mapper.num_gaussians()} gaussians")
        print(format_stage_report())
        return
    free = 0 if planner.free_map is None else np.count_nonzero(planner.free_map)
    area = free * planner.topdown_cfg.meter_per_pixel ** 2
    print(f"episode finished: {steps} steps in {wall:.1f} s ({wall / max(steps, 1) * 1e3:.1f} ms "
          f"an action, set-up and outputs included), {mapper_node.mapper.num_gaussians()} "
          f"gaussians, explored free area {area:.2f} m^2")
    print(format_stage_report())


if __name__ == "__main__":
    main()
