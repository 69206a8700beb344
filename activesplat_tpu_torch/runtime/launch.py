"""Episode launcher (counterpart of activesplat_tpu/runtime/launch.py): the
roslaunch-equivalent entry point.

Wires the mapper node and the planner FSM over the in-process bus and runs a
full active-exploration episode (reference: launch/habitat.launch starting
mapper_node.py + planner_node.py) on a synthetic scene or, from a scene
config of a Habitat format (gibson, mp3d, replica), through the Habitat
adapter (runtime/habitat_backend.py) on the real simulator or its BoxWorld
mock. The mapper and its queries run on CUDA unless the caller names another
device; the simulator and the planner run on the host. Outputs land in the
reference's result layout: results_dir/{gaussians_data/{params.npz,
transforms.json, rgb, depth}, actions.txt, visited_map.png,
topdown_free_map.png, voronoi_graph.png, planner_log.jsonl}, with
--save_runtime_data 1 also topdown_map/, opacity/ and current_vis_data/.

    python -m activesplat_tpu_torch.runtime.launch --scene_id two_room --results_dir DIR
    python -m activesplat_tpu_torch.runtime.launch --config gibson_high_resolution \
        --habitat_sim mock --save_runtime_data 1 --live_view_port 0 --results_dir DIR
    python -m activesplat_tpu_torch.runtime.launch --mode replay --actions DIR/actions.txt \
        --results_dir DIR2
    python -m activesplat_tpu_torch.runtime.launch --mode manual --results_dir DIR3

CLI flags the user passes beat the scene config's values, which beat the
defaults. The scene config's `planner` block (step_num_as_visited,
step_num_as_arrived, local_view_limit, radius_num_as_rotated,
max_pitch_angle, obstacle_approx_precision) rides on the dataset into the
get_dataset_config payload, and the planner takes its knobs from there.
--mode replay drives a recorded actions.txt through the mapper with no
planner; --mode manual maps while keys read from stdin drive the agent.
--habitat_sim real needs the habitat-sim and habitat-lab wheels. --mesh 1
shards the mapper's renders over the visible devices of its type
(MapperConfig.use_mesh, parallel/sharded.py); with fewer than two that
split the height into whole 16 px tile rows, one card for example, the
mapper says so and renders unsharded.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from activesplat_tpu_torch.configs import (
    dataset_kwargs_from_scene,
    load_scene_config,
    load_user_config,
    mapper_config_from_scene,
)
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
    """HabitatDataset builds its simulator lazily in setup() (import-gated on
    the wheels); SyntheticDataset has no setup. Idempotent."""
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
    planner: Optional[dict] = None,
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
        planner=planner,
    )


def run_episode(
    dataset: SyntheticDataset,
    results_dir: str,
    mapper_cfg: Optional[MapperConfig] = None,
    pixel_max: int = 360,
    save_runtime_data: bool = False,
    save_dataset: bool = True,
    max_ticks: int = 100000,
    pano_scale: float = 1.0,
    live_view_port=None,
    single_floor_expansion=(0.25, 2.0),
    agent_foot_adjust: float = 0.0,
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
        single_floor_expansion=single_floor_expansion,
        agent_foot_adjust=agent_foot_adjust,
        save_runtime_data=save_runtime_data,
        save_dataset=save_dataset,
        pano_scale=pano_scale,
        live_view_port=live_view_port,
        device=device,
    )
    planner = PlannerFSM(bus, save_runtime_data=save_runtime_data,
                         live_view=mapper_node.live_view)
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


HABITAT_FORMATS = ("gibson", "mp3d", "replica")


def build_episode_from_config(
    scene_cfg: Optional[dict],
    results_dir: Optional[str],
    scene_id: Optional[str] = None,
    user_config_path: Optional[str] = None,
    sim_factory=None,
    overrides: Optional[dict] = None,
) -> dict:
    """Compose everything an episode needs from a scene-config dict: the
    dataset (HabitatDataset for gibson/mp3d/replica formats, SyntheticDataset
    otherwise), the MapperConfig, and the painter/planner knobs the launcher
    consumes (reference arg plumbing: launch/habitat.launch:1-23 ->
    scripts/nodes/mapper_node.py:34-137, config JSON -> env yaml -> dataset
    root -> HabitatDataset).

    `overrides` (CLI flags the user passed explicitly) win over config
    values; config values win over defaults. Returns dict(dataset,
    mapper_cfg, pixel_max, single_floor_expansion, agent_foot_adjust). The
    dataset keeps the config's `planner` block and hands it to the planner
    in its get_dataset_config payload, where PlannerFSM reads its knobs."""
    scene_cfg = scene_cfg or {}
    overrides = {k: v for k, v in (overrides or {}).items() if v is not None}
    fmt = scene_cfg.get("dataset", {}).get("format", "synthetic")

    if fmt in HABITAT_FORMATS:
        from activesplat_tpu_torch.runtime.habitat_backend import get_dataset

        user = load_user_config(user_config_path)
        if "step_num" in overrides:
            scene_cfg = dict(scene_cfg)
            scene_cfg["dataset"] = dict(scene_cfg["dataset"], step_num=overrides["step_num"])
        dataset = get_dataset(
            scene_cfg,
            user,
            scene_id=scene_id or "None",
            results_dir=results_dir,
            sim_factory=sim_factory,
        )
    else:
        kw = dataset_kwargs_from_scene(scene_cfg)
        for key in ("scene_id", "seed", "step_num", "width", "height"):
            if key in overrides:
                kw[key] = overrides[key]
        if scene_id:
            kw["scene_id"] = scene_id
        dataset = make_synthetic_dataset(results_dir=results_dir,
                                         planner=scene_cfg.get("planner"), **kw)

    mapper = scene_cfg.get("mapper", {})
    single_floor = mapper.get("single_floor", {}).get("expansion", {})
    return {
        "dataset": dataset,
        "mapper_cfg": mapper_config_from_scene(scene_cfg),
        "pixel_max": overrides.get(
            "pixel_max",
            scene_cfg.get("painter", {}).get("grid_map", {}).get("pixel_max", 360),
        ),
        "single_floor_expansion": (
            float(single_floor.get("foot", 0.25)),
            float(single_floor.get("head", 2.0)),
        ),
        "agent_foot_adjust": float(scene_cfg.get("planner", {}).get("agent_foot_adjust", 0.0)),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="ActiveSplat episode launcher (PyTorch/CUDA)")
    parser.add_argument(
        "--config", default=None,
        help="scene config: a bundled name (gibson, gibson_high_resolution, mp3d, "
        "synthetic_small, ...) or a JSON path; gibson/mp3d/replica formats build a "
        "HabitatDataset from the env yaml + user-config dataset roots",
    )
    parser.add_argument(
        "--scene_id", default=None,
        help="scene override (any Habitat scene id, or two_room/single_room for synthetic "
        "configs)",
    )
    parser.add_argument("--user_config", default=None,
                        help="dataset-roots JSON (config/.templates/user_config.json layout)")
    parser.add_argument(
        "--habitat_sim", default="real", choices=["real", "mock"],
        help="real: the habitat-sim wheels (absent unless installed); mock: the BoxWorld-backed "
        "mock simulator (runtime/mock_habitat.py), hermetic",
    )
    parser.add_argument("--mesh", type=int, default=None, choices=[0, 1],
                        help="1: shard the mapper's renders over the visible devices "
                        "(MapperConfig.use_mesh; needs >1 device and height %% (devices*16) == 0)")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--step_num", type=int, default=None)
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--results_dir", required=True)
    parser.add_argument("--pixel_max", type=int, default=None)
    parser.add_argument("--save_runtime_data", type=int, default=0)
    parser.add_argument("--live_view_port", type=int, default=None,
                        help="serve the headless live-view dashboard on this port (0 = auto)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument(
        "--mode", default="auto", choices=["auto", "replay", "manual"],
        help="auto: planner-driven exploration; replay: re-run --actions through the mapper; "
        "manual: stdin keyboard teleop",
    )
    parser.add_argument("--actions", default=None, help="actions.txt for replay mode")
    args = parser.parse_args(argv)

    if args.mode == "replay" and not args.actions:
        parser.error("--mode replay requires --actions")

    scene_cfg = load_scene_config(args.config) if args.config else None
    sim_factory = None
    if args.habitat_sim == "mock":
        from activesplat_tpu_torch.runtime.mock_habitat import make_mock_sim

        sim_factory = make_mock_sim

    os.makedirs(args.results_dir, exist_ok=True)
    # the replayed actions are read, not written: the replay's dataset logs none
    episode = build_episode_from_config(
        scene_cfg or {"dataset": {"format": "synthetic", "scene_id": "two_room"}},
        None if args.mode == "replay" else args.results_dir,
        scene_id=args.scene_id,
        user_config_path=args.user_config,
        sim_factory=sim_factory,
        overrides={"seed": args.seed, "step_num": args.step_num, "width": args.width,
                   "height": args.height, "pixel_max": args.pixel_max},
    )
    dataset = episode["dataset"]
    # without --config the entry points' own MapperConfig() applies
    mapper_cfg = episode["mapper_cfg"] if scene_cfg else None
    if args.mesh is not None:
        mapper_cfg = dataclasses.replace(mapper_cfg or MapperConfig(), use_mesh=bool(args.mesh))
    common = dict(mapper_cfg=mapper_cfg, pixel_max=episode["pixel_max"], device=args.device)
    start = time.perf_counter()
    if args.mode == "replay":
        mapper_node = run_replay(dataset, args.actions, args.results_dir, **common)
    elif args.mode == "manual":
        mapper_node = run_manual(dataset, args.results_dir, **common)
    else:
        mapper_node, planner = run_episode(
            dataset, args.results_dir, save_runtime_data=bool(args.save_runtime_data),
            live_view_port=args.live_view_port,
            single_floor_expansion=episode["single_floor_expansion"],
            agent_foot_adjust=episode["agent_foot_adjust"], **common,
        )
    if args.device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - start
    steps, _ = dataset.get_step_info()
    if args.mode != "auto":
        print(f"{args.mode} finished: {steps} steps in {wall:.1f} s, "
              f"{mapper_node.mapper.num_gaussians()} gaussians")
        print(format_stage_report())
        return
    area = (0.0 if planner.free_map is None
            else np.count_nonzero(planner.free_map) * planner.topdown_cfg.meter_per_pixel ** 2)
    print(f"episode finished: {steps} steps in {wall:.1f} s ({wall / max(steps, 1) * 1e3:.1f} ms "
          f"an action, set-up and outputs included), {mapper_node.mapper.num_gaussians()} "
          f"gaussians, explored free area {area:.2f} m^2")
    print(format_stage_report())


if __name__ == "__main__":
    main()
