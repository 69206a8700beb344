"""Traffic kind `explore`: the program's planner-driven exploration episode,
composed by `launch.build_episode_from_config` from the configuration's
scene config and driven by `launch.run_episode` (the mapper node, the
planner FSM, the bus and the queries) with the program's defaults. The loop
is closed: the planner issues its next action only when the mapper and the
planner have finished the last one. The episode runs until the harness's
clock closes the window from inside a simulator step."""

from __future__ import annotations

from typing import Callable, Dict


def run(scene_cfg: Dict, results_dir: str, sim_factory: Callable, traffic: Dict, seed: int,
        device: str) -> None:
    from activesplat_tpu_torch.runtime import launch

    ep = launch.build_episode_from_config(scene_cfg, results_dir, sim_factory=sim_factory)
    launch.run_episode(
        ep["dataset"], results_dir, mapper_cfg=ep["mapper_cfg"], pixel_max=ep["pixel_max"],
        single_floor_expansion=ep["single_floor_expansion"],
        agent_foot_adjust=ep["agent_foot_adjust"], device=device)
