"""Batch scene evaluation (counterpart of activesplat_tpu/eval/batch.py): run
episodes over scene lists and aggregate the coverage judge (reference:
scripts/batch/run_batch_scenes.sh + eval_results_actions.py — loops scenes x
repetitions, then scores every actions.txt).

Scene sets: the synthetic ones, and the reference's Habitat scene lists
(HABITAT_SCENE_SETS) through the scene configs and the Habitat adapter. The
real simulator needs the habitat wheels; sim_factory=make_mock_sim
(runtime/mock_habitat.py) runs the whole protocol hermetically.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from activesplat_tpu_torch.device import DeviceLike
from activesplat_tpu_torch.configs import (
    load_scene_config,
    load_scene_list,
    load_user_config,
    mapper_config_from_scene,
)
from activesplat_tpu_torch.eval.replay import eval_actions
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.runtime.launch import make_synthetic_dataset, run_episode

# synthetic benchmark suite (role of gibson_small.txt etc.)
SCENE_SETS: Dict[str, List[Dict]] = {
    "synthetic_small": [
        {"scene_id": "single_room", "seed": s, "step_num": 300} for s in range(3)
    ],
    "synthetic_big": [
        {"scene_id": "two_room", "seed": s, "step_num": 600} for s in range(3)
    ],
}

# the reference's 13-scene benchmark protocol: scene-list name ->
# (dataset config, step budget) (run_batch_scenes.sh:13-21)
HABITAT_SCENE_SETS: Dict[str, tuple] = {
    "gibson_small": ("gibson", 1000),
    "gibson_big": ("gibson_large", 2000),
    "mp3d_small": ("mp3d", 1000),
    "mp3d_big": ("mp3d_large", 2000),
}


def habitat_scene_specs(set_name: str) -> List[Dict]:
    """Episode specs for a reference scene list (the real simulator needs the
    habitat wheels; the spec surface is importable everywhere)."""
    config_name, step_num = HABITAT_SCENE_SETS[set_name]
    cfg = load_scene_config(config_name)
    return [
        {"scene_id": scene, "seed": 0, "step_num": step_num, "scene_config": cfg}
        for scene in load_scene_list(set_name)
    ]


def habitat_dataset_factory(user_config_path=None, sim_factory=None):
    """Default dataset_factory(spec, results_dir) for the habitat scene sets:
    builds HabitatDataset from the spec's scene config + user dataset roots
    (reference flow: run_batch_scenes.sh -> habitat.launch config/scene_id
    args -> get_dataset). results_dir=None builds the judge's fresh 'Eval'
    dataset (no actions.txt, no result dumps — eval_actions.py:42-60)."""
    from activesplat_tpu_torch.runtime.habitat_backend import get_dataset

    user = load_user_config(user_config_path)

    def factory(spec, results_dir):
        cfg = dict(spec["scene_config"])
        cfg["dataset"] = dict(cfg["dataset"], scene_id=spec["scene_id"],
                              step_num=spec["step_num"])
        return get_dataset(
            cfg,
            user,
            scene_id=spec["scene_id"] if results_dir is not None else "Eval",
            results_dir=results_dir,
            sim_factory=sim_factory,
        )

    return factory


def run_batch(
    scene_set: str,
    output_dir: str,
    repetitions: int = 1,
    mapper_cfg: Optional[MapperConfig] = None,
    width: int = 128,
    height: int = 128,
    pixel_max: int = 180,
    dataset_factory=None,
    user_config_path=None,
    sim_factory=None,
    device: DeviceLike = None,
) -> List[Dict]:
    """Run episodes (on `device`, CUDA unless the caller names the CPU) and
    the coverage judge over a scene set; writes actions_error.txt per run
    and a summary.json (eval_results_actions.py output shape). scene_set may
    be a synthetic set or one of the reference habitat lists
    (HABITAT_SCENE_SETS, built with the default habitat_dataset_factory
    unless a dataset_factory is passed; sim_factory and user_config_path
    thread into the default). `dataset_factory(spec, results_dir)` builds
    both the episode's dataset (results_dir set) and the judge's fresh
    replay (results_dir None)."""
    if scene_set in HABITAT_SCENE_SETS:
        specs = habitat_scene_specs(scene_set)
        if dataset_factory is None:
            dataset_factory = habitat_dataset_factory(user_config_path, sim_factory)
    else:
        specs = SCENE_SETS[scene_set]
    results = []
    for spec in specs:

        def build(results_dir):
            # one constructor for the episode and replay datasets, so their
            # parameters can never silently diverge
            if dataset_factory is not None:
                return dataset_factory(spec, results_dir)
            return make_synthetic_dataset(
                scene_id=spec["scene_id"],
                seed=spec["seed"],
                step_num=spec["step_num"],
                width=width,
                height=height,
                results_dir=results_dir,
            )

        spec_mapper_cfg, spec_pixel_max = mapper_cfg, pixel_max
        if "scene_config" in spec:
            scfg = spec["scene_config"]
            if spec_mapper_cfg is None:
                spec_mapper_cfg = mapper_config_from_scene(scfg)
            spec_pixel_max = scfg.get("painter", {}).get("grid_map", {}).get("pixel_max",
                                                                             pixel_max)
        for rep in range(repetitions):
            run_name = f"{spec['scene_id']}-{spec['seed']}-rep{rep}"
            results_dir = os.path.join(output_dir, run_name)
            run_episode(build(results_dir), results_dir, mapper_cfg=spec_mapper_cfg,
                        pixel_max=spec_pixel_max, device=device)
            report = eval_actions(build(None), os.path.join(results_dir, "actions.txt"))
            with open(os.path.join(results_dir, "actions_error.txt"), "w") as fh:
                fh.write(report.as_row() + "\n")
            results.append(
                {
                    "run": run_name,
                    "completeness": report.completeness,
                    "completeness_ratio": report.completeness_ratio,
                    "accuracy": report.accuracy,
                    "path_length": report.path_length,
                }
            )
            # summary.json is rewritten after every run so a killed or
            # timed-out set keeps the rows it finished
            _write_summary(scene_set, output_dir, results)
    return results


def _write_summary(scene_set: str, output_dir: str, results: List[Dict]) -> None:
    summary = {
        "scene_set": scene_set,
        "runs": results,
        "mean_completeness": float(np.mean([r["completeness"] for r in results])),
        "mean_completeness_ratio": float(np.mean([r["completeness_ratio"] for r in results])),
        "mean_accuracy": float(np.mean([r["accuracy"] for r in results])),
    }
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
