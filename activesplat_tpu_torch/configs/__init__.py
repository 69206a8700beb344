"""Config surface (counterpart of activesplat_tpu/configs/__init__.py):
per-scene JSON configs (the reference's config/datasets/*.json tier), the
Habitat env YAMLs, the benchmark scene lists, and the loaders that turn
them into runtime objects. The files under this directory are the port's
own copies; the YAMLs are read by `yaml_subset`, since the machine with the
card has no PyYAML."""

from __future__ import annotations

import json
import os

from activesplat_tpu_torch.mapper.config import LearningRates, MapperConfig

CONFIG_DIR = os.path.dirname(os.path.abspath(__file__))


def load_scene_config(name_or_path: str) -> dict:
    """Load a scene JSON by name (bundled synthetic configs at the top level,
    Gibson/MP3D benchmark configs under datasets/ — ports of the reference's
    config/datasets/*.json) or by path."""
    path = name_or_path
    if not os.path.exists(path):
        for candidate in (
            os.path.join(CONFIG_DIR, f"{name_or_path}.json"),
            os.path.join(CONFIG_DIR, "datasets", f"{name_or_path}.json"),
        ):
            if os.path.exists(candidate):
                path = candidate
                break
    with open(path) as fh:
        return json.load(fh)


def load_scene_list(name: str) -> list:
    """Benchmark scene list (ports of scripts/batch/*.txt: gibson_small,
    gibson_big, mp3d_small, mp3d_big)."""
    path = os.path.join(CONFIG_DIR, "batch", f"{name}.txt")
    with open(path) as fh:
        return [line.strip() for line in fh if line.strip()]


def load_user_config(path: str | None = None) -> dict:
    """Dataset-roots config (config/.templates/user_config.json layout)."""
    if path is None:
        path = os.path.join(CONFIG_DIR, "user_config.template.json")
    with open(path) as fh:
        return json.load(fh)


def mapper_config_from_scene(cfg: dict, **overrides) -> MapperConfig:
    """Build a MapperConfig from the scene JSON's mapper block
    (key layout mirrors config/datasets/gibson.json 'mapper' + the SplaTAM
    module config tier). `use_mesh` shards the mapper's renders over the
    visible devices (mapper/splatam.py)."""
    mapper = cfg.get("mapper", {})
    splatam = cfg.get("splatam", {})
    lrs = LearningRates(**splatam.get("lrs", {}))
    kwargs = dict(
        map_every=mapper.get("map_every", 5),
        kf_every=mapper.get("keyframe_every", 5),
        mapping_window_size=mapper.get("mapping_window_size", 12),
        mapping_iters=mapper.get("mapping_iters", 2),
        densify_downscale_factor=mapper.get("densify_downscale_factor", 1),
        use_mesh=bool(mapper.get("use_mesh", False)),
        sil_thres=splatam.get("sil_thres", 0.98),
        loss_w_im=splatam.get("loss_weights", {}).get("im", 0.5),
        loss_w_depth=splatam.get("loss_weights", {}).get("depth", 1.0),
        gaussian_distribution=splatam.get("gaussian_distribution", "anisotropic"),
        seed=splatam.get("seed", 0),
        lrs=lrs,
    )
    kwargs.update(overrides)
    return MapperConfig(**kwargs)


def dataset_kwargs_from_scene(cfg: dict) -> dict:
    ds = cfg.get("dataset", {})
    env = cfg.get("env", {})
    return dict(
        scene_id=ds.get("scene_id", "two_room"),
        seed=ds.get("seed", 0),
        step_num=ds.get("step_num", 500),
        width=env.get("width", 256),
        height=env.get("height", 256),
        hfov_deg=env.get("hfov", 90.0),
        depth_max=ds.get("far", 10.0),
        turn_angle_deg=env.get("turn_angle", 10.0),
        tilt_angle_deg=env.get("tilt_angle", 15.0),
    )
