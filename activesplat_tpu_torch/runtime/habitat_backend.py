"""Habitat-sim dataset backend (counterpart of
activesplat_tpu/runtime/habitat_backend.py): Gibson / MP3D / Replica.

An adapter against the habitat 0.2.3 API the reference uses
(src/dataloader/dataloader.py:34-300), import-gated: everything that touches
the habitat wheels happens inside ``setup()`` (or through an injected
``sim_factory``), so the class is constructible and fully testable with a
mock simulator where the wheels are absent. Without them, ``setup()`` with
no ``sim_factory`` raises ImportError; ``--habitat_sim mock`` (the BoxWorld
mock, runtime/mock_habitat.py) runs the same path hermetically.

CAVEAT — UNTESTED AGAINST THE REAL HABITAT API: the adapter has only ever
stepped mock simulators. The historically error-prone seams — habitat's RGBA
sensor formats, np.quaternion conventions, `sensor_states` frames, hfov
units — are asserted against the same assumptions the JAX package's adapter
encodes. A first run against real wheels should verify get_frame()'s c2w
against a known scene.

Behavioral contract mirrored from the reference:

  * env-yaml sensor parsing with the rgb/depth consistency checks
    (dataloader.py:44-68) and the Habitat intrinsics quirk cx = W/2 - 1,
    cy = H/2 - 1, fy = fx (src/dataloader/__init__.py:275-284); the YAML is
    read by configs/yaml_subset.py, not PyYAML;
  * ``setup()``: habitat.get_config + scene override +
    normalize_depth = False, sims.make_sim, sim.seed(0), reset, and the
    GetDatasetConfig payload (dataloader.py:123-165);
  * ``get_frame()``: rgb/255, depth squeeze + depth_scale + min/max clamp to
    0 (DepthFilter, image_transforms.py:34-46) + sc_factor, the
    downsample-resize path (OpenCV's INTER_AREA for rgb, per channel through
    queries/clusters.resize_area, and INTER_NEAREST for depth, in numpy;
    dataloader.py:185-201), c2w assembled from the rgb sensor state's
    quaternion + position with the rgb==depth sensor-state check
    (dataloader.py:203-232). Poses carry the reference's declared
    PoseDataType.C2W_OPENCV (dataloader.py:30).
  * ``apply_movement()``: twist -> _DefaultHabitatSimActions id, step budget,
    actions.txt append (dataloader.py:237-266). The adapter returns the
    pose-change result directly, matching the SyntheticDataset/MapperNode
    contract.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from enum import Enum
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from activesplat_tpu_torch.configs import CONFIG_DIR
from activesplat_tpu_torch.configs.yaml_subset import load as load_yaml
from activesplat_tpu_torch.queries.clusters import resize_area
from activesplat_tpu_torch.runtime.dataloader import (
    RGBDSensor,
    SimAction,
    twist_to_action,
)
from activesplat_tpu_torch.utils.transforms import compute_intrinsics, np_quat_to_rotmat

HABITAT_TRANSFORM_MATRIX = np.array(
    [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64
)  # habitat y-up mesh -> z-up (src/dataloader/__init__.py:20-25)


class DatasetFormat(Enum):
    MP3D = "mp3d"
    GIBSON = "gibson"
    REPLICA = "replica"


def scene_mesh_urls(
    fmt: DatasetFormat, root: str, scene_id: str
) -> Tuple[str, str]:
    """(habitat mesh, eval GT mesh) paths per dataset layout
    (get_scene_mesh_url, src/dataloader/__init__.py:55-66)."""
    if fmt == DatasetFormat.MP3D:
        base = os.path.join(root, "v1", "tasks", scene_id)
        return (
            os.path.join(base, f"{scene_id}.glb"),
            os.path.join(base, f"{scene_id}_semantic.ply"),
        )
    if fmt == DatasetFormat.GIBSON:
        url = os.path.join(root, f"{scene_id}.glb")
        return url, url
    if fmt == DatasetFormat.REPLICA:
        url = os.path.join(root, scene_id, "mesh.ply")
        return url, url
    raise ValueError(f"unsupported dataset format {fmt}")


@dataclasses.dataclass(frozen=True)
class HabitatEnvSpec:
    """The agent/sensor slice of a Habitat env yaml
    (config/env/activesplat_pointnav.yaml:33-56)."""

    width: int
    height: int
    hfov_deg: float
    position: Tuple[float, float, float]
    depth_min: float
    depth_max: float
    turn_angle: float
    tilt_angle: float
    forward_step_size: float
    agent_height: float = 1.5
    agent_radius: float = 0.1
    allow_sliding: bool = False

    @staticmethod
    def from_yaml(path: str) -> "HabitatEnvSpec":
        env = load_yaml(path)
        sim = env["habitat"]["simulator"]
        sensors = sim["agents"]["main_agent"]["sim_sensors"]
        rgb, depth = sensors["rgb_sensor"], sensors["depth_sensor"]
        # the reference's sensor-consistency asserts (dataloader.py:48-64)
        if not np.allclose(rgb["position"], depth["position"]):
            raise ValueError(f"RGB ({rgb['position']}) and Depth ({depth['position']}) sensor "
                             "positions differ")
        for key in ("width", "height", "hfov"):
            if not np.isclose(rgb[key], depth[key]):
                raise ValueError(f"RGB and Depth sensor {key} differ: {rgb[key]} vs {depth[key]}")
        agent = sim["agents"]["main_agent"]
        return HabitatEnvSpec(
            width=int(rgb["width"]),
            height=int(rgb["height"]),
            hfov_deg=float(rgb["hfov"]),
            position=tuple(float(x) for x in rgb["position"]),
            depth_min=float(depth["min_depth"]),
            depth_max=float(depth["max_depth"]),
            turn_angle=float(sim["turn_angle"]),
            tilt_angle=float(sim["tilt_angle"]),
            forward_step_size=float(sim["forward_step_size"]),
            agent_height=float(agent.get("height", 1.5)),
            agent_radius=float(agent.get("radius", 0.1)),
            allow_sliding=bool(
                sim.get("habitat_sim_v0", {}).get("allow_sliding", False)
            ),
        )

    def sensor(self, depth_scale: float, downsample: float = 1.0) -> RGBDSensor:
        """Downsampled intrinsics with the Habitat principal-point quirk
        (compute_intrinsics + RGBDSensor, src/dataloader/__init__.py:151-194,
        275-284)."""
        fx, fy, cx, cy = compute_intrinsics(
            self.width, self.height, np.deg2rad(self.hfov_deg)
        )
        w, h = self.width, self.height
        if downsample > 1.0:
            h = int(np.ceil(self.height / downsample))
            w = int(np.ceil(self.width / downsample))
            fx, cx = fx * w / self.width, cx * w / self.width
            fy, cy = fy * h / self.height, cy * h / self.height
        elif downsample != 1.0:
            raise ValueError(f"invalid downsample factor {downsample}")
        return RGBDSensor(
            height=h,
            width=w,
            fx=fx,
            fy=fy,
            cx=cx,
            cy=cy,
            depth_min=self.depth_min,
            depth_max=self.depth_max,
            depth_scale=depth_scale,
            position=np.asarray(self.position, np.float64),
        )


def _quat_to_matrix(q) -> np.ndarray:
    """Rotation matrix from a quaternion object (np.quaternion from the
    habitat stack, or anything exposing w/x/y/z)."""
    return np_quat_to_rotmat(np.array([q.w, q.x, q.y, q.z], np.float64))


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """OpenCV's INTER_NEAREST resize: destination index d reads source index
    floor(d * (1 / (dst / src))), clamped to the last source index."""
    h, w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w))).astype(np.int64), w - 1)
    return img[ys[:, None], xs[None, :]]


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # torch tensor from habitat's sensor suite
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class HabitatDataset:
    """Habitat-sim-backed discrete agent with the SyntheticDataset interface
    (get_frame/step/apply_movement/reset/close/is_finished/get_step_info/
    dataset_config)."""

    def __init__(
        self,
        env_config_path: str,
        scene_id: str,
        dataset_format: DatasetFormat | str = DatasetFormat.GIBSON,
        dataset_root: str = "",
        step_num: int = 1000,
        depth_scale: float = 1.0,
        sc_factor: float = 1.0,
        downsample: float = 1.0,
        scene_bbox: Optional[np.ndarray] = None,
        results_dir: Optional[str] = None,
        sim_factory: Optional[Callable[[dict], object]] = None,
        planner: Optional[Dict] = None,
    ) -> None:
        self.env_config_path = env_config_path
        self.spec = HabitatEnvSpec.from_yaml(env_config_path)
        self.sensor = self.spec.sensor(depth_scale, downsample)
        self.scene_id = scene_id
        self.dataset_format = DatasetFormat(dataset_format)
        self.step_num = int(step_num)
        self.sc_factor = float(sc_factor)
        self.habitat_mesh_url, self.scene_mesh_url = scene_mesh_urls(
            self.dataset_format, dataset_root, scene_id
        )
        self.scene_bbox = (
            np.asarray(scene_bbox, np.float64)
            if scene_bbox is not None
            else np.full((3, 2), np.nan)
        )
        self.turn_angle_deg = self.spec.turn_angle
        self.tilt_angle_deg = self.spec.tilt_angle
        self.forward_step = self.spec.forward_step_size
        self.agent_radius = self.spec.agent_radius
        self.agent_height = self.spec.agent_height
        # the scene config's planner block, handed to the planner in the
        # get_dataset_config payload (PlannerFSM reads its knobs there)
        self.planner = dict(planner or {})

        self._sim = None
        self._sim_factory = sim_factory
        self._frame_id = 0
        self._step_times = 0
        self._finished = False
        self.results_dir = results_dir
        self._action_path = None
        if results_dir is not None:
            os.makedirs(results_dir, exist_ok=True)
            self._action_path = os.path.join(results_dir, "actions.txt")
            open(self._action_path, "w").close()

    # ------------------------------------------------------------------ #

    def setup(self) -> Dict:
        """Build the simulator and return the GetDatasetConfig payload
        (dataloader.py:123-165)."""
        if self._sim_factory is not None:
            self._sim = self._sim_factory(
                {
                    "env_config_path": self.env_config_path,
                    "scene": self.habitat_mesh_url,
                    "spec": self.spec,
                }
            )
        else:
            try:
                import habitat
                from habitat import sims
                from omegaconf import OmegaConf
            except ImportError as exc:
                raise ImportError(
                    f"the real Habitat simulator needs the habitat-sim and habitat-lab wheels "
                    f"({exc}); --habitat_sim mock (sim_factory=make_mock_sim) runs the same "
                    f"path hermetically on the BoxWorld mock"
                ) from exc

            config = habitat.get_config(self.env_config_path)
            OmegaConf.set_readonly(config, False)
            config.habitat.simulator.scene = self.habitat_mesh_url
            # raw metric depth, not [0,1]-normalized (dataloader.py:126-128)
            config.habitat.simulator.agents.main_agent.sim_sensors[
                "depth_sensor"
            ].normalize_depth = False
            OmegaConf.set_readonly(config, True)
            self._sim = sims.make_sim(
                config.habitat.simulator.type, config=config.habitat.simulator
            )
        self._sim.seed(0)
        # Dataset configs ship bbox=null (the reference hand-fills per-scene
        # bounds in user configs); derive the scene bbox from the navmesh
        # when absent so the topdown grid can always be constructed.
        if not np.isfinite(self.scene_bbox).all():
            pathfinder = getattr(self._sim, "pathfinder", None)
            if pathfinder is not None and hasattr(pathfinder, "get_bounds"):
                lo, hi = pathfinder.get_bounds()
                self.scene_bbox = np.stack(
                    [np.asarray(lo, np.float64), np.asarray(hi, np.float64)],
                    axis=1,
                )  # (3, 2)
        self.reset()
        return self.dataset_config(self.results_dir or "")

    def _observations(self) -> Dict[str, np.ndarray]:
        obs = self._sim.get_sensor_observations()
        suite = getattr(self._sim, "sensor_suite", None)
        if suite is not None:
            obs = suite.get_observations(obs)  # dataloader.py:136
        return obs

    def get_frame(self) -> Dict[str, np.ndarray]:
        obs = self._observations()
        rgb = _to_numpy(obs["rgb"]).astype(np.float32)[..., :3] / 255.0
        depth = np.squeeze(_to_numpy(obs["depth"])).astype(np.float32)
        depth = depth / self.sensor.depth_scale
        # DepthFilter: out-of-range depth -> 0 (image_transforms.py:34-46)
        invalid = (depth > self.sensor.depth_max) | (depth < self.sensor.depth_min)
        depth = np.where(invalid, 0.0, depth) * self.sc_factor

        ih, iw = depth.shape
        if ih != self.sensor.height or iw != self.sensor.width:
            ratio_h = ih / self.sensor.height
            ratio_w = iw / self.sensor.width
            if not np.isclose(ratio_h, ratio_w):
                raise ValueError(
                    f"frame {depth.shape} does not match sensor "
                    f"{self.sensor.height}x{self.sensor.width}"
                )
            if ratio_h < 1.0:
                raise NotImplementedError("upsampling frames not supported")
            rgb = np.stack(
                [resize_area(rgb[..., c], self.sensor.width, self.sensor.height)
                 for c in range(rgb.shape[-1])],
                axis=-1,
            ).astype(np.float32)
            depth = resize_nearest(depth, self.sensor.width, self.sensor.height)

        state = self._sim.get_agent_state()
        rgb_state = state.sensor_states["rgb"]
        depth_state = state.sensor_states["depth"]
        if not np.allclose(rgb_state.position, depth_state.position):
            raise ValueError("rgb/depth sensor positions diverged")
        c2w = np.eye(4)
        c2w[:3, :3] = _quat_to_matrix(rgb_state.rotation)
        c2w[:3, 3] = np.asarray(rgb_state.position, np.float64)

        frame = {
            "frame_id": self._frame_id,
            "c2w": c2w.astype(np.float32),
            "rgb": rgb,
            "depth": depth,
        }
        self._frame_id += 1
        return frame

    # ------------------------------------------------------------------ #

    def step(self, action: SimAction) -> bool:
        """Apply one discrete action; False when the step budget is spent or
        a forward move was blocked (pose unchanged — no sliding)."""
        if self._step_times >= self.step_num:
            self._finished = True
            return False
        before = np.asarray(self._sim.get_agent_state().position, np.float64)
        self._sim.step(int(action))
        self._step_times += 1
        if self._action_path is not None:
            with open(self._action_path, "a") as fh:
                fh.write(f"{int(action)}\n")
        if self._step_times >= self.step_num:
            self._finished = True
        if action == SimAction.MOVE_FORWARD:
            after = np.asarray(self._sim.get_agent_state().position, np.float64)
            return bool(np.linalg.norm(after - before) > 1e-6)
        return True

    def apply_movement(self, twist: Dict[str, np.ndarray]) -> bool:
        action = twist_to_action(twist)
        if action is None:
            return False
        return self.step(action)

    def reset(self) -> None:
        self._sim.reset()
        self._frame_id = 0
        self._step_times = 0
        self._finished = False

    def close(self) -> None:
        if self._sim is not None:
            self._sim.close()

    def is_finished(self) -> bool:
        return self._finished

    def get_step_info(self) -> Tuple[int, int]:
        return self._step_times, self.step_num

    def get_scene_id(self) -> str:
        return self.scene_id

    def dataset_config(self, results_dir: str) -> Dict:
        """GetDatasetConfig payload (field set of srv/GetDatasetConfig.srv;
        assembly dataloader.py:138-163)."""
        s = self.sensor
        return {
            "results_dir": results_dir,
            "scene_id": self.scene_id,
            "pose_data_type": "C2W_OPENCV",  # dataloader.py:30
            "height_direction": 2,  # HeightDirection.Y_NEGATIVE (dataloader.py:32)
            "agent_height": self.agent_height,
            "agent_radius": self.agent_radius,
            "agent_forward_step_size": self.forward_step,
            "agent_turn_angle": self.turn_angle_deg,
            "agent_tilt_angle": self.tilt_angle_deg,
            "rgbd_position": s.position,
            "scene_bbox": self.scene_bbox,
            "scene_mesh_url": self.scene_mesh_url,
            "scene_mesh_transform": HABITAT_TRANSFORM_MATRIX,
            "step_num": self.step_num,
            "depth_min": s.depth_min,
            "depth_max": s.depth_max,
            "depth_scale": s.depth_scale,
            "width": s.width,
            "height": s.height,
            "intrinsics": s.intrinsics,
            "planner": dict(self.planner),
        }


def make_results_dir(
    package_root: str, dataset_format: str, scene_id: str, remark: str = ""
) -> str:
    """Timestamped results folder, reference layout
    (dataloader.py:115-121)."""
    name = time.strftime("%Y-%m-%d_%H-%M-%S") + f"_{dataset_format}_{scene_id}"
    if remark and remark != "NONE":
        name += f"_{remark}"
    return os.path.join(package_root, "results", name)


def get_dataset(
    config: Dict,
    user_config: Dict,
    scene_id: str = "None",
    remark: str = "NONE",
    results_root: Optional[str] = None,
    results_dir: Optional[str] = None,
    sim_factory: Optional[Callable] = None,
) -> HabitatDataset:
    """Dataset factory from a scene-config dict + user dataset-roots dict
    (get_dataset, dataloader.py:293-300; user_config layout
    config/.templates/user_config.json). `results_root` creates the
    reference's timestamped results/<stamp>_<fmt>_<scene> folder under it;
    `results_dir` (the launcher's explicit --results_dir) is used verbatim
    instead."""
    ds = config["dataset"]
    fmt = DatasetFormat(ds["format"])
    sid = ds["scene_id"] if scene_id in ("None", "Eval") else scene_id
    root = user_config["datasets"][fmt.value]["root"]
    if scene_id != "Eval" and results_dir is None and results_root is not None:
        results_dir = make_results_dir(
            results_root, fmt.value, sid, ds.get("remark", "")
        )
    if scene_id == "Eval":
        results_dir = None
    if results_dir is not None:
        os.makedirs(results_dir, exist_ok=True)
        with open(os.path.join(results_dir, "config.json"), "w") as fh:
            json.dump(config, fh, indent=4)
    env_path = config["env"]["config"]
    if not os.path.isabs(env_path):
        # "config/env/x.yaml" references resolve against the bundled configs
        bundled = os.path.join(CONFIG_DIR, "env", os.path.basename(env_path))
        env_path = bundled if os.path.exists(bundled) else env_path
    bbox = np.asarray(ds.get("bbox", [[None] * 3] * 2), np.float64)
    return HabitatDataset(
        env_config_path=env_path,
        scene_id=sid,
        dataset_format=fmt,
        dataset_root=root,
        step_num=int(ds.get("step_num", 1000)),
        depth_scale=float(ds.get("depth_scale", 1.0)),
        sc_factor=float(ds.get("sc_factor", 1.0)),
        downsample=float(ds.get("downsample", 1.0)),
        scene_bbox=bbox.T if bbox.shape == (2, 3) else bbox,
        results_dir=results_dir,
        sim_factory=sim_factory,
        planner=config.get("planner"),
    )
