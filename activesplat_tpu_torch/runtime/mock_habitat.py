"""Geometric mock habitat simulator (counterpart of
activesplat_tpu/runtime/mock_habitat.py): a habitat-sim-API-shaped agent
backed by the BoxWorld raycaster.

Why this exists: the habitat wheels are absent from the machines this port
runs on, so `HabitatDataset` (runtime/habitat_backend.py) cannot step a real
scene there. This mock implements the slice of the habitat-sim API the
adapter consumes — `step(action_id)` / `get_sensor_observations()` /
`get_agent_state()` (with `sensor_states`) / `seed` / `reset` / `close` /
`pathfinder.get_bounds()` — over real BoxWorld geometry, so the full episode
path (config JSON -> env yaml -> HabitatDataset -> MapperNode + PlannerFSM ->
reference result layout) runs hermetically end to end. Inject it as
``HabitatDataset(sim_factory=make_mock_sim)`` or via
``launch.py --habitat_sim mock``. The scene pick from the scene url is the
JAX package's, so the same scene id explores the same room in both packages.

Conventions: the adapter takes the sensor-state quaternion *raw* as an
OpenCV c2w rotation (reference parity, dataloader.py:223-226 — see the
real-API caveat in habitat_backend.py). The mock therefore hands out
quaternions of genuine OpenCV c2w rotations in its y-up world, making the
whole episode geometrically self-consistent; it intentionally does NOT
emulate habitat's OpenGL sensor-frame quaternions. Observations mimic
habitat's shapes: RGBA uint8 for rgb, (H, W, 1) float32 metric depth.
"""

from __future__ import annotations

import types
from typing import Dict

import numpy as np

from activesplat_tpu_torch.runtime.dataloader import SimAction
from activesplat_tpu_torch.runtime.synthetic import BoxWorld
from activesplat_tpu_torch.utils.transforms import (
    compute_intrinsics,
    np_rotmat_to_quat,
    rot_axis,
)


class _Quat:
    """np.quaternion stand-in exposing w/x/y/z (what the adapter reads)."""

    def __init__(self, wxyz: np.ndarray) -> None:
        self.w, self.x, self.y, self.z = (float(v) for v in wxyz)


class BoxWorldSim:
    """Habitat-sim-shaped discrete agent over BoxWorld geometry."""

    def __init__(self, spec, world: BoxWorld, start_position=None) -> None:
        self.spec = spec
        self.world = world
        fx, fy, cx, cy = compute_intrinsics(
            spec.width, spec.height, np.deg2rad(spec.hfov_deg)
        )
        self._intrinsics = np.array(
            [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64
        )
        if start_position is None:
            sx, _, sz = world.size
            start_position = np.array([sx / 2, 0.0, sz / 2], np.float64)
            for dx in np.linspace(0, min(sx, sz) / 2 - 0.5, 8):
                candidate = np.array([sx / 2 + dx, 0.0, sz / 4])
                if world.is_free(candidate[[0, 2]], spec.agent_radius):
                    start_position = candidate
                    break
        self._start = np.asarray(start_position, np.float64)
        self._seed = 0
        self.reset()

    # ------------------------------------------------------------------ #
    # habitat-sim API surface consumed by HabitatDataset

    def seed(self, value: int) -> None:
        self._seed = int(value)

    def reset(self) -> None:
        self.position = self._start.copy()  # agent base, y = floor height
        self.yaw_deg = 0.0
        self.pitch_deg = 0.0

    def close(self) -> None:
        pass

    @property
    def pathfinder(self):
        sx, sy, sz = self.world.size
        return types.SimpleNamespace(
            get_bounds=lambda: (np.zeros(3), np.array([sx, sy, sz]))
        )

    def step(self, action: int) -> None:
        """Habitat pointnav action ids; turn/tilt/forward dynamics identical
        to SyntheticDataset.step (same yaml agent config), collision = agent
        cylinder vs BoxWorld with no sliding."""
        action = int(action)
        if action == int(SimAction.TURN_LEFT):
            self.yaw_deg = (self.yaw_deg + self.spec.turn_angle) % 360
        elif action == int(SimAction.TURN_RIGHT):
            self.yaw_deg = (self.yaw_deg - self.spec.turn_angle) % 360
        elif action == int(SimAction.LOOK_UP):
            self.pitch_deg = min(self.pitch_deg + self.spec.tilt_angle, 30.0)
        elif action == int(SimAction.LOOK_DOWN):
            self.pitch_deg = max(self.pitch_deg - self.spec.tilt_angle, -30.0)
        elif action == int(SimAction.MOVE_FORWARD):
            yaw = np.deg2rad(self.yaw_deg)
            forward = np.array([-np.sin(yaw), 0.0, -np.cos(yaw)])
            target = self.position + forward * self.spec.forward_step_size
            if self.world.is_free(target[[0, 2]], self.spec.agent_radius):
                self.position = target  # else blocked: pose unchanged

    def _camera_c2w(self) -> np.ndarray:
        """OpenCV c2w of the RGB-D sensor (level camera looks -z at yaw 0;
        same construction as SyntheticDataset.camera_c2w)."""
        c2w = np.eye(4)
        c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
        c2w[:3, 3] = self.position + np.asarray(self.spec.position)
        c2w = rot_axis(c2w, "y", np.deg2rad(-self.yaw_deg))
        return rot_axis(c2w, "x", np.deg2rad(self.pitch_deg))

    def get_sensor_observations(self) -> Dict[str, np.ndarray]:
        rgb, depth = self.world.render(
            self._camera_c2w(),
            self._intrinsics,
            self.spec.width,
            self.spec.height,
            depth_max=self.spec.depth_max,
            depth_min=self.spec.depth_min,
        )
        rgba = np.concatenate(
            [
                (rgb * 255).astype(np.uint8),
                np.full(rgb.shape[:2] + (1,), 255, np.uint8),
            ],
            axis=-1,
        )  # habitat rgb sensors return RGBA uint8
        return {"rgb": rgba, "depth": depth[..., None].astype(np.float32)}

    def get_agent_state(self):
        c2w = self._camera_c2w()
        sensor_q = _Quat(np_rotmat_to_quat(c2w[:3, :3]))
        sensor = types.SimpleNamespace(
            position=c2w[:3, 3].copy(), rotation=sensor_q
        )
        agent_c2w = np.eye(4)
        agent_c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
        agent_c2w = rot_axis(agent_c2w, "y", np.deg2rad(-self.yaw_deg))
        return types.SimpleNamespace(
            position=self.position.copy(),
            rotation=_Quat(np_rotmat_to_quat(agent_c2w[:3, :3])),
            sensor_states={"rgb": sensor, "depth": sensor},
        )


def make_mock_sim(config: Dict) -> BoxWorldSim:
    """sim_factory for HabitatDataset: picks a BoxWorld scene deterministically
    from the habitat scene url so different scene_ids explore different
    rooms. config is the adapter's factory payload
    ({env_config_path, scene, spec}, habitat_backend.py setup())."""
    scene = str(config.get("scene", ""))
    seed = sum(ord(ch) for ch in scene) % 97
    world = (
        BoxWorld.two_room(seed=seed)
        if seed % 2 == 0
        else BoxWorld.single_room(seed=seed)
    )
    return BoxWorldSim(config["spec"], world)
