"""Simulator-backed RGB-D datasets (counterpart of
activesplat_tpu/runtime/dataloader.py).

Equivalent of the reference dataloader (src/dataloader/dataloader.py):
discrete Habitat-style agents producing RGB-D frames + OpenCV c2w poses, with
twist->action mapping, action logging, collision-driven movement failure, and
a per-episode step budget.

Backend: SyntheticDataset, the hermetic BoxWorld raycaster (numpy, on the
host). The Habitat backend is not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from enum import IntEnum
from typing import Dict, Optional

import numpy as np

from activesplat_tpu_torch.runtime.synthetic import BoxWorld
from activesplat_tpu_torch.utils.transforms import compute_intrinsics, rot_axis


class SimAction(IntEnum):
    """Habitat's default pointnav action ids — actions.txt stores these
    integer values (dataloader.py:255-263)."""

    STOP = 0
    MOVE_FORWARD = 1
    TURN_LEFT = 2
    TURN_RIGHT = 3
    LOOK_UP = 4
    LOOK_DOWN = 5


@dataclasses.dataclass
class RGBDSensor:
    """Pinhole RGB-D sensor description (reference:
    src/dataloader/__init__.py:151-194)."""

    height: int
    width: int
    fx: float
    fy: float
    cx: float
    cy: float
    depth_min: float
    depth_max: float
    depth_scale: float = 1.0
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.25, 0.0])
    )

    @property
    def intrinsics(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float64
        )

    @property
    def hfov(self) -> float:
        return 2 * np.arctan(self.width / (2 * self.fx))

    @property
    def vfov(self) -> float:
        return 2 * np.arctan(self.height / (2 * self.fy))

    @staticmethod
    def from_fov(width: int, height: int, hfov_deg: float = 90.0, **kw) -> "RGBDSensor":
        fx, fy, cx, cy = compute_intrinsics(width, height, np.deg2rad(hfov_deg))
        return RGBDSensor(
            height=height, width=width, fx=fx, fy=fy, cx=cx, cy=cy, **kw
        )


def twist_to_action(twist: Dict[str, np.ndarray]) -> Optional[SimAction]:
    """Twist -> discrete action (dataloader.py:242-258 mapping: +wz left,
    -wz right, +wy look DOWN, -wy look up, +vx forward)."""
    angular = np.asarray(twist.get("angular", np.zeros(3)))
    linear = np.asarray(twist.get("linear", np.zeros(3)))
    if angular[2] > 0:
        return SimAction.TURN_LEFT
    if angular[2] < 0:
        return SimAction.TURN_RIGHT
    if angular[1] > 0:
        return SimAction.LOOK_DOWN
    if angular[1] < 0:
        return SimAction.LOOK_UP
    if linear[0] > 0:
        return SimAction.MOVE_FORWARD
    return None


def action_to_twist(action: SimAction) -> Dict[str, np.ndarray]:
    """Inverse of twist_to_action: the twist the planner would publish for a
    discrete action (used by the REPLAY mode to drive recorded actions.txt
    through the live cmd_vel path)."""
    linear = np.zeros(3)
    angular = np.zeros(3)
    if action == SimAction.TURN_LEFT:
        angular[2] = 0.2
    elif action == SimAction.TURN_RIGHT:
        angular[2] = -0.2
    elif action == SimAction.LOOK_DOWN:
        angular[1] = 1.0
    elif action == SimAction.LOOK_UP:
        angular[1] = -1.0
    elif action == SimAction.MOVE_FORWARD:
        linear[0] = 0.2
    return {"linear": linear, "angular": angular}


class SyntheticDataset:
    """BoxWorld-backed discrete agent with Habitat pointnav dynamics
    (turn 10 deg, tilt 15 deg, forward 0.065 m, no sliding — the benchmark
    agent config, config/env/activesplat_pointnav.yaml:33-50)."""

    def __init__(
        self,
        world: BoxWorld,
        sensor: RGBDSensor,
        step_num: int = 500,
        start_position: Optional[np.ndarray] = None,
        start_yaw_deg: float = 0.0,
        turn_angle_deg: float = 10.0,
        tilt_angle_deg: float = 15.0,
        forward_step: float = 0.065,
        agent_radius: float = 0.1,
        agent_height: float = 1.5,
        max_tilt_deg: float = 30.0,
        results_dir: Optional[str] = None,
        scene_id: str = "BoxWorld",
        planner: Optional[Dict] = None,
    ) -> None:
        self.world = world
        self.sensor = sensor
        self.step_num = int(step_num)
        self.turn_angle_deg = turn_angle_deg
        self.tilt_angle_deg = tilt_angle_deg
        self.forward_step = forward_step
        self.agent_radius = agent_radius
        self.agent_height = agent_height
        self.max_tilt_deg = max_tilt_deg
        self.scene_id = scene_id
        # the scene config's planner block, handed to the planner in the
        # get_dataset_config payload (PlannerFSM reads its knobs there)
        self.planner = dict(planner or {})

        if start_position is None:
            sx, _, sz = world.size
            start_position = np.array([sx / 2, 0.0, sz / 2])
        self._start = (np.asarray(start_position, np.float64), float(start_yaw_deg))
        self.position = self._start[0].copy()  # agent base (y = floor height)
        self.yaw_deg = self._start[1]
        self.pitch_deg = 0.0

        self._frame_id = 0
        self._step_times = 0
        self._finished = False
        self._action_log = None
        if results_dir is not None:
            os.makedirs(results_dir, exist_ok=True)
            self._action_path = os.path.join(results_dir, "actions.txt")
            self._action_log = open(self._action_path, "w")

    # ------------------------------------------------------------------ #

    def camera_c2w(self) -> np.ndarray:
        """OpenCV c2w of the RGB-D sensor (at agent position + sensor offset,
        heading yaw, pitch about the camera's own x-axis)."""
        c2w = np.eye(4)
        c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])  # level camera looking -z
        c2w[:3, 3] = self.position + self.sensor.position
        c2w = rot_axis(c2w, "y", np.deg2rad(-self.yaw_deg))
        c2w = rot_axis(c2w, "x", np.deg2rad(self.pitch_deg))
        return c2w

    def get_frame(self) -> Dict[str, np.ndarray]:
        c2w = self.camera_c2w()
        rgb, depth = self.world.render(
            c2w,
            self.sensor.intrinsics,
            self.sensor.width,
            self.sensor.height,
            depth_max=self.sensor.depth_max,
            depth_min=self.sensor.depth_min,
        )
        frame = {
            "frame_id": self._frame_id,
            "c2w": c2w.astype(np.float32),
            "rgb": rgb,
            "depth": depth,
        }
        self._frame_id += 1
        return frame

    def step(self, action: SimAction) -> bool:
        """Apply one discrete action. Returns False when the move was blocked
        (collision, no sliding) — the movement-failure signal the reference
        derives from unchanged poses (visualizer.py:1724-1779)."""
        if self._step_times >= self.step_num:
            self._finished = True
            return False
        self._step_times += 1
        if self._action_log is not None:
            self._action_log.write(f"{int(action)}\n")
            self._action_log.flush()
        moved = True
        if action == SimAction.TURN_LEFT:
            self.yaw_deg = (self.yaw_deg + self.turn_angle_deg) % 360
        elif action == SimAction.TURN_RIGHT:
            self.yaw_deg = (self.yaw_deg - self.turn_angle_deg) % 360
        elif action == SimAction.LOOK_UP:
            new_pitch = self.pitch_deg + self.tilt_angle_deg
            moved = new_pitch <= self.max_tilt_deg
            if moved:
                self.pitch_deg = new_pitch
        elif action == SimAction.LOOK_DOWN:
            new_pitch = self.pitch_deg - self.tilt_angle_deg
            moved = new_pitch >= -self.max_tilt_deg
            if moved:
                self.pitch_deg = new_pitch
        elif action == SimAction.MOVE_FORWARD:
            # camera looks along -z at yaw 0, rotated by yaw about +y
            yaw = np.deg2rad(self.yaw_deg)
            forward = np.array([-np.sin(yaw), 0.0, -np.cos(yaw)])
            target = self.position + forward * self.forward_step
            if self.world.is_free(target[[0, 2]], self.agent_radius):
                self.position = target
            else:
                moved = False  # no sliding (activesplat_pointnav.yaml:56)
        elif action == SimAction.STOP:
            moved = True
        if self._step_times >= self.step_num:
            self._finished = True
        return moved

    def apply_movement(self, twist: Dict[str, np.ndarray]) -> bool:
        action = twist_to_action(twist)
        if action is None:
            return False
        return self.step(action)

    def reset(self) -> None:
        self.position, self.yaw_deg = self._start[0].copy(), self._start[1]
        self.pitch_deg = 0.0
        self._frame_id = 0
        self._step_times = 0
        self._finished = False

    def close(self) -> None:
        if self._action_log is not None:
            self._action_log.close()

    def is_finished(self) -> bool:
        return self._finished

    def get_step_info(self):
        return self._step_times, self.step_num

    def get_scene_id(self) -> str:
        return self.scene_id

    def dataset_config(self, results_dir: str) -> Dict:
        """The get_dataset_config payload (fields of srv/GetDatasetConfig)."""
        sx, sy, sz = self.world.size
        return {
            "results_dir": results_dir,
            "scene_id": self.scene_id,
            "pose_data_type": "C2W_OPENCV",
            "height_direction": 3,  # y-positive up (HeightDirection.Y_POSITIVE)
            "agent_height": self.agent_height,
            "agent_radius": self.agent_radius,
            "agent_forward_step_size": self.forward_step,
            "agent_turn_angle": self.turn_angle_deg,
            "agent_tilt_angle": self.tilt_angle_deg,
            "rgbd_position": self.sensor.position,
            "scene_bbox": np.array([[0, sx], [0, sy], [0, sz]], np.float64),
            "step_num": self.step_num,
            "depth_min": self.sensor.depth_min,
            "depth_max": self.sensor.depth_max,
            "depth_scale": self.sensor.depth_scale,
            "width": self.sensor.width,
            "height": self.sensor.height,
            "intrinsics": self.sensor.intrinsics,
            "planner": dict(self.planner),
        }

