"""The benchmark's simulator: a habitat-sim-shaped agent over a BoxWorld
room, rendered by a native raycaster. It is the traffic generator of the
`explore` mix and lives here, frozen, so that no change to the program can
make the environment cheaper.

Frozen copies (SOURCES.md names the commit):
- `BoxWorld` (the room, its obstacles, `is_free`) from
  activesplat_tpu_torch/runtime/synthetic.py;
- `BoxWorldSim` (the habitat-sim API slice the Habitat adapter steps) and
  the start rule `default_start` from
  activesplat_tpu_torch/runtime/mock_habitat.py;
- `raycast.cpp` from activesplat_tpu_torch/csrc/raycast.cpp, with the g++
  build of activesplat_tpu_torch/runtime/native_raycast.py;
- `compute_intrinsics`, `rot_axis`, `rotmat_to_quat` from
  activesplat_tpu_torch/utils/transforms.py.

Two things differ from the mock: the start pose is the caller's (the
harness passes the scene's start spot with yaw 0), and `step` calls an
optional `on_step` hook first (the harness's clock). Nothing here imports the program.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import types
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "raycast.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

# Habitat's pointnav action ids (the adapter's SimAction)
MOVE_FORWARD, TURN_LEFT, TURN_RIGHT, LOOK_UP, LOOK_DOWN = 1, 2, 3, 4, 5

_lib: Optional[ctypes.CDLL] = None


def _library_path(cxx: str) -> Path:
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True)
    digest = hashlib.sha256()
    digest.update(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(target.stdout.encode())
    return BUILD_DIR / f"libraycast-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """The raycaster library, compiled with g++ (or $CXX) if it is missing.
    Keyed by the source, the flags and what -march=native means here, so a
    library built on another machine is never loaded."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("the benchmark's raycaster needs g++ (or $CXX)")
    path = _library_path(cxx)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{path.name}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        d, i = ctypes.c_double, ctypes.c_int
        lib.raycast_rgbd.argtypes = [f64, d, d, d, d, i, i, f64, f64, i, d, d, f32, f32]
        lib.raycast_rgbd.restype = None
        _lib = lib
    return _lib


def compute_intrinsics(width: int, height: int, hfov_rad: float):
    """(fx, fy, cx, cy) with Habitat's cx = W/2 - 1 quirk."""
    fx = 0.5 * width / np.tan(hfov_rad / 2.0)
    return fx, fx, width / 2 - 1, height / 2 - 1


def rot_axis(c2w: np.ndarray, axis: str, angle_rad: float) -> np.ndarray:
    """Rotate a pose about one of its own axes (right-multiplication)."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    rot = {"x": [[1, 0, 0], [0, c, -s], [0, s, c]],
           "y": [[c, 0, s], [0, 1, 0], [-s, 0, c]]}[axis]
    rot4 = np.eye(4)
    rot4[:3, :3] = rot
    return c2w @ rot4


def rotmat_to_quat(m: np.ndarray) -> np.ndarray:
    """(3, 3) rotation -> unit wxyz quaternion with w >= 0 (scipy's choice)."""
    from scipy.spatial.transform import Rotation

    q = np.roll(Rotation.from_matrix(np.asarray(m, np.float64)).as_quat(), 1)
    return q


@dataclasses.dataclass
class BoxWorld:
    """Room interior [0,sx] x [0,sy] x [0,sz] (y up) with box obstacles."""

    size: Tuple[float, float, float] = (6.0, 3.0, 6.0)
    obstacles: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2, 3), np.float64))

    @staticmethod
    def two_room(seed: int = 0) -> "BoxWorld":
        rng = np.random.default_rng(seed)
        obstacles = [[[0.0, 0.0, 2.9], [4.0, 3.0, 3.1]], [[5.2, 0.0, 2.9], [10.0, 3.0, 3.1]]]
        for _ in range(4):
            cx = rng.uniform(0.8, 9.2)
            cz = rng.choice([rng.uniform(0.8, 2.2), rng.uniform(3.8, 5.2)])
            w, d = rng.uniform(0.3, 0.7, 2)
            h = rng.uniform(0.4, 1.4)
            obstacles.append([[cx - w, 0.0, cz - d], [cx + w, h, cz + d]])
        return BoxWorld(size=(10.0, 3.0, 6.0), obstacles=np.array(obstacles))

    @staticmethod
    def single_room(seed: int = 0) -> "BoxWorld":
        rng = np.random.default_rng(seed)
        obstacles = []
        for _ in range(2):
            cx, cz = rng.uniform(1.2, 4.8, 2)
            w, d = rng.uniform(0.25, 0.5, 2)
            h = rng.uniform(0.4, 1.2)
            obstacles.append([[cx - w, 0.0, cz - d], [cx + w, h, cz + d]])
        return BoxWorld(size=(6.0, 3.0, 6.0), obstacles=np.array(obstacles))

    def render(self, c2w, intrinsics, width, height, depth_min, depth_max):
        """(rgb (H, W, 3) float32 in [0, 1], z-depth (H, W) float32)."""
        rgb = np.empty((height, width, 3), np.float32)
        depth = np.empty((height, width), np.float32)
        obstacles = np.ascontiguousarray(self.obstacles.reshape(-1, 6), np.float64)
        _get_lib().raycast_rgbd(
            np.ascontiguousarray(c2w, np.float64).reshape(16),
            float(intrinsics[0, 0]), float(intrinsics[1, 1]),
            float(intrinsics[0, 2]), float(intrinsics[1, 2]), int(width), int(height),
            np.ascontiguousarray(self.size, np.float64), obstacles, len(obstacles),
            float(depth_min), float(depth_max), rgb, depth,
        )
        return rgb, depth

    def is_free(self, pos_xz, radius: float = 0.17) -> bool:
        """Is a vertical agent cylinder at (x, z) collision-free?"""
        x, z = float(pos_xz[0]), float(pos_xz[1])
        sx, _, sz = self.size
        if not (radius <= x <= sx - radius and radius <= z <= sz - radius):
            return False
        for olo, ohi in self.obstacles:
            if ohi[1] < 0.2:
                continue
            dx = max(olo[0] - x, 0.0, x - ohi[0])
            dz = max(olo[2] - z, 0.0, z - ohi[2])
            if dx * dx + dz * dz < radius * radius:
                return False
        return True


def default_start(world: BoxWorld, radius: float) -> np.ndarray:
    """The mock's start rule: the first free spot along z = sz/4 right of the
    room's centre line."""
    sx, _, sz = world.size
    for dx in np.linspace(0, min(sx, sz) / 2 - 0.5, 8):
        candidate = np.array([sx / 2 + dx, 0.0, sz / 4])
        if world.is_free(candidate[[0, 2]], radius):
            return candidate
    return np.array([sx / 2, 0.0, sz / 2])


class _Quat:
    def __init__(self, wxyz) -> None:
        self.w, self.x, self.y, self.z = (float(v) for v in wxyz)


class BoxWorldSim:
    """Habitat-sim-shaped discrete agent over BoxWorld geometry: `step`,
    `get_sensor_observations`, `get_agent_state` (with `sensor_states`),
    `seed`, `reset`, `close`, `pathfinder.get_bounds()`."""

    def __init__(self, spec, world: BoxWorld, start_position, start_yaw_deg: float = 0.0,
                 on_step: Optional[Callable[[int], None]] = None) -> None:
        self.spec = spec
        self.world = world
        fx, fy, cx, cy = compute_intrinsics(spec.width, spec.height, np.deg2rad(spec.hfov_deg))
        self._intrinsics = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        self._start = np.asarray(start_position, np.float64)
        self._start_yaw = float(start_yaw_deg)
        self.on_step = on_step
        self.reset()

    def seed(self, value: int) -> None:
        pass

    def reset(self) -> None:
        self.position = self._start.copy()
        self.yaw_deg = self._start_yaw
        self.pitch_deg = 0.0

    def close(self) -> None:
        pass

    @property
    def pathfinder(self):
        sx, sy, sz = self.world.size
        return types.SimpleNamespace(get_bounds=lambda: (np.zeros(3), np.array([sx, sy, sz])))

    def step(self, action: int) -> None:
        action = int(action)
        if self.on_step is not None:
            self.on_step(action)
        if action == TURN_LEFT:
            self.yaw_deg = (self.yaw_deg + self.spec.turn_angle) % 360
        elif action == TURN_RIGHT:
            self.yaw_deg = (self.yaw_deg - self.spec.turn_angle) % 360
        elif action == LOOK_UP:
            self.pitch_deg = min(self.pitch_deg + self.spec.tilt_angle, 30.0)
        elif action == LOOK_DOWN:
            self.pitch_deg = max(self.pitch_deg - self.spec.tilt_angle, -30.0)
        elif action == MOVE_FORWARD:
            yaw = np.deg2rad(self.yaw_deg)
            target = self.position + np.array([-np.sin(yaw), 0.0, -np.cos(yaw)]) \
                * self.spec.forward_step_size
            if self.world.is_free(target[[0, 2]], self.spec.agent_radius):
                self.position = target

    def _camera_c2w(self) -> np.ndarray:
        c2w = np.eye(4)
        c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
        c2w[:3, 3] = self.position + np.asarray(self.spec.position)
        c2w = rot_axis(c2w, "y", np.deg2rad(-self.yaw_deg))
        return rot_axis(c2w, "x", np.deg2rad(self.pitch_deg))

    def get_sensor_observations(self) -> Dict[str, np.ndarray]:
        rgb, depth = self.world.render(self._camera_c2w(), self._intrinsics, self.spec.width,
                                       self.spec.height, self.spec.depth_min,
                                       self.spec.depth_max)
        rgba = np.concatenate([(rgb * 255).astype(np.uint8),
                               np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)
        return {"rgb": rgba, "depth": depth[..., None]}

    def get_agent_state(self):
        c2w = self._camera_c2w()
        sensor = types.SimpleNamespace(position=c2w[:3, 3].copy(),
                                       rotation=_Quat(rotmat_to_quat(c2w[:3, :3])))
        agent_c2w = np.eye(4)
        agent_c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
        agent_c2w = rot_axis(agent_c2w, "y", np.deg2rad(-self.yaw_deg))
        return types.SimpleNamespace(position=self.position.copy(),
                                     rotation=_Quat(rotmat_to_quat(agent_c2w[:3, :3])),
                                     sensor_states={"rgb": sensor, "depth": sensor})
