"""Synthetic indoor world: an RGB-D raycaster over box geometry (copy of
activesplat_tpu/runtime/synthetic.py). `BoxWorld.render` runs the native C++
raycaster (runtime/native_raycast.py, built at first use) unless
ACTIVESPLAT_NATIVE=0 selects the numpy one below; a native build that fails
raises rather than falling back.

Hermetic stand-in for the Habitat simulator. Provides procedural rooms
(axis-aligned box room + box obstacles, checker-textured walls) with exact
ground-truth geometry, an RGB-D pinhole render (z-depth, like Habitat's depth
sensor), surface sampling and collision queries.

World frame: y is UP (height axis index 1), ground plane is x-z. Cameras are
OpenCV-convention c2w (x right, y down, z forward).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class BoxWorld:
    """Room interior [0,sx] x [0,sy] x [0,sz] (y up) with box obstacles."""

    size: Tuple[float, float, float] = (6.0, 3.0, 6.0)
    obstacles: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2, 3), np.float64)
    )  # (K, 2, 3): [min_corner, max_corner]

    # face order: -x +x -y +y -z +z
    _face_colors = np.array(
        [
            [0.85, 0.35, 0.30],  # -x wall: red-ish
            [0.30, 0.65, 0.85],  # +x wall: blue-ish
            [0.45, 0.40, 0.35],  # floor (-y... y up so -y is floor)
            [0.90, 0.90, 0.85],  # ceiling
            [0.35, 0.80, 0.45],  # -z wall: green-ish
            [0.85, 0.75, 0.30],  # +z wall: yellow-ish
        ]
    )
    _obstacle_color = np.array([0.55, 0.35, 0.70])

    @staticmethod
    def two_room(seed: int = 0) -> "BoxWorld":
        """A 10x6 m two-room scene with a doorway wall and clutter —
        the default test/benchmark scene."""
        rng = np.random.default_rng(seed)
        obstacles = [
            # dividing wall at z=3 with a 1.2 m doorway at x in [4.0, 5.2]
            [[0.0, 0.0, 2.9], [4.0, 3.0, 3.1]],
            [[5.2, 0.0, 2.9], [10.0, 3.0, 3.1]],
        ]
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
        return BoxWorld(
            size=(6.0, 3.0, 6.0),
            obstacles=np.array(obstacles) if obstacles else np.zeros((0, 2, 3)),
        )

    # ------------------------------------------------------------------ #
    # Rendering
    # ------------------------------------------------------------------ #

    def _checker(self, u: np.ndarray, v: np.ndarray, period: float = 0.5) -> np.ndarray:
        return 0.72 + 0.28 * (
            (np.floor(u / period) + np.floor(v / period)) % 2.0
        )

    def _shade_room_face(self, face: np.ndarray, pts: np.ndarray) -> np.ndarray:
        axis = face // 2  # 0, 1, 2
        u_axis = (axis + 1) % 3
        v_axis = (axis + 2) % 3
        u = np.take_along_axis(pts, u_axis[..., None], -1)[..., 0]
        v = np.take_along_axis(pts, v_axis[..., None], -1)[..., 0]
        tex = self._checker(u, v)
        return self._face_colors[face] * tex[..., None]

    def render(
        self,
        c2w: np.ndarray,
        intrinsics: np.ndarray,
        width: int,
        height: int,
        depth_max: float = 10.0,
        depth_min: float = 0.0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Raycast RGB-D. Returns (rgb (H,W,3) float in [0,1], depth (H,W)
        z-depth in meters, clamped to 0 outside [depth_min, depth_max] like
        the reference's DepthFilter (src/dataloader/image_transforms.py:34-46)).
        """
        if os.environ.get("ACTIVESPLAT_NATIVE", "1") != "0":
            from activesplat_tpu_torch.runtime import native_raycast

            return native_raycast.raycast(
                c2w, intrinsics, width, height, self.size, self.obstacles.reshape(-1, 6),
                depth_min, depth_max,
            )
        fx, fy = intrinsics[0, 0], intrinsics[1, 1]
        cx, cy = intrinsics[0, 2], intrinsics[1, 2]
        us, vs = np.meshgrid(np.arange(width), np.arange(height))
        dirs_cam = np.stack(
            [(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, np.float64)], -1
        )
        dirs = dirs_cam @ c2w[:3, :3].T  # (H, W, 3) world
        origin = c2w[:3, 3]

        with np.errstate(divide="ignore"):
            inv = np.where(
                np.abs(dirs) > 1e-12, 1.0 / dirs, np.inf * np.sign(dirs + 1e-30)
            )

        # Room interior: exit t of the room box.
        lo = np.zeros(3)
        hi = np.asarray(self.size, np.float64)
        t1 = (lo - origin) * inv
        t2 = (hi - origin) * inv
        t_exit_per_axis = np.maximum(t1, t2)
        t_room = t_exit_per_axis.min(-1)
        exit_axis = t_exit_per_axis.argmin(-1)
        # face id: axis*2 + (going positive ? 1 : 0)
        going_pos = np.take_along_axis(dirs, exit_axis[..., None], -1)[..., 0] > 0
        room_face = exit_axis * 2 + going_pos.astype(int)

        best_t = t_room.copy()
        hit_kind = np.zeros(t_room.shape, np.int32)  # 0 = room wall
        hit_obstacle_axis = np.zeros(t_room.shape, np.int64)

        for k in range(len(self.obstacles)):
            olo, ohi = self.obstacles[k]
            t1 = (olo - origin) * inv
            t2 = (ohi - origin) * inv
            t_near = np.minimum(t1, t2)
            t_far = np.maximum(t1, t2)
            t_enter = t_near.max(-1)
            enter_axis = t_near.argmax(-1)
            t_exit = t_far.min(-1)
            hit = (t_enter > 1e-6) & (t_enter < t_exit) & (t_enter < best_t)
            best_t = np.where(hit, t_enter, best_t)
            hit_kind = np.where(hit, k + 1, hit_kind)
            hit_obstacle_axis = np.where(hit, enter_axis, hit_obstacle_axis)

        pts = origin + best_t[..., None] * dirs
        rgb = self._shade_room_face(room_face, pts)
        if len(self.obstacles):
            obst_mask = hit_kind > 0
            u = np.where(hit_obstacle_axis == 0, pts[..., 1], pts[..., 0])
            v = np.where(hit_obstacle_axis == 2, pts[..., 1], pts[..., 2])
            tex = self._checker(u, v, period=0.25)
            # slight per-obstacle hue shift so obstacles are distinguishable
            hue = 0.85 + 0.15 * np.cos(hit_kind[..., None] * 2.1)
            obst_rgb = self._obstacle_color * hue * tex[..., None]
            rgb = np.where(obst_mask[..., None], obst_rgb, rgb)

        # distance shading for visual gradient (keeps SSIM meaningful)
        depth = best_t  # dirs_cam z == 1, so t is exactly z-depth
        shade = 1.0 / (1.0 + 0.04 * depth)
        rgb = np.clip(rgb * shade[..., None], 0.0, 1.0)

        depth = np.where(
            (depth >= depth_min) & (depth <= depth_max), depth, 0.0
        ).astype(np.float32)
        return rgb.astype(np.float32), depth

    # ------------------------------------------------------------------ #
    # Geometry queries
    # ------------------------------------------------------------------ #

    def is_free(self, pos_xz: np.ndarray, radius: float = 0.17) -> bool:
        """Is a vertical agent cylinder at (x, z) collision-free?
        (0.17 m is Habitat's default agent radius.)"""
        x, z = float(pos_xz[0]), float(pos_xz[1])
        sx, _, sz = self.size
        if not (radius <= x <= sx - radius and radius <= z <= sz - radius):
            return False
        for (olo, ohi) in self.obstacles:
            # circle vs rectangle in the xz plane; the obstacle blocks if its
            # height reaches above the agent's base meaningfully
            if ohi[1] < 0.2:
                continue
            dx = max(olo[0] - x, 0.0, x - ohi[0])
            dz = max(olo[2] - z, 0.0, z - ohi[2])
            if dx * dx + dz * dz < radius * radius:
                return False
        return True

    def surface_area_faces(self) -> List[Tuple[np.ndarray, np.ndarray, float]]:
        """All surfaces as (origin, spanning 2x3 basis, area) rectangles."""
        sx, sy, sz = self.size
        faces = []

        def rect(origin, e1, e2):
            area = np.linalg.norm(np.cross(e1, e2))
            faces.append((np.asarray(origin, float), np.stack([e1, e2]), area))

        # room inner faces
        rect([0, 0, 0], np.array([0.0, sy, 0]), np.array([0.0, 0, sz]))  # -x
        rect([sx, 0, 0], np.array([0.0, sy, 0]), np.array([0.0, 0, sz]))  # +x
        rect([0, 0, 0], np.array([sx, 0.0, 0]), np.array([0.0, 0, sz]))  # floor
        rect([0, sy, 0], np.array([sx, 0.0, 0]), np.array([0.0, 0, sz]))  # ceiling
        rect([0, 0, 0], np.array([sx, 0.0, 0]), np.array([0.0, sy, 0]))  # -z
        rect([0, 0, sz], np.array([sx, 0.0, 0]), np.array([0.0, sy, 0]))  # +z
        for (olo, ohi) in self.obstacles:
            d = ohi - olo
            ex = np.array([d[0], 0, 0])
            ey = np.array([0, d[1], 0])
            ez = np.array([0, 0, d[2]])
            rect(olo, ey, ez)
            rect([ohi[0], olo[1], olo[2]], ey, ez)
            rect(olo, ex, ez)
            rect([olo[0], ohi[1], olo[2]], ex, ez)  # top
            rect(olo, ex, ey)
            rect([olo[0], olo[1], ohi[2]], ex, ey)
        return faces

    def sample_surface(self, n: int, seed: int = 0) -> np.ndarray:
        """Uniform-by-area surface samples (GT mesh samples for the coverage
        judge, reference: scripts/judges/eval_actions.py:65)."""
        rng = np.random.default_rng(seed)
        faces = self.surface_area_faces()
        areas = np.array([f[2] for f in faces])
        probs = areas / areas.sum()
        counts = rng.multinomial(n, probs)
        pts = []
        for (origin, basis, _), c in zip(faces, counts):
            uv = rng.uniform(0, 1, (c, 2))
            pts.append(origin + uv @ basis)
        return np.concatenate(pts, 0)
