"""The mapping benchmark's map and frames, built with the port (counterpart of
build_map in the JAX package's bench.py).

A BoxWorld two-room scene; n Gaussians sampled uniformly by area on its
surfaces, with random colours, opacity sigmoid(2) and log scales uniform in
[log 0.01, log 0.05], in a buffer of the next power-of-two capacity; a
square pinhole camera with a 90 degree field of view at (5, 1.25, 1.5)
looking down the z axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from activesplat_tpu_torch.device import DeviceLike, resolve_device
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.models.gaussians import Camera, GaussianBuffer, make_camera
from activesplat_tpu_torch.runtime.synthetic import BoxWorld


class BenchScene(NamedTuple):
    world: BoxWorld
    buf: GaussianBuffer
    cam: Camera
    intrinsics: np.ndarray  # (3, 3) float64
    c2w: np.ndarray  # (4, 4) the camera's pose
    cfg: MapperConfig

    def frame(self, c2w: np.ndarray):
        """The world's RGB-D frame from c2w, as tensors on the camera's
        device: (rgb (H, W, 3), depth (H, W))."""
        rgb, depth = self.world.render(c2w, self.intrinsics, self.cam.width, self.cam.height)
        dev = self.cam.device
        return torch.from_numpy(rgb).to(dev), torch.from_numpy(depth).to(dev)


def build_map(
    n_gaussians: int, res: int, seed: int = 0, k_per_tile: int = 256, device: DeviceLike = None
) -> BenchScene:
    dev = resolve_device(device)
    world = BoxWorld.two_room(seed=seed)
    pts = world.sample_surface(n_gaussians, seed=seed).astype(np.float32)
    rng = np.random.default_rng(seed)
    capacity = 1 << int(np.ceil(np.log2(n_gaussians)))
    buf = GaussianBuffer.empty(capacity, device=dev)
    p, n = buf.params, n_gaussians
    p.means3d[:n] = torch.from_numpy(pts).to(dev)
    p.rgb[:n] = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)).to(dev)
    p.logit_opacities[:n] = 2.0
    p.log_scales[:n] = torch.from_numpy(
        rng.uniform(np.log(0.01), np.log(0.05), (n, 3)).astype(np.float32)
    ).to(dev)
    buf.active[:n] = True

    fx = 0.5 * res / np.tan(np.deg2rad(45.0))
    intr = np.array([[fx, 0, res / 2 - 1], [0, fx, res / 2 - 1], [0, 0, 1]])
    c2w = np.eye(4)
    c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
    c2w[:3, 3] = [5.0, 1.25, 1.5]
    cam = make_camera(res, res, intr, np.linalg.inv(c2w), device=dev)
    cfg = MapperConfig(chunk=512, k_per_tile=k_per_tile, exact_training="off")
    return BenchScene(world, buf, cam, intr, c2w, cfg)
