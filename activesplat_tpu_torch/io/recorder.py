"""Runtime-data recorder (counterpart of activesplat_tpu/io/recorder.py; the
reference's save_runtime_data:=1 artifact dumps, visualizer.py:840-853 +
planner_node.py:941-945,1460-1489): per-step top-down maps, per-node opacity
panoramas, current view renders.

The PNGs go through the port's codec (io/png.py) and colour tables
(io/colormaps.py), so their pixels are the JAX package's OpenCV ones. One
difference: the diagnostic panel carries no text labels (the JAX package
draws them with cv2.putText, which has no numpy counterpart here); every
other pixel of it is the same.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from activesplat_tpu_torch.io.colormaps import JET_RGB, normalized_u8
from activesplat_tpu_torch.io.png import write_png


def _colorize(gray: np.ndarray) -> np.ndarray:
    """JET of gray scaled by its largest value, (H, W, 3) uint8 RGB."""
    return JET_RGB[normalized_u8(gray)]


def _rgb8(rgb: np.ndarray) -> np.ndarray:
    if rgb.dtype != np.uint8:
        rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    return rgb


def _depth_jet(depth: np.ndarray, vmax: float = 6.0) -> np.ndarray:
    return JET_RGB[normalized_u8(depth, vmax)]


class RuntimeRecorder:
    def __init__(self, results_dir: str):
        self.topdown_dir = os.path.join(results_dir, "topdown_map")
        self.opacity_dir = os.path.join(results_dir, "opacity")
        self.view_dir = os.path.join(results_dir, "current_vis_data")
        for d in (self.topdown_dir, self.opacity_dir, self.view_dir):
            os.makedirs(d, exist_ok=True)
        self.topdown_count = 0

    def save_topdown(self, free_binary: np.ndarray, unobserved_binary: np.ndarray):
        step = self.topdown_count
        self.topdown_count += 1
        write_png(os.path.join(self.topdown_dir, f"free_{step:05d}.png"),
                  free_binary.astype(np.uint8) * 255)
        write_png(os.path.join(self.topdown_dir, f"unobserved_{step:05d}.png"),
                  unobserved_binary.astype(np.uint8) * 255)

    def save_panorama(self, step: int, node_id, invisibility: np.ndarray):
        d = os.path.join(self.opacity_dir, f"step_{step}")
        os.makedirs(d, exist_ok=True)
        write_png(os.path.join(d, f"{node_id}.png"), _colorize(invisibility))

    def save_rgbd_silhouette(
        self,
        step: int,
        gt_rgb: np.ndarray,  # (H, W, 3) float [0,1] or uint8
        gt_depth: np.ndarray,  # (H, W) meters
        rendered_rgb: np.ndarray,
        rendered_depth: np.ndarray,
        silhouette: np.ndarray,  # (H, W) alpha [0,1]
        psnr: float,
        depth_l1: float,
    ) -> None:
        """rgbd_sil_<step>.png, a 2x3 diagnostic panel — GT RGB | GT depth |
        silhouette over rendered RGB | rendered depth | |depth diff| — the
        matplotlib-free equivalent of the reference's plot_rgbd_silhouette
        (eval_helpers.py:110-151; same cell layout, jet depth maps). The JAX
        package labels its cells with the PSNR and depth L1; this panel
        carries no text, so they go unused here."""
        del psnr, depth_l1
        sil_u8 = (np.clip(silhouette, 0, 1) * 255).astype(np.uint8)
        diff = np.abs(
            np.asarray(gt_depth, np.float64) - np.asarray(rendered_depth, np.float64)
        ) * (np.asarray(gt_depth) > 0)
        top = np.hstack([_rgb8(gt_rgb), _depth_jet(gt_depth), np.repeat(sil_u8[..., None], 3, -1)])
        bottom = np.hstack([_rgb8(rendered_rgb), _depth_jet(rendered_depth), _depth_jet(diff)])
        write_png(os.path.join(self.view_dir, f"rgbd_sil_{step:05d}.png"),
                  np.vstack([top, bottom]))

    def save_view(self, step: int, rgb: np.ndarray, depth: Optional[np.ndarray]):
        write_png(os.path.join(self.view_dir, f"rgb_{step:05d}.png"), _rgb8(rgb))
        if depth is not None:
            write_png(os.path.join(self.view_dir, f"depth_{step:05d}.png"), _colorize(depth))
