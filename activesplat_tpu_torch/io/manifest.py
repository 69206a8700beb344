"""transforms.json manifest and rgb/depth frame dumps (counterpart of
activesplat_tpu/io/manifest.py, on the port's own PNG codec).

File layout matches the reference's dataset dump (splatam/__init__.py:281-330,
visualizer.py:1177-1180): gaussians_data/{rgb,depth}/NNNN.png and a
transforms.json with global intrinsics, integer_depth_scale =
depth_scale/65535, and per-frame entries whose "transform_matrix" is the
*transposed* OpenCV w2c (instant-ngp storage convention kept for output
parity). RGB frames are 8-bit RGB PNGs, depth frames 16-bit grey PNGs in
millimetres; they decode to the pixels the JAX package's OpenCV writer
stores.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from activesplat_tpu_torch.io.png import read_png, write_png


class DatasetDumper:
    def __init__(
        self,
        out_dir: str,
        width: int,
        height: int,
        fx: float,
        fy: float,
        cx: float,
        cy: float,
        depth_scale: float = 1.0,
        save_images: bool = True,
    ):
        self.out_dir = out_dir
        self.save_images = save_images
        self.rgb_dir = os.path.join(out_dir, "rgb")
        self.depth_dir = os.path.join(out_dir, "depth")
        os.makedirs(self.rgb_dir, exist_ok=True)
        os.makedirs(self.depth_dir, exist_ok=True)
        self.manifest = {
            "fl_x": float(fx),
            "fl_y": float(fy),
            "cx": float(cx),
            "cy": float(cy),
            "w": int(width),
            "h": int(height),
            "integer_depth_scale": float(depth_scale) / 65535.0,
            "frames": [],
        }

    def add_frame(
        self,
        frame_id: int,
        rgb: np.ndarray,  # (H, W, 3) float [0,1] or uint8
        depth: Optional[np.ndarray],  # (H, W) meters
        w2c: np.ndarray,
    ) -> None:
        name = f"{frame_id:04d}.png"
        if self.save_images:
            if rgb.dtype != np.uint8:
                rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
            write_png(os.path.join(self.rgb_dir, name), rgb)
            if depth is not None:
                # 16-bit millimeters (splatam/__init__.py:306)
                write_png(os.path.join(self.depth_dir, name),
                          (np.asarray(depth) * 1000.0).astype(np.uint16))
        entry = {
            "transform_matrix": np.asarray(w2c, np.float64).T.tolist(),
            "file_path": f"rgb/{name}",
            "fl_x": self.manifest["fl_x"],
            "fl_y": self.manifest["fl_y"],
            "cx": self.manifest["cx"],
            "cy": self.manifest["cy"],
            "w": self.manifest["w"],
            "h": self.manifest["h"],
        }
        if depth is not None:
            entry["depth_path"] = f"depth/{name}"
        self.manifest["frames"].append(entry)

    def write(self) -> str:
        path = os.path.join(self.out_dir, "transforms.json")
        with open(path, "w") as fh:
            json.dump(self.manifest, fh, indent=4)
        return path


def load_manifest(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "transforms.json")) as fh:
        return json.load(fh)


def manifest_intrinsics(manifest: dict) -> np.ndarray:
    """The dump's (3, 3) pinhole intrinsics."""
    return np.array([
        [manifest["fl_x"], 0, manifest["cx"]],
        [0, manifest["fl_y"], manifest["cy"]],
        [0, 0, 1],
    ])


def load_frame(out_dir: str, entry: dict):
    """Read one dumped frame back as (rgb float (H,W,3), depth meters (H,W),
    w2c (4,4))."""
    rgb = read_png(os.path.join(out_dir, entry["file_path"]))[..., :3].astype(np.float32) / 255.0
    depth = None
    if "depth_path" in entry:
        depth = read_png(os.path.join(out_dir, entry["depth_path"])).astype(np.float32) / 1000.0
    w2c = np.asarray(entry["transform_matrix"], np.float64).T
    return rgb, depth, w2c
