"""params.npz reader and writer with the reference's schema (counterpart of
activesplat_tpu/io/params_io.py; the files carry the same keys, shapes and
dtypes, so either package reads the other's).

Schema (save_params, src/mapper/splatam/utils/common_utils.py:37-44,
assembled at splatam/__init__.py:554-573):

  means3D (N,3)  rgb_colors (N,3)  unnorm_rotations (N,4)
  logit_opacities (N,1)  log_scales (N,1|3)  timestep (N,)
  cam_unnorm_rots (1,4,T)  cam_trans (1,3,T)
  intrinsics (3,3)  w2c (4,4)  org_width ()  org_height ()
  gt_w2c_all_frames (T,4,4)  keyframe_time_indices (K,)

The fixed-capacity buffer is compacted to its active Gaussians, in slot
order, on export.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from activesplat_tpu_torch.device import DeviceLike
from activesplat_tpu_torch.models.gaussians import GaussianBuffer


def params_dict_from_buffer(buf: GaussianBuffer) -> Dict[str, np.ndarray]:
    idx = torch.nonzero(buf.active).squeeze(1)
    p = buf.params

    def take(x):
        return x.detach()[idx].cpu().numpy()

    return {
        "means3D": take(p.means3d),
        "rgb_colors": take(p.rgb),
        "unnorm_rotations": take(p.quats),
        "logit_opacities": take(p.logit_opacities)[:, None],
        "log_scales": take(p.log_scales),
        "timestep": take(buf.timestep),
    }


def save_params(
    output_dir: str,
    buf: GaussianBuffer,
    cam_unnorm_rots: np.ndarray,  # (1, 4, T)
    cam_trans: np.ndarray,  # (1, 3, T)
    intrinsics: np.ndarray,
    first_frame_w2c: np.ndarray,
    org_width: int,
    org_height: int,
    gt_w2c_all_frames: np.ndarray,
    keyframe_time_indices: np.ndarray,
) -> str:
    params = params_dict_from_buffer(buf)
    params.update(
        {
            "cam_unnorm_rots": np.asarray(cam_unnorm_rots, np.float32),
            "cam_trans": np.asarray(cam_trans, np.float32),
            "intrinsics": np.asarray(intrinsics, np.float32),
            "w2c": np.asarray(first_frame_w2c, np.float32),
            "org_width": np.asarray(org_width),
            "org_height": np.asarray(org_height),
            "gt_w2c_all_frames": np.asarray(gt_w2c_all_frames, np.float32),
            "keyframe_time_indices": np.asarray(keyframe_time_indices),
        }
    )
    params = {k: (v.astype(np.float32) if v.dtype.kind == "f" else v) for k, v in params.items()}
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "params.npz")
    np.savez(path, **params)
    return path


def save_params_ckpt(output_dir: str, buf: GaussianBuffer, time_idx: int, **extras) -> str:
    """Mid-run checkpoint: params{t}.npz (common_utils.py:61-68)."""
    params = params_dict_from_buffer(buf)
    for k, v in extras.items():
        params[k] = np.asarray(v)
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"params{time_idx}.npz")
    np.savez(path, **params)
    return path


def load_params(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def buffer_from_params(
    params: Dict[str, np.ndarray], capacity: Optional[int] = None, device: DeviceLike = None
) -> GaussianBuffer:
    """A GaussianBuffer from a params dict (resume, offline eval): the
    Gaussians in slots [0, N), active; the capacity by default the next
    power of two, at least 1024."""
    n = params["means3D"].shape[0]
    capacity = capacity or max(1 << (n - 1).bit_length(), 1024)
    buf = GaussianBuffer.empty(
        capacity, isotropic=params["log_scales"].shape[-1] == 1, device=device
    )
    dev = buf.device

    def fill(dst, src):
        dst[:n] = torch.as_tensor(np.asarray(src, np.float32), device=dev).reshape(dst[:n].shape)

    p = buf.params
    fill(p.means3d, params["means3D"])
    fill(p.rgb, params["rgb_colors"])
    fill(p.quats, params["unnorm_rotations"])
    fill(p.logit_opacities, params["logit_opacities"])
    fill(p.log_scales, params["log_scales"])
    fill(buf.timestep, params.get("timestep", np.zeros(n)))
    buf.active[:n] = True
    return buf
