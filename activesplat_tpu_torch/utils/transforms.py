"""Quaternion math on tensors (differentiable) and the numpy pose and
intrinsics helpers the mapping slice and the map queries use (counterpart of
activesplat_tpu/utils/transforms.py).

Quaternions are stored (w, x, y, z), the reference's convention
(src/mapper/splatam/splatam.py:81 initializes rotations to [1, 0, 0, 0]).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize (..., 4) quaternions."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)
    return q / norm


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix.

    Normalizes internally (behavioral parity with the reference's
    build_rotation, src/mapper/splatam/utils/slam_external.py:25-42)."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def np_quat_to_rotmat(q_wxyz: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> (3, 3) rotation matrix, through scipy's rotation
    as the JAX package computes it."""
    q = np.asarray(q_wxyz, dtype=np.float64)
    return Rotation.from_quat(np.roll(q, -1, axis=-1)).as_matrix()


def np_rotmat_to_quat(matrix3: np.ndarray) -> np.ndarray:
    """(3, 3) rotation matrix -> wxyz quaternion, through scipy's rotation."""
    q_xyzw = Rotation.from_matrix(np.asarray(matrix3, dtype=np.float64)).as_quat()
    return np.roll(q_xyzw, 1, axis=-1)


def mat_to_q_pos(pose: np.ndarray):
    """(4, 4) pose -> (wxyz quaternion, translation)
    (semantics of src/utils/pose_utils.py:13-21)."""
    return np_rotmat_to_quat(pose[:3, :3]), pose[:3, 3].copy()


def rot_axis(view_c2w: np.ndarray, axis: str, angle_rad: float) -> np.ndarray:
    """Rotate a camera pose about one of its *own* axes
    (semantics of src/utils/pose_utils.py:23-43): right-multiplication of the
    c2w by an elementary rotation."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    if axis == "x":
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    elif axis == "y":
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    elif axis == "z":
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    else:
        raise ValueError(f"axis must be x, y or z, got {axis!r}")
    rot4 = np.eye(4)
    rot4[:3, :3] = rot
    return view_c2w @ rot4


def compute_intrinsics(width: int, height: int, hfov_rad: float, vfov_rad: float | None = None):
    """Pinhole intrinsics (fx, fy, cx, cy) from fields of view, with the
    Habitat cx = W/2 - 1 quirk kept for output parity (reference:
    src/dataloader/__init__.py:275-284)."""
    fx = 0.5 * width / np.tan(hfov_rad / 2.0)
    fy = fx if vfov_rad is None else 0.5 * height / np.tan(vfov_rad / 2.0)
    cx = width / 2 - 1
    cy = height / 2 - 1
    return fx, fy, cx, cy
