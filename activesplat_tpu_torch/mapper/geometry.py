"""Backprojection and Gaussian-initialization geometry (counterpart of
activesplat_tpu/mapper/geometry.py)."""

from __future__ import annotations

from typing import Tuple

import torch

from activesplat_tpu_torch.models.gaussians import GaussianParams


def backproject(depth: torch.Tensor, fx, fy, cx, cy, c2w: torch.Tensor) -> torch.Tensor:
    """Pixel grid + z-depth -> (H*W, 3) world points (splatam.py:25-51
    semantics: OpenCV pinhole, z-depth)."""
    h, w = depth.shape
    us = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    vs = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    x = (us - cx) / fx * depth
    y = (vs - cy) / fy * depth
    pts_cam = torch.stack([x, y, depth], dim=-1).reshape(-1, 3)
    return pts_cam @ c2w[:3, :3].T + c2w[:3, 3]


def projective_scale(depth_flat: torch.Tensor, fx, fy) -> torch.Tensor:
    """Initial per-Gaussian scale from projected pixel size ("projective"
    mean-sq-dist method, splatam.py:54-58): a point at depth z covers ~z/f
    meters per pixel."""
    return depth_flat / ((fx + fy) / 2.0)


def gaussians_from_rgbd(
    rgb: torch.Tensor,  # (H, W, 3)
    depth: torch.Tensor,  # (H, W)
    fx,
    fy,
    cx,
    cy,
    c2w: torch.Tensor,
    isotropic: bool = False,
) -> Tuple[GaussianParams, torch.Tensor]:
    """Candidate Gaussians from every valid-depth pixel (initialize_params
    semantics, splatam.py:78-115: identity rotations, logit-0 opacities,
    log-scale = log(projected pixel size)). Returns (params, valid_mask)."""
    pts = backproject(depth, fx, fy, cx, cy, c2w)
    n = pts.shape[0]
    depth_flat = depth.reshape(-1)
    valid = depth_flat > 0
    log_scale = torch.log(torch.clamp(projective_scale(depth_flat, fx, fy), min=1e-10))
    quats = torch.zeros((n, 4), dtype=pts.dtype, device=pts.device)
    quats[:, 0] = 1.0
    params = GaussianParams(
        means3d=pts,
        rgb=rgb.reshape(-1, 3),
        quats=quats,
        logit_opacities=torch.zeros((n,), dtype=pts.dtype, device=pts.device),
        log_scales=log_scale[:, None].expand(n, 1 if isotropic else 3).contiguous(),
    )
    return params, valid
