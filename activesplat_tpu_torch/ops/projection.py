"""EWA projection of 3D Gaussians to screen-space 2D Gaussians
(counterpart of activesplat_tpu/ops/projection.py).

World-space means/covariances -> per-Gaussian 2D mean, inverse 2D covariance
(conic), screen radius, camera depth and a frustum validity mask. Written as
elementwise float32 math over (C,)-vectors, differentiable through autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from activesplat_tpu_torch.utils.transforms import quat_to_rotmat

# Low-pass dilation added to 2D covariances, as in EWA splatting — ensures
# each splat covers at least ~1 pixel (same constant as Inria's rasterizer).
COV2D_DILATION = 0.3


class Projected(NamedTuple):
    mean2d: torch.Tensor  # (C, 2) pixel coordinates
    conic: torch.Tensor  # (C, 3) upper-triangular inverse 2D covariance (a, b, c)
    radius: torch.Tensor  # (C,) 3-sigma screen radius in pixels (0 if culled)
    depth: torch.Tensor  # (C,) camera-frame z
    valid: torch.Tensor  # (C,) bool — in front of camera, on screen, active


def project_gaussians(
    means3d: torch.Tensor,
    quats: torch.Tensor,
    log_scales: torch.Tensor,
    active: torch.Tensor,
    w2c: torch.Tensor,
    fx: torch.Tensor,
    fy: torch.Tensor,
    cx: torch.Tensor,
    cy: torch.Tensor,
    width: int,
    height: int,
    near: float = 0.01,
    far: float = 100.0,
    scale_modifier: float = 1.0,
) -> Projected:
    """Project Gaussians into a pinhole camera (OpenCV convention).

    log_scales may be (C, 1) (isotropic) or (C, 3)."""
    r = w2c[:3, :3]
    t_w2c = w2c[:3, 3]
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    x = r[0, 0] * mx + r[0, 1] * my + r[0, 2] * mz + t_w2c[0]
    y = r[1, 0] * mx + r[1, 1] * my + r[1, 2] * mz + t_w2c[1]
    z = r[2, 0] * mx + r[2, 1] * my + r[2, 2] * mz + t_w2c[2]

    in_front = z > near
    zs = torch.where(in_front, z, torch.ones_like(z))  # safe z for divisions
    inv_z = 1.0 / zs

    mean_x = fx * x * inv_z + cx
    mean_y = fy * y * inv_z + cy
    mean2d = torch.stack([mean_x, mean_y], dim=-1)

    # 3D covariance M M^T with M = R_g diag(S), then the camera-frame
    # congruence V = R M (R M)^T, as one elementwise product chain
    scales = torch.exp(log_scales) * scale_modifier  # (C, 1|3)
    scales = scales.expand(means3d.shape[0], 3)
    m = quat_to_rotmat(quats) * scales[:, None, :]  # (C, 3, 3)
    a = [
        [
            r[i, 0] * m[:, 0, j] + r[i, 1] * m[:, 1, j] + r[i, 2] * m[:, 2, j]
            for j in range(3)
        ]
        for i in range(3)
    ]

    def dot_rows(i, j):
        return a[i][0] * a[j][0] + a[i][1] * a[j][1] + a[i][2] * a[j][2]

    c00, c01, c02 = dot_rows(0, 0), dot_rows(0, 1), dot_rows(0, 2)
    c11, c12, c22 = dot_rows(1, 1), dot_rows(1, 2), dot_rows(2, 2)

    # EWA Jacobian with the standard frustum clamp of the tangent coordinates
    tan_fov_x = 0.5 * width / fx
    tan_fov_y = 0.5 * height / fy
    lim_x = 1.3 * tan_fov_x
    lim_y = 1.3 * tan_fov_y
    tx = torch.clamp(x * inv_z, -lim_x, lim_x) * zs
    ty = torch.clamp(y * inv_z, -lim_y, lim_y) * zs

    j00 = fx * inv_z
    j02 = -fx * tx * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z * inv_z

    # cov2d = J cov_cam J^T, J = [[j00, 0, j02], [0, j11, j12]]
    ca = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22) + COV2D_DILATION
    cb = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    cc = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22) + COV2D_DILATION

    det = ca * cc - cb * cb
    det_ok = det > 1e-12
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conic = torch.stack([cc * inv_det, -cb * inv_det, ca * inv_det], dim=-1)

    # 3-sigma screen radius from the larger covariance eigenvalue
    mid = 0.5 * (ca + cc)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))

    on_screen = (
        (mean_x + radius > 0)
        & (mean_x - radius < width)
        & (mean_y + radius > 0)
        & (mean_y - radius < height)
    )
    valid = active & in_front & (z < far) & det_ok & on_screen
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return Projected(mean2d=mean2d, conic=conic, radius=radius, depth=z, valid=valid)


def adaptive_cull_radius(
    radius: torch.Tensor, valid: torch.Tensor, opacity: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Opacity-adaptive tile-cull radius (AdR-Gaussian, arXiv 2409.08669),
    lossless under the blend's alpha >= 1/255 cutoff: beyond
    r_eff = sqrt(2 ln(255 opacity)) * radius / 3 no pixel passes the cutoff.

    Returns (radius_eff, valid_eff) for BINNING ONLY; the inputs are
    detached because the bin consumes indices."""
    radius, opacity = radius.detach(), opacity.detach()
    ln = torch.log(torch.clamp(255.0 * opacity, min=1e-20))
    r_eff = torch.sqrt(torch.clamp(2.0 * ln, min=0.0)) * (radius / 3.0)
    visible = opacity > (1.0 / 255.0)
    return (
        torch.where(visible, torch.minimum(radius, r_eff), torch.zeros_like(radius)),
        valid & visible,
    )
