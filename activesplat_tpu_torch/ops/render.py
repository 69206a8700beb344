"""Public render API: one fused multi-channel Gaussian render (counterpart of
activesplat_tpu/ops/render.py).

A single pass composites the channels [r, g, b, z, z^2]; the silhouette is
the composited alpha, so one render yields everything the mapping loss reads:

    rgb        — color image (background-blended)
    depth      — alpha-composited camera-frame z of Gaussian centers
    depth_sq   — alpha-composited z^2
    alpha      — total opacity / silhouette
    radii      — per-Gaussian screen radius (densification bookkeeping)

Paths: the dense rasterizer (k_per_tile=0); the k-capped tiled render
(k_per_tile > 0); the exact renders over CSR runs: exact=True forward-only,
grad_exact=True differentiable, grad_exact="hybrid" capped plus CSR where
the cap is harmful. There is no backend argument: the tiled paths always
blend in the port's CUDA kernels (their twins for CPU tensors).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from activesplat_tpu_torch.models.gaussians import Camera, GaussianBuffer
from activesplat_tpu_torch.ops.projection import (
    Projected,
    adaptive_cull_radius,
    project_gaussians,
)
from activesplat_tpu_torch.ops.raster_tiled import (
    rasterize_tiled,
    rasterize_tiled_exact,
    rasterize_tiled_hybrid,
)
from activesplat_tpu_torch.ops.raster_xla import depth_sort, rasterize_sorted
from activesplat_tpu_torch.utils.tracing import stage


class RenderOutput(NamedTuple):
    rgb: torch.Tensor  # (H, W, 3)
    depth: torch.Tensor  # (H, W)
    depth_sq: torch.Tensor  # (H, W)
    alpha: torch.Tensor  # (H, W)
    radii: torch.Tensor  # (C,) in input (unsorted) order
    mean2d: torch.Tensor  # (C, 2) in input order
    valid: torch.Tensor  # (C,) bool in input order
    dropped: torch.Tensor  # () int32 — harmful memberships cut by the k cap


def render_projected(
    proj: Projected,
    rgb: torch.Tensor,
    opacities: torch.Tensor,
    cam: Camera,
    bg: Optional[torch.Tensor] = None,
    chunk: int = 128,
    k_per_tile: int = 0,
    exact: bool = False,
    grad_exact=False,
    xla_blend: bool = False,
) -> RenderOutput:
    """Rasterize already-projected Gaussians (see `render`).

    k_per_tile > 0 selects the tile-binned rasterizer: each 16x16 tile
    composites only its nearest k overlapping Gaussians; 0 selects the dense
    chunked rasterizer.

    exact=True composites every membership (the CSR walk, forward-only); if
    the memberships pass the entry budget it takes the multi-pass walk over
    k-windows instead, exact as well. grad_exact=True composites exactly and
    differentiably (the CSR blend and its analytic backward) and falls back
    to the k-capped render past the budget. grad_exact="hybrid" gives the
    same exact training at capped + O(harmful memberships) cost, with the
    same fallback. `dropped` reports the capped path's harmful truncations
    where a capped blend ran (as telemetry for "hybrid") and 0 where every
    membership was composited. Each fallback costs a host sync in place of
    the reference's lax.cond.

    xla_blend=True blends the capped tiles in plain autograd PyTorch with no
    early exit (raster_tiled.blend_tiles_xla): the reference's default
    "xla" backend, which its mean2d gradient tap renders with."""
    dev = proj.depth.device
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=dev)

    depth_ch = proj.depth
    channels = torch.cat(
        [rgb, depth_ch[:, None], (depth_ch * depth_ch)[:, None]], dim=-1
    )  # (C, 5)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)

    if k_per_tile <= 0:
        _, s_valid, s_mean2d, s_conic, s_opacity, s_channels = depth_sort(
            proj.depth, proj.valid, proj.mean2d, proj.conic, opacities, channels
        )
        accum, log_t = rasterize_sorted(
            s_mean2d, s_conic, s_opacity, s_channels, s_valid,
            width=cam.width, height=cam.height, chunk=chunk,
        )
    else:
        # binning-only opacity-adaptive cull (lossless); RenderOutput keeps
        # the 3-sigma radius and valid mask for densification bookkeeping
        bin_radius, bin_valid = adaptive_cull_radius(proj.radius, proj.valid, opacities)
        args = (proj.mean2d, proj.conic, opacities, channels, bin_valid, bin_radius, proj.depth)
        size = dict(width=cam.width, height=cam.height, k_per_tile=k_per_tile,
                    xla_blend=xla_blend)
        if grad_exact == "hybrid":
            accum, log_t, dropped, _ = rasterize_tiled_hybrid(*args, **size)
        elif grad_exact or exact:
            accum, log_t, csr_dropped = rasterize_tiled_exact(
                *args, width=cam.width, height=cam.height, differentiable=bool(grad_exact)
            )
            if csr_dropped and grad_exact:
                accum, log_t, dropped = rasterize_tiled(*args, **size)
            elif csr_dropped:
                # a tile list never exceeds the Gaussian count, so ceil(N/k)
                # windows make the multi-pass walk exact; it stops once
                # every overflowing tile saturates or exhausts
                exact_passes = -(-proj.mean2d.shape[0] // k_per_tile)
                accum, log_t, _ = rasterize_tiled(*args, **size, max_passes=exact_passes)
        else:
            accum, log_t, dropped = rasterize_tiled(*args, **size)
    transmittance = torch.exp(log_t)  # (P,)
    out_rgb = accum[:, :3] + transmittance[:, None] * bg[None, :]
    hw = (cam.height, cam.width)
    return RenderOutput(
        rgb=out_rgb.reshape(hw + (3,)),
        depth=accum[:, 3].reshape(hw),
        depth_sq=accum[:, 4].reshape(hw),
        alpha=(1.0 - transmittance).reshape(hw),
        radii=proj.radius,
        mean2d=proj.mean2d,
        valid=proj.valid,
        dropped=dropped,
    )


def render(
    buf: GaussianBuffer,
    cam: Camera,
    bg: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    chunk: int = 128,
    active_override: Optional[torch.Tensor] = None,
    k_per_tile: int = 0,
    exact: bool = False,
    grad_exact=False,
) -> RenderOutput:
    """Render the Gaussian map into `cam`; differentiable in all parameters.
    `active_override` renders a subset without reshaping buffers."""
    params = buf.params
    active = buf.active if active_override is None else (buf.active & active_override)
    with stage("render/project"):
        proj = project_gaussians(
            params.means3d, params.quats, params.log_scales, active,
            cam.w2c, cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
            near=cam.near, far=cam.far, scale_modifier=scale_modifier,
        )
    return render_projected(
        proj, params.rgb, torch.sigmoid(params.logit_opacities), cam, bg=bg,
        chunk=chunk, k_per_tile=k_per_tile, exact=exact, grad_exact=grad_exact,
    )
