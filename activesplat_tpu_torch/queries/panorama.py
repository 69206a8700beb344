"""Panoramic (360 degree) invisibility queries for exploration scoring
(counterpart of activesplat_tpu/queries/panorama.py).

Reference behaviour (get_global_invisibility / get_local_invisibility,
src/mapper/splatam/__init__.py:697-838): three 120 degree HFOV x 150 degree
VFOV renders (120x150 px at scale 1: one pixel per degree) stitched into a
panorama; invisibility = 1 - composited opacity; global queries score hole
volumes by DBSCAN and convex hulls, local queries propose a reorientation
toward the largest invisible cluster.

Every view is an exact forward render (the CSR walk, kernel B3), one view
after another on the map's device; with a mesh (parallel/sharded.py) the
views split into contiguous blocks, one a device, each rendered against
the buffer copied there. The score inputs are quantized on the
device (depth to uint16 millimetres, alpha to uint8 / 255, rounded half to
even, as the reference rounds) and cross to the host in one copy each. A
node at the origin (position all zero) is skipped and scores (0, 0, 0); its
views are not rendered.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from activesplat_tpu_torch.device import current_device
from activesplat_tpu_torch.models.gaussians import Camera, GaussianBuffer, make_camera
from activesplat_tpu_torch.ops.render import render
from activesplat_tpu_torch.queries.clusters import (
    get_convexhull_volume,
    get_invisibility_clusters,
    resize_area,
)
from activesplat_tpu_torch.utils.tracing import fetch
from activesplat_tpu_torch.utils.transforms import compute_intrinsics, rot_axis

PANO_HFOV_DEG = 120.0
PANO_VFOV_DEG = 150.0
PANO_WIDTH = 120  # at scale 1.0: 1 px == 1 degree (splatam/__init__.py:711)
PANO_HEIGHT = 150
PANO_VIEWS = 3  # 360 / PANO_HFOV
ALPHA_SOLID = 0.7  # a panorama pixel counts as converged surface above this


def pano_dims(scale: float = 1.0):
    return int(round(PANO_WIDTH * scale)), int(round(PANO_HEIGHT * scale))


def _pano_camera(scale: float, device) -> Camera:
    width, height = pano_dims(scale)
    fx, fy, cx, cy = compute_intrinsics(
        width, height, np.deg2rad(PANO_HFOV_DEG), np.deg2rad(PANO_VFOV_DEG)
    )
    intr = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    return make_camera(width, height, intr, np.eye(4), near=0.01, far=100.0, device=device)


def pano_view_poses(view_c2w: np.ndarray) -> np.ndarray:
    """The 3 look-around c2ws: successive 120 degree rotations about the
    camera's own vertical axis (splatam/__init__.py:716-717)."""
    return np.stack(
        [rot_axis(view_c2w, "y", np.deg2rad(PANO_HFOV_DEG * i)) for i in range(PANO_VIEWS)]
    )


@torch.no_grad()
def _render_views(buf: GaussianBuffer, poses: np.ndarray, chunk: int, scale: float):
    """Exact renders of (M, 4, 4) c2ws, one after another: stacked (rgb (M,
    H, W, 3), depth (M, H, W), alpha (M, H, W)) on the map's device. Uncapped
    alpha: a truncated panorama reads invisibility high, which would keep the
    planner revisiting mapped space."""
    cam = _pano_camera(scale, buf.device)
    w2cs = torch.tensor(np.linalg.inv(poses), dtype=torch.float32, device=buf.device)
    outs = [
        render(buf, cam.replace(w2c=w2c), chunk=chunk, k_per_tile=256, exact=True)
        for w2c in w2cs
    ]
    return tuple(torch.stack([getattr(o, f) for o in outs]) for f in ("rgb", "depth", "alpha"))


def _quantized(buf: GaussianBuffer, poses: np.ndarray, chunk: int, scale: float):
    _, depth, alpha = _render_views(buf, poses, chunk, scale)
    depth_mm = torch.clamp(torch.round(depth * 1000.0), 0, 65535).to(torch.uint16)
    alpha_u8 = torch.round(torch.clamp(alpha, 0.0, 1.0) * 255.0).to(torch.uint8)
    return depth_mm, alpha_u8


def _render_views_quantized(buf: GaussianBuffer, poses: np.ndarray, chunk: int, scale: float,
                            mesh=None):
    """_render_views with the score inputs quantized on the device: depth as
    uint16 millimetres (the dataset-dump precision), alpha as uint8 / 255.
    Hole scoring thresholds invisibility at 0.3 and 0.8, far above 1/255,
    and the host copy shrinks 2.7x.

    `mesh` (parallel/sharded.RenderMesh) shards the views: contiguous
    blocks, one a device (sizes differ by at most one view), each rendered
    against the buffer copied to that device; the quantized outputs come
    back to the map's device. A view renders alike on any device of a type,
    so the outputs equal the unsharded ones."""
    if mesh is None:
        return _quantized(buf, poses, chunk, scale)
    parts = []
    for dev, block in zip(mesh.devices, np.array_split(poses, mesh.px)):
        if len(block):
            with current_device(dev):
                parts.append(tuple(x.to(buf.device) for x in _quantized(
                    buf.to(dev), block, chunk, scale)))
    return tuple(torch.cat(p, 0) for p in zip(*parts))


def render_panorama(
    buf: GaussianBuffer, view_c2w: np.ndarray, chunk: int = 256, scale: float = 1.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One 360 degree panorama: (rgb (H, 3W, 3), depth (H, 3W), invisibility
    (H, 3W)) as numpy arrays."""
    rgb, depth, alpha = _render_views(buf, pano_view_poses(view_c2w), chunk, scale)
    rgb = np.concatenate(fetch(rgb), axis=1)
    depth = np.concatenate(fetch(depth), axis=1)
    invis = 1.0 - np.concatenate(fetch(alpha), axis=1)
    return rgb, depth, invis


def global_invisibility(
    buf: GaussianBuffer,
    view_c2w: np.ndarray,
    node_positions: np.ndarray,  # (N, 3) world positions (height from the view)
    chunk: int = 256,
    scale: float = 1.0,
    mesh=None,
) -> List[Tuple[float, float, float]]:
    """Per-node (sum_invisibility, hole_volume, reach) scores
    (get_global_invisibility, splatam/__init__.py:697-759: the node's
    position replaces the camera's horizontal position; height and
    orientation are the current frame's). Hole scoring (DBSCAN and convex
    hulls) runs on the host over the small panoramas.

    `reach` is the radius within which a map change can move this node's
    score: the largest depth over pixels with alpha >= ALPHA_SOLID, or +inf
    when any pixel is still a hole (content appearing at any distance
    through a hole can change the score). `mesh` shards the views over its
    devices (_render_views_quantized)."""
    node_positions = np.asarray(node_positions, np.float64).reshape(-1, 3)
    n = len(node_positions)
    skip = np.all(node_positions == 0, axis=1)
    rendered = np.flatnonzero(~skip)
    if len(rendered) == 0:
        return [(0.0, 0.0, 0.0)] * n
    poses = []
    for i in rendered:
        c2w = np.array(view_c2w, np.float64)
        c2w[0, 3] = node_positions[i, 0]
        c2w[2, 3] = node_positions[i, 2]  # the camera's height is kept (splatam/__init__.py:703-704)
        poses.append(pano_view_poses(c2w))
    width, height = pano_dims(scale)
    depth_mm, alpha_u8 = _render_views_quantized(buf, np.concatenate(poses, 0), chunk, scale,
                                                 mesh)
    depth = fetch(depth_mm).reshape(-1, PANO_VIEWS, height, width).astype(np.float64) / 1000.0
    alpha = fetch(alpha_u8).reshape(-1, PANO_VIEWS, height, width).astype(np.float64) / 255.0

    results = [(0.0, 0.0, 0.0)] * n
    for j, i in enumerate(rendered):
        pano_depth = np.concatenate(depth[j], axis=1)
        pano_alpha = np.concatenate(alpha[j], axis=1)
        inv_sum, volume = get_convexhull_volume(
            pano_depth, 1.0 - pano_alpha, vfov_deg=PANO_VFOV_DEG
        )
        reach = float(pano_depth.max()) if (pano_alpha >= ALPHA_SOLID).all() else float("inf")
        results[i] = (float(inv_sum), float(volume), reach)
    return results


def local_invisibility(
    buf: GaussianBuffer,
    view_c2w: np.ndarray,
    cluster_invisibility_threshold: float = 25.0,
    chunk: int = 256,
    scale: float = 1.0,
    mesh=None,
) -> Tuple[float, Optional[np.ndarray], np.ndarray]:
    """Local refinement query: (sum_invisibility, best reorientation c2w or
    None, invisibility panorama). A reorientation toward the largest
    invisible cluster is proposed when its direction is > 15 degrees off
    centre (get_local_invisibility, splatam/__init__.py:761-838). Only the
    alpha panorama crosses to the host. `mesh` shards the three views over
    its devices (_render_views_quantized)."""
    _, alpha_u8 = _render_views_quantized(buf, pano_view_poses(view_c2w), chunk, scale, mesh)
    invis = 1.0 - np.concatenate(fetch(alpha_u8), axis=1) / 255.0
    sum_invis = float(np.sum(invis))
    best_pose = None
    if sum_invis > 100.0 * scale * scale:
        # 0.5x downsample before clustering (splatam/__init__.py:810-813)
        factor = 0.5
        small = resize_area(
            invis, int(invis.shape[1] * factor), int(invis.shape[0] * factor)
        )
        centers, sums = get_invisibility_clusters(small, cluster_invisibility_threshold)
        if sums:
            c = centers[int(np.argmax(sums))]
            # pixel offsets from the FIRST view's centre (the current
            # heading), 1 px == 1/scale degrees (splatam/__init__.py:821-823)
            du = c[1] / factor - invis.shape[1] / PANO_VIEWS / 2
            dv = c[0] / factor - invis.shape[0] / 2
            h_angle = np.deg2rad(du / scale)
            v_angle = np.deg2rad(dv / scale)
            if abs(h_angle) > np.deg2rad(15) or abs(v_angle) > np.deg2rad(15):
                best_pose = rot_axis(view_c2w, "y", h_angle)
                best_pose = rot_axis(best_pose, "x", v_angle)
    return sum_invis, best_pose, invis
