"""Top-down occupancy and visibility queries on the Gaussian map (counterpart
of activesplat_tpu/queries/topdown.py).

Reproduces the reference's top-down pipeline (visualizer.py:920-976,
1576-1618, 2277-2286): a near-orthographic camera far above the scene renders
(a) the *free map*, the opacity of the map sliced to the agent's height band
with splats shrunk by scale_modifier=0.01, free where opacity <= 0.4, and
(b) the *unobserved map*, the pure-white pixels of a white-background colour
render. Grid geometry (pixel_max over the larger dimension, world<->pixel
transforms) follows gui_utils.config_topdown_info and
translations_world_to_topdown (gui_utils.py:170-281).

Both maps come from ONE exact walk (`_topdown_dual`): the CSR expansion of
every (Gaussian, tile) membership blended by kernel B5, which carries the
whole map's colour and transmittance and the band's transmittance at once.
`_topdown_binary`, the pair of exact renders, stays as its parity oracle.
`IncrementalTopdown` re-renders only the tile window a map change touched.

Coordinate convention: world height axis +up; the top-down image's u axis is
world dim (h+1)%3 increasing, its v axis world dim (h-1)%3 decreasing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from activesplat_tpu_torch.models.gaussians import Camera, GaussianBuffer, make_camera
from activesplat_tpu_torch.ops.projection import adaptive_cull_radius, project_gaussians
from activesplat_tpu_torch.ops.raster_tiled import (
    TILE,
    rasterize_tiled,
    rasterize_tiled_exact,
    tile_aabbs,
)
from activesplat_tpu_torch.ops.render import render
from activesplat_tpu_torch.utils.tracing import fetch, stage

CAMERA_HEIGHT = 1000.0  # visualizer.py:1577
FREE_OPACITY_THRESHOLD = 0.4  # visualizer.py:954
TOPDOWN_SCALE_MODIFIER = 0.01  # visualizer.py:936-937


@dataclasses.dataclass(frozen=True)
class TopdownConfig:
    height_axis: int  # world axis pointing up
    world_dim_index: Tuple[int, int]  # (u-axis world dim, v-axis world dim)
    world_2d_bbox: Tuple[Tuple[float, float], Tuple[float, float]]
    grid_shape: Tuple[int, int]  # (width px, height px)
    meter_per_pixel: float
    world_center: Tuple[float, float]
    agent_foot: float  # world height of agent base
    agent_head: float  # world height of agent top

    @property
    def width(self) -> int:
        return self.grid_shape[0]

    @property
    def height(self) -> int:
        return self.grid_shape[1]


def topdown_config_from_bbox(
    bbox: np.ndarray,  # (3, 2) world min/max
    agent_foot: float,
    agent_head: float,
    pixel_max: int = 360,
    height_axis: int = 1,
    padding_ratio: float = 0.05,
) -> TopdownConfig:
    """Grid geometry from a scene bbox (visualizer.py:214-273: pad the bbox,
    pixel_max pixels along the larger dimension)."""
    bbox = np.asarray(bbox, np.float64)
    bbox = bbox + padding_ratio * np.ptp(bbox, axis=1, keepdims=True) * np.array([-1.0, 1.0])
    dim_u = (height_axis + 1) % 3
    dim_v = (height_axis - 1) % 3
    ub = (float(bbox[dim_u, 0]), float(bbox[dim_u, 1]))
    vb = (float(bbox[dim_v, 0]), float(bbox[dim_v, 1]))
    shape_u = ub[1] - ub[0]
    shape_v = vb[1] - vb[0]
    meter_per_pixel = max(shape_u, shape_v) / pixel_max
    grid = (int(np.ceil(shape_u / meter_per_pixel)), int(np.ceil(shape_v / meter_per_pixel)))
    return TopdownConfig(
        height_axis=height_axis,
        world_dim_index=(dim_u, dim_v),
        world_2d_bbox=(ub, vb),
        grid_shape=grid,
        meter_per_pixel=meter_per_pixel,
        world_center=((ub[0] + ub[1]) / 2, (vb[0] + vb[1]) / 2),
        agent_foot=agent_foot,
        agent_head=agent_head,
    )


def world_to_topdown(points: np.ndarray, cfg: TopdownConfig) -> np.ndarray:
    """(N, 3) world -> (N, 2) float pixel coordinates (u, v)."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    u = (pts[:, cfg.world_dim_index[0]] - cfg.world_2d_bbox[0][0]) / cfg.meter_per_pixel
    v = (cfg.world_2d_bbox[1][1] - pts[:, cfg.world_dim_index[1]]) / cfg.meter_per_pixel
    return np.stack([u, v], -1)


def topdown_to_world(uv: np.ndarray, cfg: TopdownConfig, height_value: float) -> np.ndarray:
    """(2,) pixel -> (3,) world at the given height."""
    out = np.full(3, float(height_value))
    out[cfg.world_dim_index[0]] = uv[0] * cfg.meter_per_pixel + cfg.world_2d_bbox[0][0]
    out[cfg.world_dim_index[1]] = cfg.world_2d_bbox[1][1] - uv[1] * cfg.meter_per_pixel
    return out


def heading_to_topdown(c2w: np.ndarray, cfg: TopdownConfig) -> np.ndarray:
    """The camera's forward direction projected into the top-down plane, unit
    (2,) (role of c2w_world_to_topdown's rotation vector,
    gui_utils.py:188-220)."""
    fwd = np.asarray(c2w)[:3, 2]  # an OpenCV camera looks along +z
    du = fwd[cfg.world_dim_index[0]]
    dv = -fwd[cfg.world_dim_index[1]]
    n = np.hypot(du, dv)
    if n < 1e-9:
        return np.array([1.0, 0.0])
    return np.array([du / n, dv / n])


def topdown_camera(cfg: TopdownConfig, device=None) -> Camera:
    """Near-orthographic perspective camera CAMERA_HEIGHT above the scene,
    scaled so the ground plane maps 1:1 onto grid pixels."""
    h_axis = cfg.height_axis
    dim_u, dim_v = cfg.world_dim_index
    x_cam = np.zeros(3)
    x_cam[dim_u] = 1.0
    z_cam = np.zeros(3)
    z_cam[h_axis] = -1.0  # looking down
    y_cam = np.cross(z_cam, x_cam)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = x_cam, y_cam, z_cam
    pos = np.zeros(3)
    pos[dim_u] = cfg.world_center[0]
    pos[dim_v] = cfg.world_center[1]
    pos[h_axis] = CAMERA_HEIGHT
    c2w[:3, 3] = pos
    f = CAMERA_HEIGHT / cfg.meter_per_pixel
    intr = np.array([[f, 0, cfg.width / 2 - 0.5], [0, f, cfg.height / 2 - 0.5], [0, 0, 1]])
    return make_camera(
        cfg.width, cfg.height, intr, np.linalg.inv(c2w),
        near=0.01, far=2 * CAMERA_HEIGHT, device=device,
    )


def _band_mask(means3d: torch.Tensor, height_axis: int, foot, head) -> torch.Tensor:
    """Gaussians whose centre height lies in [foot, head], compared in
    float32 as the reference compares."""
    h = means3d[:, height_axis]
    foot, head = (torch.tensor(np.float32(v), device=h.device) for v in (foot, head))
    return (h >= foot) & (h <= head)


def height_slice_mask(buf: GaussianBuffer, cfg: TopdownConfig, foot_adjust: float = 0.0):
    """Active-override mask keeping the Gaussians within the agent's body band
    (role of __cut_gaussian_by_height, visualizer.py:2277-2286)."""
    return _band_mask(
        buf.params.means3d, cfg.height_axis, cfg.agent_foot + foot_adjust, cfg.agent_head
    )


def render_topdown(
    buf: GaussianBuffer,
    cfg: TopdownConfig,
    foot_adjust: float = 0.0,
    k_per_tile: int = 256,
) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """The get_topdown service's payload (visualizer.py:926-976, binarized at
    :954-955): (free_map_binary uint8 (H, W), unobserved_map_binary uint8
    (H, W), free_opacity float32 (H, W) left on the map's device).

    free = 1 where the height-sliced map's opacity <= 0.4 (the agent's body
    band is unobstructed); unobserved = 1 where nothing has been mapped (the
    reference's 'visible_map_binary': pure-white pixels of a white-background
    colour render). Binarization runs on the device and the stacked u8 pair
    crosses to the host in one copy."""
    cam = topdown_camera(cfg, device=buf.device)
    both_u8, free_alpha = _topdown_dual(
        buf, cam, cfg.agent_foot + foot_adjust, cfg.agent_head,
        (0, 0, cfg.width, cfg.height), height_axis=cfg.height_axis, k_per_tile=k_per_tile,
    )
    both = fetch(both_u8)
    return both[0], both[1], free_alpha


def _binarize(free_alpha: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """(2, H, W) uint8 [free, unobserved] from the band opacity (H, W) and the
    white-background colour render (H, W, 3)."""
    free_u8 = (free_alpha <= FREE_OPACITY_THRESHOLD).to(torch.uint8)
    # uint8 TRUNCATION (the reference's .astype(np.uint8) cast) and
    # grayscale, compared with 255 as the reference compares: rounding would
    # flip faintly observed pixels (rgb ~0.999) back to "unobserved"
    rgb_u8 = torch.floor(torch.clamp(rgb, 0.0, 1.0) * 255.0)
    gray = torch.round(0.299 * rgb_u8[..., 0] + 0.587 * rgb_u8[..., 1] + 0.114 * rgb_u8[..., 2])
    unobs_u8 = (gray == 255.0).to(torch.uint8)
    return torch.stack([free_u8, unobs_u8])


@torch.no_grad()
def _topdown_binary(buf: GaussianBuffer, cam: Camera, foot, head, *, height_axis: int,
                    chunk: int, k_per_tile: int):
    """Both top-down renders, the height slice and the binarization as a pair
    of exact renders (B3 twice): the parity oracle of `_topdown_dual`.
    Returns (stacked (2, H, W) uint8 [free, unobserved], free alpha (H, W))."""
    sliced = _band_mask(buf.params.means3d, height_axis, foot, head)
    exact = k_per_tile > 0
    free = render(
        buf, cam, scale_modifier=TOPDOWN_SCALE_MODIFIER, chunk=chunk, active_override=sliced,
        k_per_tile=k_per_tile, exact=exact,
    )
    full = render(
        buf, cam, bg=torch.ones(3, device=buf.device), scale_modifier=TOPDOWN_SCALE_MODIFIER,
        chunk=chunk, k_per_tile=k_per_tile, exact=exact,
    )
    return _binarize(free.alpha, full.rgb), free.alpha


@torch.no_grad()
def _topdown_dual(buf: GaussianBuffer, cam: Camera, foot, head, rect, *, height_axis: int,
                  k_per_tile: int):
    """Both maps from ONE dual-transmittance walk (rasterize_tiled_exact with
    band=, kernel B5), restricted to the tile-aligned pixel window `rect` =
    (u0, v0, w, h). The window is a Gaussian CULL: the binning's own AABB
    predicate, with 0.5 px of slack for the sort-pack's mean quantization and
    radius dilation, against the window's tile rect. It keeps exactly the
    Gaussians whose entries a window tile receives in the full render, and
    the stable depth sort keeps their order, so window pixels composite the
    full render's entry runs; pixels outside `rect` are not valid and callers
    composite only the window.

    Past the entry budget it takes the reference's bounded multipass pair
    (the band map through band-masked opacities: zeroed alphas composite as
    exclusion does), decided on the host.

    Returns (stacked (2, H, W) uint8 [free, unobserved], free alpha (H, W)
    float32), both on the map's device."""
    params = buf.params
    proj = project_gaussians(
        params.means3d, params.quats, params.log_scales, buf.active, cam.w2c,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
        near=cam.near, far=cam.far, scale_modifier=TOPDOWN_SCALE_MODIFIER,
    )
    opac = torch.sigmoid(params.logit_opacities)
    band = _band_mask(params.means3d, height_axis, foot, head)
    bin_radius, bin_valid = adaptive_cull_radius(proj.radius, proj.valid, opac)

    tiles_x = -(-cam.width // TILE)
    tiles_y = -(-cam.height // TILE)
    _, tx0, tx1, ty0, ty1 = tile_aabbs(
        proj.mean2d[:, 0], proj.mean2d[:, 1], bin_radius + 0.5, bin_valid, tiles_x, tiles_y
    )
    u0, v0, w, h = (int(x) for x in rect)
    tu0, tu1 = u0 // TILE, (u0 + w - 1) // TILE
    tv0, tv1 = v0 // TILE, (v0 + h - 1) // TILE
    keep = (tx0 <= tu1) & (tx1 >= tu0) & (ty0 <= tv1) & (ty1 >= tv0)
    masked_valid = bin_valid & keep

    args = (proj.mean2d, proj.conic, opac, params.rgb, masked_valid, bin_radius, proj.depth)
    accum, logt, logt_band, dropped = rasterize_tiled_exact(
        *args, band, width=cam.width, height=cam.height
    )
    if dropped:
        # a tile list never exceeds the Gaussian count: ceil(N / k) windows
        # make the multipass walk exact
        k = max(int(k_per_tile), 1)
        size = dict(width=cam.width, height=cam.height, k_per_tile=k,
                    max_passes=-(-proj.mean2d.shape[0] // k))
        accum, logt, _ = rasterize_tiled(*args, **size)
        band_args = (proj.mean2d, proj.conic, opac * band, *args[3:])
        _, logt_band, _ = rasterize_tiled(*band_args, **size)

    hw = (cam.height, cam.width)
    free_alpha = (1.0 - torch.exp(logt_band)).reshape(hw)
    rgb = (accum[:, :3] + torch.exp(logt)[:, None]).reshape(hw + (3,))  # white background
    return _binarize(free_alpha, rgb), free_alpha


@torch.no_grad()
def _changed_bbox(params, active, snap_params, snap_active, modifier: float) -> torch.Tensor:
    """The exact changed set against a parameter snapshot, as one (7,)
    float32 tensor [count, lo_xyz, hi_xyz]: the number of Gaussians whose
    parameters or active bit differ from the snapshot, and the world AABB of
    the union of their OLD and NEW footprints (means +- 3 sigma modifier).
    Exactness rests on the mapper's fresh optimizer per event: a Gaussian
    with zero gradient through every iteration of an event is bit-identical
    afterwards, so `!=` finds the set the event touched."""
    differs = torch.zeros_like(active)
    for a, b in zip(params.tensors(), snap_params.tensors()):
        d = a != b
        differs = differs | (d.any(dim=-1) if d.dim() > 1 else d)
    changed = (active & snap_active & differs) | (active ^ snap_active)
    count = changed.to(torch.float32).sum()

    def footprint(p, use):
        ext = 3.0 * torch.exp(p.log_scales).amax(dim=-1, keepdim=True) * modifier
        inf = torch.tensor(float("inf"), device=p.means3d.device)
        lo = torch.where(use[:, None], p.means3d - ext, inf).amin(dim=0)
        hi = torch.where(use[:, None], p.means3d + ext, -inf).amax(dim=0)
        return lo, hi

    lo_n, hi_n = footprint(params, changed & active)
    lo_o, hi_o = footprint(snap_params, changed & snap_active)
    return torch.cat([count[None], torch.minimum(lo_n, lo_o), torch.maximum(hi_n, hi_o)])


class IncrementalTopdown:
    """Top-down map cache with windowed re-renders.

    The planner polls get_topdown every navigation tick; the reference
    re-renders the full grid whenever the map changed (visualizer.py:926-976,
    per GaussianPacket). A mapping event touches a local set of Gaussians,
    found exactly by diffing the parameters against a snapshot taken at the
    last render (`_changed_bbox`); the changed box (old and new footprints,
    padded for screen-space dilation) is tile-aligned and re-rendered through
    `_topdown_dual`'s window, and the window is composited into the cached
    maps. Capacity growth and whole-grid boxes render the full grid.

    The snapshot is a COPY of the parameters and the active mask: the port
    writes maps in place (the keyframe store, bench maps, callers' edits), so
    a reference to the live tensors would diff equal to itself and miss the
    change. It costs the map's parameter bytes once more on the device."""

    # screen-space safety pad (px): EWA low-pass dilation and principal-point
    # rounding; the projection adds <= 2 px of radius, 8 is generous
    MARGIN_PX = 8

    def __init__(self, cfg: TopdownConfig, k_per_tile: int = 256) -> None:
        self.cfg = cfg
        self.k_per_tile = int(k_per_tile)
        self._snap = None  # (params, active) copies at the last render
        self._maps: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # full_first/full_growth/full_oversize decompose "full"
        self.stats = {
            "full": 0, "window": 0, "clean": 0,
            "full_first": 0, "full_growth": 0, "full_oversize": 0,
        }

    def _render_rect(self, buf: GaussianBuffer, foot_adjust: float,
                     u0: int, v0: int, w: int, h: int) -> np.ndarray:
        """The dual walk on [u0:u0+w, v0:v0+h], the u8 pair fetched (full-grid
        arrays; only the rect region is valid)."""
        both_u8, _ = _topdown_dual(
            buf, topdown_camera(self.cfg, device=buf.device),
            self.cfg.agent_foot + foot_adjust, self.cfg.agent_head, (u0, v0, w, h),
            height_axis=self.cfg.height_axis, k_per_tile=self.k_per_tile,
        )
        return fetch(both_u8)

    def _take_snapshot(self, buf: GaussianBuffer) -> None:
        self._snap = (buf.params.map(lambda x: x.detach().clone()), buf.active.clone())

    def _full(self, buf: GaussianBuffer, foot_adjust: float, reason: str = "full_oversize"):
        with stage("queries/topdown/full"):
            both = self._render_rect(buf, foot_adjust, 0, 0, self.cfg.width, self.cfg.height)
        self._maps = (both[0], both[1])
        self._take_snapshot(buf)
        self.stats["full"] += 1
        self.stats[reason] += 1
        return self._maps

    def refresh(self, buf: GaussianBuffer, foot_adjust: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
        """Up-to-date (free_binary, unobserved_binary) uint8 maps."""
        if self._snap is None:
            return self._full(buf, foot_adjust, reason="full_first")
        if self._snap[0].capacity != buf.capacity:
            return self._full(buf, foot_adjust, reason="full_growth")
        with stage("queries/topdown/diff"):
            packed = fetch(_changed_bbox(
                buf.params, buf.active, self._snap[0], self._snap[1], TOPDOWN_SCALE_MODIFIER
            ))
        if packed[0] == 0:
            self.stats["clean"] += 1
            return self._maps
        box = packed[1:].reshape(2, 3)
        # the changed box's 2-D footprint as a pixel bbox
        du, dv = self.cfg.world_dim_index
        corners = np.zeros((2, 3))
        corners[:, du] = (box[0, du], box[1, du])
        corners[:, dv] = (box[0, dv], box[1, dv])
        uv = world_to_topdown(corners, self.cfg)
        lo = np.floor(uv.min(0)) - self.MARGIN_PX
        hi = np.ceil(uv.max(0)) + self.MARGIN_PX
        W, H = self.cfg.width, self.cfg.height
        # tile-align (the window cull keeps whole tiles) and clip to the grid
        u0 = int(np.clip(np.floor(lo[0] / TILE) * TILE, 0, W))
        v0 = int(np.clip(np.floor(lo[1] / TILE) * TILE, 0, H))
        u1 = int(np.clip(np.ceil((hi[0] + 1) / TILE) * TILE, 0, W))
        v1 = int(np.clip(np.ceil((hi[1] + 1) / TILE) * TILE, 0, H))
        if u1 <= u0 or v1 <= v0:
            self.stats["clean"] += 1
            return self._maps
        if (u1 - u0) * (v1 - v0) >= W * H:
            return self._full(buf, foot_adjust)
        with stage("queries/topdown/window"):
            both = self._render_rect(buf, foot_adjust, u0, v0, u1 - u0, v1 - v0)
        free = self._maps[0].copy()
        unobs = self._maps[1].copy()
        free[v0:v1, u0:u1] = both[0][v0:v1, u0:u1]
        unobs[v0:v1, u0:u1] = both[1][v0:v1, u0:u1]
        self._maps = (free, unobs)
        self._take_snapshot(buf)
        self.stats["window"] += 1
        return free, unobs


def horizon_bbox_topdown(bound_min: np.ndarray, bound_max: np.ndarray,
                         cfg: TopdownConfig) -> np.ndarray:
    """Axis-aligned pixel bbox of a world-space horizon box
    (get_horizon_bound_topdown, gui_utils.py:338-361)."""
    corners = np.stack([np.asarray(bound_min), np.asarray(bound_max)])
    uv = world_to_topdown(
        np.array([
            [corners[a][0], corners[b][1], corners[c][2]]
            for a in (0, 1) for b in (0, 1) for c in (0, 1)
        ]),
        cfg,
    )
    return np.stack([uv.min(0), uv.max(0)])
