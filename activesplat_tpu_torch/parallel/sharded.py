"""Device-mesh sharding of the render and the mapping step (counterpart of
activesplat_tpu/parallel/sharded.py).

The parallel axis is image space, as in the JAX package: the render shards
image ROWS over the mesh's devices while the Gaussian buffer stays whole on
the map's device. Projection, the depth sort and the binning cull run once;
each shard receives the projected arrays `.to(its device)`, renders its own
block of rows, and the blocks come back to the mesh's first device, where
`torch.cat` joins them and the loss (with the windowed SSIM, which crosses
the blocks' borders) is computed once. Both copies are differentiable: the
backward of "copy to each shard, then gather the rows" sums the shards'
gradients into the replicated inputs, the counterpart of the all_gather
transpose that the JAX package's shard_map inserts.

The mesh is a list of devices in one process (RenderMesh). On several cards
each shard runs on its own card; a mesh may name one device several times,
a virtual mesh, which runs the same shard code on one card or on the CPU
(the counterpart of the JAX tests' forced host device count). The host
reads of the tiled renders (the visible count, the CSR entry totals, each
shard's fallback) run shard after shard, so the shards do not overlap on
several cards.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from activesplat_tpu_torch.device import current_device
from activesplat_tpu_torch.mapper.adam import AdamState
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.mapper.step import LossAux, _step, loss_and_grads, loss_from_render
from activesplat_tpu_torch.models.gaussians import Camera, GaussianBuffer, GaussianParams
from activesplat_tpu_torch.ops.projection import adaptive_cull_radius, project_gaussians
from activesplat_tpu_torch.ops.raster_tiled import TILE, rasterize_tiled, rasterize_tiled_exact
from activesplat_tpu_torch.ops.raster_xla import depth_sort, rasterize_sorted


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """The render mesh: the devices that the image rows shard over, one
    block of rows each, in order. Not torch.distributed's DeviceMesh: it
    spans devices of one process, and a device may repeat (a virtual
    mesh)."""

    devices: Tuple[torch.device, ...]

    @property
    def px(self) -> int:
        """The number of shards (the JAX mesh's axis "px")."""
        return len(self.devices)


def visible_devices(device_type: str = "cuda") -> Tuple[torch.device, ...]:
    """Every visible device of a type: the CUDA devices, or the one CPU."""
    if device_type == "cpu":
        return (torch.device("cpu"),)
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def make_render_mesh(devices: Optional[Sequence] = None) -> RenderMesh:
    """A mesh over `devices` (default: every visible CUDA device)."""
    devices = visible_devices() if devices is None else devices
    devs = tuple(torch.device(d) for d in devices)
    # a bare "cuda" names the current card, as a tensor's device names it
    devs = tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d for d in devs)
    if not devs:
        raise ValueError("a render mesh needs at least one device")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a render mesh holds devices of one type, got {devs}")
    return RenderMesh(devs)


def mesh_for_height(height: int, devices: Optional[Sequence] = None) -> Optional[RenderMesh]:
    """The largest usable render mesh for an image height: the tiled path
    shards whole 16 px tile rows, so the first d devices for the largest d
    with height % (d * TILE) == 0. None when not even 2 devices fit (the
    callers then render unsharded)."""
    devices = list(visible_devices() if devices is None else devices)
    d = len(devices)
    while d > 1 and height % (d * TILE) != 0:
        d -= 1
    if d < 2:
        return None
    return make_render_mesh(devices[:d])


def _check_mesh(mesh: RenderMesh, device: torch.device) -> None:
    if any(d.type != device.type for d in mesh.devices):
        raise ValueError(f"the mesh {mesh.devices} must hold {device.type} devices, as the map")


def _project(buf: GaussianBuffer, cam: Camera):
    p = buf.params
    proj = project_gaussians(
        p.means3d, p.quats, p.log_scales, buf.active,
        cam.w2c, cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
        near=cam.near, far=cam.far,
    )
    opac = torch.sigmoid(p.logit_opacities)
    channels = torch.cat([p.rgb, proj.depth[:, None], (proj.depth * proj.depth)[:, None]], -1)
    return proj, opac, channels


def _shard_images(accum, log_t, bg, rows: int, width: int, out_device):
    """One shard's (rgb, depth, alpha) blocks, on the gathering device."""
    t = torch.exp(log_t)
    rgb = (accum[:, :3] + t[:, None] * bg.to(t.device)[None, :]).reshape(rows, width, 3)
    depth = accum[:, 3].reshape(rows, width)
    alpha = (1.0 - t).reshape(rows, width)
    return tuple(x.to(out_device) for x in (rgb, depth, alpha))


def _gather(blocks):
    return tuple(torch.cat(parts, 0) for parts in zip(*blocks))


def render_sharded(
    buf: GaussianBuffer,
    cam: Camera,
    mesh: RenderMesh,
    bg: Optional[torch.Tensor] = None,
    chunk: int = 128,
):
    """The dense render with image rows sharded over the mesh: (rgb, depth,
    alpha, radii, dropped=0), the images on the mesh's first device.
    Differentiable. Projection and the depth sort run once on the map's
    device; each shard composites its rows (rasterize_sorted with its
    row_offset) on its own device."""
    _check_mesh(mesh, buf.device)
    n_dev = mesh.px
    if cam.height % n_dev:
        raise ValueError(f"image height {cam.height} must divide over the mesh ({n_dev} devices)")
    rows = cam.height // n_dev
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=buf.device)
    proj, opac, channels = _project(buf, cam)
    _, s_valid, s_mean2d, s_conic, s_opac, s_channels = depth_sort(
        proj.depth, proj.valid, proj.mean2d, proj.conic, opac, channels
    )
    out_dev = mesh.devices[0]
    blocks = []
    for s, dev in enumerate(mesh.devices):
        with current_device(dev):
            args = (x.to(dev) for x in (s_mean2d, s_conic, s_opac, s_channels, s_valid))
            accum, log_t = rasterize_sorted(
                *args, width=cam.width, height=rows, chunk=chunk, row_offset=s * rows
            )
            blocks.append(_shard_images(accum, log_t, bg, rows, cam.width, out_dev))
    rgb, depth, alpha = _gather(blocks)
    return rgb, depth, alpha, proj.radius, torch.zeros((), dtype=torch.int32, device=out_dev)


def render_sharded_tiled(
    buf: GaussianBuffer,
    cam: Camera,
    mesh: RenderMesh,
    bg: Optional[torch.Tensor] = None,
    k_per_tile: int = 256,
    exact: bool = False,
    grad_exact: bool = False,
):
    """The tiled render with whole tile rows sharded over the mesh: (rgb,
    depth, alpha, radii, dropped), the images and `dropped` on the mesh's
    first device. Differentiable.

    Projection and the binning cull run once on the map's device; each
    shard shifts the projected means into its own rows and renders them
    with the tiled rasterizer: the k-capped blend (B1/B2); with grad_exact
    the exact CSR blend and its backward (B3/B4), that shard alone falling
    back to the k-capped blend when its own entries pass the budget; with
    exact (forward only) the multi-pass walk over ceil(N/k) windows, which
    is exact. `dropped` is the sum of the shards' harmful truncations.
    `radii` are the unsharded 3-sigma radii."""
    _check_mesh(mesh, buf.device)
    n_dev = mesh.px
    rows = cam.height // n_dev
    if rows * n_dev != cam.height or rows % TILE:
        raise ValueError(f"height {cam.height} must split into {n_dev} blocks of whole "
                         f"{TILE} px tile rows")
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=buf.device)
    proj, opac, channels = _project(buf, cam)
    # the binning-only opacity-adaptive cull (lossless); the returned radii
    # keep the 3-sigma values
    bin_radius, bin_valid = adaptive_cull_radius(proj.radius, proj.valid, opac)
    n = proj.mean2d.shape[0]
    out_dev = mesh.devices[0]
    blocks, dropped = [], []
    for s, dev in enumerate(mesh.devices):
        with current_device(dev):
            mean2d, *rest = (x.to(dev) for x in (
                proj.mean2d, proj.conic, opac, channels, bin_valid, bin_radius, proj.depth))
            # shift the rows into this shard's frame
            args = (mean2d - mean2d.new_tensor([0.0, float(s * rows)]), *rest)
            size = dict(width=cam.width, height=rows)
            shard_dropped = torch.zeros((), dtype=torch.int32, device=dev)
            if grad_exact:
                accum, log_t, csr_dropped = rasterize_tiled_exact(*args, **size,
                                                                  differentiable=True)
                if csr_dropped:  # this shard's entry budget overflowed
                    accum, log_t, shard_dropped = rasterize_tiled(*args, **size,
                                                                  k_per_tile=k_per_tile)
            else:
                # a tile list never exceeds the Gaussian count, so ceil(N/k)
                # windows are exact; the walk stops once every overflowing
                # tile saturates or exhausts
                passes = -(-n // k_per_tile) if exact else 1
                accum, log_t, shard_dropped = rasterize_tiled(
                    *args, **size, k_per_tile=k_per_tile, max_passes=passes
                )
            blocks.append(_shard_images(accum, log_t, bg, rows, cam.width, out_dev))
            dropped.append(shard_dropped.to(out_dev))
    rgb, depth, alpha = _gather(blocks)
    return rgb, depth, alpha, proj.radius, torch.stack(dropped).sum(dtype=torch.int32)


def sharded_mapping_loss(
    params: GaussianParams,
    buf: GaussianBuffer,
    cam: Camera,
    im_gt: torch.Tensor,
    depth_gt: torch.Tensor,
    cfg: MapperConfig,
    mesh: RenderMesh,
) -> Tuple[torch.Tensor, LossAux]:
    """mapper/step.mapping_loss with the render sharded over the mesh: the
    tiled render where the image splits into whole tile rows a device, else
    the dense one. exact_training "on" and "hybrid" both train through each
    shard's exact CSR walk (the harmful-tile fold of "hybrid" is single-
    device, as in the JAX package). The loss and its aux are computed on the
    mesh's first device."""
    rows = cam.height // mesh.px
    if cfg.k_per_tile > 0 and rows % TILE == 0:
        rgb, depth, alpha, radii, dropped = render_sharded_tiled(
            buf.replace(params=params), cam, mesh, k_per_tile=cfg.k_per_tile,
            grad_exact=cfg.exact_training in ("on", "hybrid"),
        )
    else:
        rgb, depth, alpha, radii, dropped = render_sharded(
            buf.replace(params=params), cam, mesh, chunk=cfg.chunk
        )
    dev = rgb.device
    return loss_from_render(rgb, depth, alpha, radii, dropped, im_gt.to(dev), depth_gt.to(dev),
                            cfg)


def sharded_mapping_step(
    buf: GaussianBuffer,
    opt_state: AdamState,
    cam: Camera,
    im_gt: torch.Tensor,
    depth_gt: torch.Tensor,
    cfg: MapperConfig,
    mesh: RenderMesh,
):
    """One training step on the mesh: sharded render, loss, backward (the
    shards' gradients summed into the buffer's), Adam and max_radius as
    mapper/step.mapping_iteration. Returns (buf, opt_state, metrics)."""
    loss, aux, grads = loss_and_grads(buf, cam, im_gt, depth_gt, cfg, mesh=mesh)
    buf, opt_state = _step(buf, opt_state, grads, aux, cfg)
    return buf, opt_state, {
        "loss": loss, "psnr": aux.psnr, "depth_l1": aux.depth_l1,
        "dropped": aux.dropped, "rgb_l1": aux.rgb_l1, "ssim": aux.ssim,
    }
