"""Tile-binned rasterizer with the k cap: the training render path
(counterpart of activesplat_tpu/ops/raster_tiled.py, single-pass branch).

  1. depth sort, with the binning attributes quantized exactly as the
     reference packs them (_sort_pack): tile membership depends on it;
  2. per-tile lists of the K nearest members (bin_gaussians), by duplicating
     each Gaussian once per overlapped tile and sorting the (tile, depth rank)
     pairs — the lists the reference's counting hierarchy builds;
  3. gather each tile's rows from the unsorted, differentiable attributes and
     blend them in the CUDA tile-blend kernels (ops/raster_cuda.py).

The reference's static-shape devices that change no output are not ported:
the visible-prefix buckets (a lax.switch over prefix lengths) become one
slice to the visible count, at the cost of one host sync per render.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from activesplat_tpu_torch.ops.raster_cuda import N_ATTR, SEG, TILE, blend_tiles

# harmful-drop threshold: overflow counts only in tiles with > 2% end-of-list
# transmittance left at some pixel
_SATURATED_LOG_T = float(np.log(0.02))


def tile_aabbs(mx, my, radius, valid, tiles_x: int, tiles_y: int):
    """Per-Gaussian tile-grid AABBs with the off-grid cull: a Gaussian whose
    AABB misses the grid entirely must not clamp into a border tile as a
    phantom member. Returns (valid, tx0, tx1, ty0, ty1), bounds as floats."""
    inside = (
        (mx + radius >= 0.0)
        & (mx - radius < tiles_x * TILE)
        & (my + radius >= 0.0)
        & (my - radius < tiles_y * TILE)
    )
    valid = valid & inside
    tx0 = torch.clamp(torch.floor((mx - radius) / TILE), 0, tiles_x - 1)
    tx1 = torch.clamp(torch.floor((mx + radius) / TILE), 0, tiles_x - 1)
    ty0 = torch.clamp(torch.floor((my - radius) / TILE), 0, tiles_y - 1)
    ty1 = torch.clamp(torch.floor((my + radius) / TILE), 0, tiles_y - 1)
    return valid, tx0, tx1, ty0, ty1


class TileLists(NamedTuple):
    indices: torch.Tensor  # (T, K) int64 — ids in sorted order, depth-ascending; N = empty
    count: torch.Tensor  # (T,) int32 — number of valid entries per tile
    overflow: torch.Tensor  # (T,) int32 — memberships dropped by the K cap


def bin_gaussians(
    mean2d: torch.Tensor,  # (N, 2) DEPTH-SORTED order
    radius: torch.Tensor,  # (N,)
    valid: torch.Tensor,  # (N,) bool
    width: int,
    height: int,
    k_per_tile: int,
) -> TileLists:
    """Fixed-capacity per-tile lists: the first k members of each tile in
    depth order, and the count cut by the cap. Costs one host sync (the
    number of (tile, Gaussian) pairs)."""
    n = mean2d.shape[0]
    dev = mean2d.device
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    t = tiles_x * tiles_y
    valid, tx0, tx1, ty0, ty1 = tile_aabbs(
        mean2d[:, 0], mean2d[:, 1], radius, valid, tiles_x, tiles_y
    )
    tx0, tx1, ty0, ty1 = (x.to(torch.int64) for x in (tx0, tx1, ty0, ty1))
    span_x = tx1 - tx0 + 1
    n_tiles = torch.where(valid, span_x * (ty1 - ty0 + 1), 0)

    # one (tile, rank) pair per membership; ranks ascend within each
    # Gaussian's run, so a stable sort by tile keeps depth order per tile
    ids = torch.repeat_interleave(torch.arange(n, device=dev), n_tiles)
    first = torch.cumsum(n_tiles, 0) - n_tiles
    local = torch.arange(ids.shape[0], device=dev) - first[ids]
    tile = (ty0[ids] + local // span_x[ids]) * tiles_x + tx0[ids] + local % span_x[ids]
    tile, perm = torch.sort(tile, stable=True)
    ids = ids[perm]

    count_full = torch.bincount(tile, minlength=t)
    start = torch.cumsum(count_full, 0) - count_full
    slot = torch.arange(tile.shape[0], device=dev) - start[tile]
    keep = slot < k_per_tile
    indices = torch.full((t * k_per_tile + 1,), n, dtype=torch.int64, device=dev)
    dest = torch.where(keep, tile * k_per_tile + slot, t * k_per_tile)
    indices[dest] = ids  # entries past the cap land in the spare last cell
    return TileLists(
        indices=indices[:-1].view(t, k_per_tile),
        count=torch.clamp(count_full, max=k_per_tile).to(torch.int32),
        overflow=torch.clamp(count_full - k_per_tile, min=0).to(torch.int32),
    )


def _sort_pack(data: torch.Tensor, key: torch.Tensor, radius: torch.Tensor, valid: torch.Tensor):
    """Depth sort with the binning attributes quantized as the reference
    packs them: mean2d to 1/8 px (round half to even), as two int16 halves
    of one int32 unpacked with an arithmetic shift, and the radius inflated
    by the 2/8 px rounding bound. Sorted stably (the reference's sort is not
    stable, so ties between equal depths may order differently there).

    Returns (packed (N, 4) [mx, my, radius, valid>0], order (N,) int64
    sorted -> original index map)."""
    scale = 8.0
    lim = float(2**15 - 2)
    data, key, radius = data.detach(), key.detach(), radius.detach()
    qx = torch.clamp(torch.round(data[:, 0] * scale), -lim, lim).to(torch.int32)
    qy = torch.clamp(torch.round(data[:, 1] * scale), -lim, lim).to(torch.int32)
    # (qx << 16) | (qy & 0xFFFF), written without shifting a negative value
    packed_xy = qx * 65536 + (qy & 0xFFFF)
    val_rad = torch.where(valid, radius, torch.full_like(radius, -1.0))
    order = torch.argsort(key, stable=True)
    s_xy = packed_xy[order]
    s_vr = val_rad[order]
    s_mx = (s_xy >> 16).to(data.dtype) / scale  # arithmetic shift: signed
    s_my = (((s_xy & 0xFFFF) ^ 0x8000) - 0x8000).to(data.dtype) / scale
    s_val = (s_vr >= 0.0).to(data.dtype)
    s_rad = torch.clamp(s_vr, min=0.0) + 2.0 / scale
    return torch.stack([s_mx, s_my, s_rad, s_val], -1), order


def rasterize_tiled(
    mean2d: torch.Tensor,  # (N, 2) UNSORTED (projection order)
    conic: torch.Tensor,
    opacity: torch.Tensor,
    colors: torch.Tensor,  # (N, C)
    valid: torch.Tensor,
    radius: torch.Tensor,
    depth: torch.Tensor,  # (N,)
    *,
    width: int,
    height: int,
    k_per_tile: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tile-binned front-to-back compositing of each tile's nearest
    k_per_tile members, differentiable through the tile blend.

    Returns (accum (H*W, C), log_transmittance (H*W,), dropped ()).
    `dropped` counts HARMFUL truncations: memberships cut by the k cap in
    tiles that did not saturate (some pixel's end-of-list transmittance
    > 2%)."""
    tile_data, tile_u0, tile_v0, overflow = tile_rows(
        mean2d, conic, opacity, colors, valid, radius, depth,
        width=width, height=height, k_per_tile=k_per_tile,
    )
    c_dim = colors.shape[1]
    accum_t, logt_t = blend_tiles(tile_data, tile_u0, tile_v0, c_dim)

    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    accum_img, logt_img = _tiles_to_image(accum_t, logt_t, tiles_x, tiles_y, width, height)
    unsaturated = logt_t.detach().amax(dim=1) > _SATURATED_LOG_T
    dropped = torch.where(unsaturated, overflow, 0).sum(dtype=torch.int32)
    return (
        accum_img.reshape(height * width, c_dim),
        logt_img.reshape(height * width),
        dropped,
    )


def tile_rows(
    mean2d, conic, opacity, colors, valid, radius, depth,
    *, width: int, height: int, k_per_tile: int,
):
    """Sort, bin and gather: the blend kernels' inputs for one render.

    Returns (tile_data (T, K', 16) with K' = the list capacity rounded up to
    a SEG multiple, tile_u0 (T,) int32, tile_v0 (T,) int32, overflow (T,)).
    tile_data is differentiable in the per-Gaussian inputs (through the row
    gather); the lists themselves are not."""
    n = mean2d.shape[0]
    c_dim = colors.shape[1]
    if c_dim > 8:
        raise ValueError(f"the tile blend supports at most 8 channels, got {c_dim}")
    key = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    data = torch.cat([mean2d, conic, opacity[:, None], colors], -1)  # (N, 6 + C)
    packed, order = _sort_pack(data, key, radius, valid)
    # visible Gaussians form a prefix of the sorted order: bin only that
    # (one host sync; the reference switches over static prefix buckets)
    b = max(int(valid.sum()), 1)
    k_per_tile = min(k_per_tile, b)
    lists = bin_gaussians(
        packed[:b, :2], packed[:b, 2], packed[:b, 3] > 0, width, height, k_per_tile
    )
    # sorted-order list entries -> original Gaussian ids; bin padding (b)
    # becomes the blend padding row (n)
    global_ids = torch.where(
        lists.indices >= b, n, order[torch.clamp(lists.indices, max=n - 1)]
    )
    # the blend walks SEG-row segments: pad each list with padding rows
    if k_per_tile % SEG:
        global_ids = F.pad(global_ids, (0, SEG - k_per_tile % SEG), value=n)

    dev = data.device
    # padding row (index n): off-screen mean, unit conic, zero opacity/colors
    pad_row = torch.cat(
        [
            torch.full((1, 2), -1e9, dtype=data.dtype, device=dev),
            torch.ones((1, 3), dtype=data.dtype, device=dev),
            torch.zeros((1, 1 + c_dim), dtype=data.dtype, device=dev),
        ],
        -1,
    )
    pad_data = torch.cat([data, pad_row], 0)  # (N+1, 6+C)
    # gather only live columns (the backward's scatter-add then moves only
    # those), pad to the kernel's 16 columns after
    tile_data = F.pad(pad_data[global_ids], (0, N_ATTR - 6 - c_dim))  # (T, K', 16)

    tiles_x = -(-width // TILE)
    tile_ids = torch.arange(global_ids.shape[0], dtype=torch.int32, device=dev)
    tile_u0 = (tile_ids % tiles_x) * TILE
    tile_v0 = torch.div(tile_ids, tiles_x, rounding_mode="floor") * TILE
    return tile_data, tile_u0, tile_v0, lists.overflow


def _tiles_to_image(accum_t, logt_t, tiles_x, tiles_y, width, height):
    """(T, TILE*TILE, C)/(T, TILE*TILE) tile blocks -> cropped images."""
    c_dim = accum_t.shape[-1]
    accum_img = (
        accum_t.reshape(tiles_y, tiles_x, TILE, TILE, c_dim)
        .permute(0, 2, 1, 3, 4)
        .reshape(tiles_y * TILE, tiles_x * TILE, c_dim)[:height, :width]
    )
    logt_img = (
        logt_t.reshape(tiles_y, tiles_x, TILE, TILE)
        .permute(0, 2, 1, 3)
        .reshape(tiles_y * TILE, tiles_x * TILE)[:height, :width]
    )
    return accum_img, logt_img
