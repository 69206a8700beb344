"""Tile-binned rasterizers: the training and exact render paths
(counterpart of activesplat_tpu/ops/raster_tiled.py).

The k-capped path (rasterize_tiled):
  1. depth sort, with the binning attributes quantized exactly as the
     reference packs them (_sort_pack): tile membership depends on it;
  2. per-tile lists of the K nearest members (bin_gaussians), the lists the
     reference's counting hierarchy builds: by default by duplicating each
     Gaussian once per overlapped tile and sorting the (tile, depth rank)
     pairs; with ACTIVESPLAT_BIN_KERNEL=1 (read at import, as the reference
     reads it) by B6's two kernels: per-block member counts, then each
     128-Gaussian block writing its members into their slots;
  3. gather each tile's rows from the unsorted, differentiable attributes and
     blend them in the CUDA tile-blend kernels B1/B2 (ops/raster_cuda.py).
With max_passes > 1 farther k-windows of each list fold in until every
overflowing tile saturates or exhausts (the exact multi-pass walk).
xla_blend=True blends in plain autograd PyTorch with no early exit, the
reference's XLA tile blend, which its gradient tap renders with.

The exact path (rasterize_tiled_exact) expands every (Gaussian, tile)
membership without a cap into CSR runs, each tile's run padded to a CSEG
multiple, and blends them in the CSR kernels B3/B4; with a band mask it
walks them once in the dual kernel B5 (the top-down maps). The hybrid
(rasterize_tiled_hybrid) runs the k-capped blend everywhere and recomposites
with the CSR blend only the tiles whose truncation is harmful.

The reference's static-shape devices that change no output are not ported:
the visible-prefix buckets (a lax.switch over prefix lengths) become one
slice to the visible count, and the CSR entry-budget ladder becomes an
allocation of the real entry count; each costs one host sync. The exactness
budget min(4N, _ENTRY_CAP) and its fallbacks are kept: the callers learn of
an overflow on the host and take the fallback in place of lax.cond.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from activesplat_tpu_torch.ops.raster_cuda import (
    BAND_COL,
    BIN_BLOCK,
    BIN_MAX_BLOCKS,
    BIN_MAX_TILES,
    CSEG,
    LOG_EPS,
    N_ATTR,
    SEG,
    TILE,
    _pixel_coords,
    bin_count,
    bin_slots,
    blend_csr,
    blend_csr_dual_fwd,
    blend_tiles,
    gather_rows_bwd,
)
from activesplat_tpu_torch.ops.raster_xla import ALPHA_MAX, ALPHA_MIN
from activesplat_tpu_torch.utils import tracing
from activesplat_tpu_torch.utils.tracing import host_value, stage

# The bin kernel route (B6): read once at import, as the reference reads it
# (raster_tiled.py:41-47); bin_gaussians(use_kernel=...) overrides it per
# call. Set ACTIVESPLAT_BIN_KERNEL=1 before the process starts.
_BIN_KERNEL = os.environ.get("ACTIVESPLAT_BIN_KERNEL", "0") == "1"

# harmful-drop threshold: overflow counts only in tiles with > 2% end-of-list
# transmittance left at some pixel
_SATURATED_LOG_T = float(np.log(0.02))

# ceiling on the CSR entry budget min(4N, _ENTRY_CAP): memberships past it
# are dropped at Gaussian granularity and the callers fall back
_ENTRY_CAP = 1 << 23


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
    slot_offset: int = 0,
    use_kernel: Optional[bool] = None,
) -> TileLists:
    """Fixed-capacity per-tile lists: the members at list positions
    [slot_offset, slot_offset + k) of each tile in depth order (the window
    pass p of the multi-pass walk reads, offset p*k), their count, and the
    count past the window.

    Two routes give the same lists. The kernel route (B6) runs when
    `use_kernel` (None: the import-time ACTIVESPLAT_BIN_KERNEL switch) is
    set and the reference's static gate holds (k a multiple of 128, at most
    BIN_MAX_BLOCKS blocks of 128 Gaussians), with at most BIN_MAX_TILES
    tiles a side, as the packed words hold: per-(block, tile) member counts
    and packed AABB words from bin_count, their cumsum over blocks, and the
    members written into their slots by bin_slots. No host sync.
    Otherwise the sort route: each membership becomes a (tile, depth rank)
    pair, sorted by tile. One host sync (the number of pairs)."""
    n = mean2d.shape[0]
    dev = mean2d.device
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    t = tiles_x * tiles_y
    valid, tx0, tx1, ty0, ty1 = tile_aabbs(
        mean2d[:, 0], mean2d[:, 1], radius, valid, tiles_x, tiles_y
    )
    nb = -(-n // BIN_BLOCK)
    if (
        k_per_tile % BIN_BLOCK == 0
        and nb <= BIN_MAX_BLOCKS
        and tiles_x <= BIN_MAX_TILES
        and tiles_y <= BIN_MAX_TILES
        and (_BIN_KERNEL if use_kernel is None else use_kernel)
    ):
        return _bin_kernel_route(valid, tx0, tx1, ty0, ty1, tiles_x, tiles_y, k_per_tile, slot_offset)
    tx0, tx1, ty0, ty1 = (x.to(torch.int64) for x in (tx0, tx1, ty0, ty1))
    span_x = tx1 - tx0 + 1
    n_tiles = torch.where(valid, span_x * (ty1 - ty0 + 1), 0)

    # one (tile, rank) pair per membership; ranks ascend within each
    # Gaussian's run, so a stable sort by tile keeps depth order per tile
    ids = torch.repeat_interleave(
        torch.arange(n, device=dev), n_tiles, output_size=host_value(n_tiles.sum())
    )
    first = torch.cumsum(n_tiles, 0) - n_tiles
    local = torch.arange(ids.shape[0], device=dev) - first[ids]
    tile = (ty0[ids] + local // span_x[ids]) * tiles_x + tx0[ids] + local % span_x[ids]
    tile, perm = torch.sort(tile, stable=True)
    ids = ids[perm]

    count_full = torch.bincount(tile, minlength=t)
    start = torch.cumsum(count_full, 0) - count_full
    slot = torch.arange(tile.shape[0], device=dev) - start[tile] - slot_offset
    keep = (slot >= 0) & (slot < k_per_tile)
    indices = torch.full((t * k_per_tile + 1,), n, dtype=torch.int64, device=dev)
    dest = torch.where(keep, tile * k_per_tile + slot, t * k_per_tile)
    indices[dest] = ids  # entries outside the window land in the spare last cell
    return _lists(indices[:-1].view(t, k_per_tile), count_full, k_per_tile, slot_offset)


def _lists(indices, count_full, k_per_tile, slot_offset) -> TileLists:
    rest = count_full - slot_offset
    return TileLists(
        indices=indices,
        count=torch.clamp(rest, 0, k_per_tile).to(torch.int32),
        overflow=torch.clamp(rest - k_per_tile, min=0).to(torch.int32),
    )


def _bin_kernel_route(valid, tx0, tx1, ty0, ty1, tiles_x, tiles_y, k_per_tile, slot_offset):
    """bin_gaussians through B6 (see there): the count pass, the cumsum of
    its counts over blocks in the reference's (nb, T) layout
    (raster_tiled.py:169), and the slot pass. No host sync."""
    words, counts = bin_count(valid, tx0, tx1, ty0, ty1, tiles_x, tiles_y)
    cum_t = torch.cumsum(counts, 0, dtype=torch.int32)
    indices = bin_slots(cum_t, words, k_per_tile, slot_offset, tiles_x, valid.shape[0])
    return _lists(indices, cum_t[-1], k_per_tile, slot_offset)


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


@stage("render/prepare")
def _prepare(mean2d, conic, opacity, colors, valid, radius, depth):
    """The attribute table (N, 6 + C), the packed depth sort and the visible
    count b: visible Gaussians form a prefix of the sorted order (one host
    sync; the reference switches over static prefix buckets)."""
    c_dim = colors.shape[1]
    if c_dim > 8:
        raise ValueError(f"the tile blend supports at most 8 channels, got {c_dim}")
    key = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    data = torch.cat([mean2d, conic, opacity[:, None], colors], -1)  # (N, 6 + C)
    packed, order = _sort_pack(data, key, radius, valid)
    return data, packed, order, max(host_value(valid.sum()), 1)


def _pad_table(data):
    """The attribute table with the padding row (index N) appended:
    off-screen mean, unit conic, zero opacity and colours."""
    dev = data.device
    pad_row = torch.cat(
        [
            torch.full((1, 2), -1e9, dtype=data.dtype, device=dev),
            torch.ones((1, 3), dtype=data.dtype, device=dev),
            torch.zeros((1, data.shape[1] - 5), dtype=data.dtype, device=dev),
        ],
        -1,
    )
    return torch.cat([data, pad_row], 0)  # (N+1, 6+C)


class _GatherRows(torch.autograd.Function):
    """table[ids] for an (N+1)-row table whose row N pads the lists. The
    backward is gather_rows_bwd (ops/raster_cuda.py) inside a
    render/gather_bwd stage: on the card the hand-written kernel, which
    leaves row N zero without reading its run (the caller's torch.cat drops
    that row's gradient); on the CPU autograd's own index backward, the
    sorted scatter-add into zeros (`_index_put_impl_` with unsafe=True,
    which skips the range check that `index_put_` makes by reading the ids'
    min and max on the host). While the span log records, the backward
    attaches to that span the gathered rows, the rows equal to N (those
    the kernel skips; a device reduction, read with the log), the table's
    rows, its live columns and the device time between two CUDA events at
    its ends, the ids' sort included."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        n_rows, width = ctx.table_shape
        with stage("render/gather_bwd"):
            logged = tracing.recording()
            if logged and grad.is_cuda:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            table_grad = gather_rows_bwd(grad, ids, n_rows)
            if logged:
                if grad.is_cuda:
                    events[1].record()
                    tracing.attach(device_us=events)
                tracing.attach(rows=ids.numel(), pad_rows=(ids == n_rows - 1).sum(),
                               table_rows=n_rows, width=width)
        return table_grad, None


def _gather_rows(data, ids):
    """The rows `ids` of `data` with its padding row appended (id N), in
    the kernels' 16 columns: a narrow gather of the live columns (its
    backward scatter-add then moves only those), padded after."""
    with stage("render/gather"):
        return F.pad(_GatherRows.apply(_pad_table(data), ids), (0, N_ATTR - data.shape[1]))


def _window_rows(packed, order, data, *, width, height, k_per_tile, slot_offset=0):
    """Bin and gather one k-window of every tile's list: (tile_data (T, K',
    16) with K' = k rounded up to a SEG multiple, tile_u0, tile_v0 (T,) int32,
    overflow (T,)). `packed` is the visible prefix of the sorted order."""
    n = data.shape[0]
    b = packed.shape[0]
    with stage("render/bin"):
        lists = bin_gaussians(
            packed[:, :2], packed[:, 2], packed[:, 3] > 0, width, height, k_per_tile, slot_offset
        )
        # sorted-order list entries -> original Gaussian ids; bin padding (b)
        # becomes the blend padding row (n)
        global_ids = torch.where(
            lists.indices >= b, n, order[torch.clamp(lists.indices, max=n - 1)]
        )
        # the blend walks SEG-row segments: pad each list with padding rows
        if k_per_tile % SEG:
            global_ids = F.pad(global_ids, (0, SEG - k_per_tile % SEG), value=n)
    tile_data = _gather_rows(data, global_ids)

    tiles_x = -(-width // TILE)
    tile_ids = torch.arange(global_ids.shape[0], dtype=torch.int32, device=data.device)
    tile_u0 = (tile_ids % tiles_x) * TILE
    tile_v0 = torch.div(tile_ids, tiles_x, rounding_mode="floor") * TILE
    return tile_data, tile_u0, tile_v0, lists.overflow


def tile_rows(
    mean2d, conic, opacity, colors, valid, radius, depth,
    *, width: int, height: int, k_per_tile: int,
):
    """Sort, bin and gather: the blend kernels' inputs for one render.

    Returns (tile_data (T, K', 16) with K' = the list capacity rounded up to
    a SEG multiple, tile_u0 (T,) int32, tile_v0 (T,) int32, overflow (T,)).
    tile_data is differentiable in the per-Gaussian inputs (through the row
    gather); the lists themselves are not."""
    data, packed, order, b = _prepare(mean2d, conic, opacity, colors, valid, radius, depth)
    return _window_rows(
        packed[:b], order, data, width=width, height=height, k_per_tile=min(k_per_tile, b)
    )


def blend_tiles_xla(tile_data, tile_u0, tile_v0, n_channels=5):
    """The reference's XLA tile blend (_blend_tile, raster_tiled.py:289-318)
    in plain PyTorch, differentiable by autograd: every row of every tile
    composited at once, with no early exit. Returns (accum (T, PX, C),
    log_transmittance (T, PX))."""
    px, py = _pixel_coords(tile_u0, tile_v0)  # (T, PX)
    dx = tile_data[:, :, 0:1] - px[:, None, :]  # (T, K, PX)
    dy = tile_data[:, :, 1:2] - py[:, None, :]
    ca, cb, cc, op = (tile_data[:, :, i : i + 1] for i in range(2, 6))
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
    alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha, torch.zeros_like(alpha))
    logs = torch.log1p(-alpha)
    cum = torch.cumsum(logs, dim=1)
    weight = alpha * torch.exp(cum - logs)
    accum = torch.einsum("tkp,tkc->tpc", weight, tile_data[:, :, 6 : 6 + n_channels])
    return accum, cum[:, -1]


def _capped_tiles(data, packed, order, b, *, width, height, k_per_tile, max_passes=1,
                  xla_blend=False):
    """The k-capped blend of every tile, with up to max_passes k-windows:
    (accum_t (T, PX, C), logt_t (T, PX), overflow (T,) of the last window).
    xla_blend blends in blend_tiles_xla in place of B1/B2."""
    k = min(k_per_tile, b)
    blend = blend_tiles_xla if xla_blend else blend_tiles

    def blend_pass(slot_offset):
        rows, u0, v0, overflow = _window_rows(
            packed[:b], order, data, width=width, height=height, k_per_tile=k,
            slot_offset=slot_offset,
        )
        with stage("render/blend"):
            return (*blend(rows, u0, v0, data.shape[1] - 6), overflow)

    accum_t, logt_t, overflow = blend_pass(0)
    # Exact compositing: walk farther k-windows until every overflowing tile
    # saturates or exhausts (one host sync per pass). Front-to-back blending
    # is associative, total = accum_1 + T_1 accum_2 + T_1 T_2 accum_3 ..., so
    # each pass folds in with one multiply-add.
    for p in range(1, max_passes):
        unsat = logt_t.detach().amax(dim=1) > _SATURATED_LOG_T
        if not host_value(((overflow > 0) & unsat).any()):
            break
        accum_p, logt_p, overflow = blend_pass(p * k)
        accum_t = accum_t + torch.exp(logt_t)[:, :, None] * accum_p
        logt_t = logt_t + logt_p
    return accum_t, logt_t, overflow


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
    max_passes: int = 1,
    xla_blend: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tile-binned front-to-back compositing of each tile's nearest
    k_per_tile members, differentiable through the tile blend.

    Returns (accum (H*W, C), log_transmittance (H*W,), dropped ()).
    `dropped` counts HARMFUL truncations: memberships cut by the k cap in
    tiles that did not saturate (some pixel's end-of-list transmittance
    > 2%). max_passes > 1 composites farther k-windows until every tile
    saturates or exhausts: exact, like the uncapped reference, for
    forward-only renders. xla_blend=True blends in blend_tiles_xla (the
    reference's XLA blend: autograd, no early exit) in place of B1/B2."""
    data, packed, order, b = _prepare(mean2d, conic, opacity, colors, valid, radius, depth)
    accum_t, logt_t, overflow = _capped_tiles(
        data, packed, order, b, width=width, height=height, k_per_tile=k_per_tile,
        max_passes=max_passes, xla_blend=xla_blend,
    )
    return (*_to_images(accum_t, logt_t, width, height), _harmful(logt_t, overflow))


def _harmful(logt_t, overflow):
    """Memberships cut in tiles with > 2% end-of-list transmittance left."""
    unsaturated = logt_t.detach().amax(dim=1) > _SATURATED_LOG_T
    return torch.where(unsaturated, overflow, 0).sum(dtype=torch.int32)


def _to_images(accum_t, logt_t, width, height):
    """Tile blocks -> (accum (H*W, C), log_transmittance (H*W,))."""
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    accum_img, logt_img = _tiles_to_image(accum_t, logt_t, tiles_x, tiles_y, width, height)
    return accum_img.reshape(height * width, -1), logt_img.reshape(height * width)


# --------------------------------------------------------------------------- #
# Exact (uncapped) compositing over CSR runs
# --------------------------------------------------------------------------- #


class CSRLayout(NamedTuple):
    global_ids: torch.Tensor  # (E,) int64 — original Gaussian id per entry row; N = padding
    seg_tile: torch.Tensor  # (E/CSEG,) int32 — each segment's tile
    seg_u0: torch.Tensor  # (E/CSEG,) int32 — each segment's tile origin
    seg_v0: torch.Tensor
    dropped: int  # memberships past the entry budget


@stage("render/csr_layout")
def _csr_layout(packed, order, n, tiles_x, tiles_y, harm=None) -> CSRLayout:
    """Every (Gaussian, tile) membership of the visible prefix `packed`, as
    CSR runs: each tile's members in depth order, padded with padding rows
    to a CSEG multiple, runs in tile order.

    The entry budget is min(4N, _ENTRY_CAP) rounded up to CSEG, cut at
    Gaussian granularity as the reference cuts it: a Gaussian is expanded
    only if all its memberships fit, and `dropped` counts the rest.

    With `harm` (T,) bool, only Gaussians whose rectangle covers a harmful
    tile spend budget (their whole rectangle), and only their harmful
    memberships become entries: each harmful tile's run is complete.

    Three host syncs (two without `harm`): the entry totals, the harmful
    entry count and the segment count."""
    t = tiles_x * tiles_y
    dev = packed.device
    valid, tx0, tx1, ty0, ty1 = tile_aabbs(
        packed[:, 0], packed[:, 1], packed[:, 2], packed[:, 3] > 0, tiles_x, tiles_y
    )
    tx0, tx1, ty0, ty1 = (x.to(torch.int64) for x in (tx0, tx1, ty0, ty1))
    span_x = tx1 - tx0 + 1
    if harm is not None:
        # harmful tiles under each rectangle, from the grid's 2-D prefix sums
        grid = F.pad(harm.view(tiles_y, tiles_x).to(torch.int64).cumsum(0).cumsum(1), (1, 0, 1, 0))
        covered = grid[ty1 + 1, tx1 + 1] - grid[ty0, tx1 + 1] - grid[ty1 + 1, tx0] + grid[ty0, tx0]
        valid = valid & (covered > 0)
    span = torch.where(valid, span_x * (ty1 - ty0 + 1), 0)
    g_end = torch.cumsum(span, 0)
    budget = -(-max(min(4 * n, _ENTRY_CAP), CSEG) // CSEG) * CSEG
    kept = g_end <= budget
    m_total, m_kept = host_value(torch.stack([g_end[-1], torch.where(kept, g_end, 0).max()]))

    ids = torch.repeat_interleave(
        torch.arange(packed.shape[0], device=dev), torch.where(kept, span, 0), output_size=m_kept
    )
    local = torch.arange(m_kept, device=dev) - (g_end - span)[ids]
    tile = (ty0[ids] + local // span_x[ids]) * tiles_x + tx0[ids] + local % span_x[ids]
    if harm is not None:
        keep = harm[tile]
        tile, ids = tile[keep], ids[keep]
    # ranks ascend in depth order within each tile: a stable sort by tile
    # keeps each tile's members depth-ordered
    tile, perm = torch.sort(tile, stable=True)
    count = torch.bincount(tile, minlength=t)
    seg_count = torch.div(count + CSEG - 1, CSEG, rounding_mode="floor")
    seg_end = torch.cumsum(seg_count, 0)
    n_seg = host_value(seg_end[-1])
    rank = torch.arange(tile.shape[0], device=dev) - (torch.cumsum(count, 0) - count)[tile]
    global_ids = torch.full((n_seg * CSEG,), n, dtype=torch.int64, device=dev)
    global_ids[(seg_end - seg_count)[tile] * CSEG + rank] = order[ids[perm]]
    seg_tile = torch.repeat_interleave(
        torch.arange(t, dtype=torch.int32, device=dev), seg_count, output_size=n_seg
    )
    return CSRLayout(
        global_ids=global_ids,
        seg_tile=seg_tile,
        seg_u0=(seg_tile % tiles_x) * TILE,
        seg_v0=torch.div(seg_tile, tiles_x, rounding_mode="floor") * TILE,
        dropped=m_total - m_kept,
    )


def _entry_rows(layout: CSRLayout, data):
    """The (E, 16) entry rows of a layout (_gather_rows)."""
    return _gather_rows(data, layout.global_ids)


def _csr_blend(layout: CSRLayout, data, t):
    """Gather the entry rows and blend them: (accum_t (T, PX, C), logt_t
    (T, PX)), zeros in tiles with no entry. Differentiable in `data` when it
    requires a gradient (B3 with the stash, B4 in the backward)."""
    rows = _entry_rows(layout, data)
    with stage("render/csr_blend"):
        return blend_csr(rows, layout.seg_tile, layout.seg_u0, layout.seg_v0, t, data.shape[1] - 6)


def csr_rows(mean2d, conic, opacity, colors, valid, radius, depth, *, width: int, height: int):
    """Sort, expand and gather: the CSR blend kernels' inputs for one exact
    render. Returns (entry_data (E, 16), seg_tile, seg_u0, seg_v0 (E/CSEG,)
    int32, dropped (host int))."""
    data, packed, order, b = _prepare(mean2d, conic, opacity, colors, valid, radius, depth)
    layout = _csr_layout(packed[:b], order, data.shape[0], -(-width // TILE), -(-height // TILE))
    return _entry_rows(layout, data), layout.seg_tile, layout.seg_u0, layout.seg_v0, layout.dropped


def rasterize_tiled_exact(
    mean2d: torch.Tensor,  # (N, 2) UNSORTED (projection order)
    conic: torch.Tensor,
    opacity: torch.Tensor,
    colors: torch.Tensor,  # (N, C)
    valid: torch.Tensor,
    radius: torch.Tensor,
    depth: torch.Tensor,  # (N,)
    band: Optional[torch.Tensor] = None,
    *,
    width: int,
    height: int,
    differentiable: bool = False,
):
    """Exact (uncapped) tile compositing over CSR runs: the duplicate-and-
    sort semantics of the CUDA reference, work O(total memberships).

    Returns (accum (H*W, C), log_transmittance (H*W,), dropped) where
    `dropped` (a host int) counts memberships past the entry budget
    min(4N, _ENTRY_CAP); the image then composites only the Gaussians
    before the cut, and callers fall back (render_projected). Forward-only
    unless differentiable=True; the binning geometry carries no gradient
    either way, only the gathered attribute rows do.

    `band` (N,) bool (forward-only, C <= 8) selects the dual-transmittance
    walk (kernel B5): the band bit rides in column BAND_COL of the entry
    rows, and a third output, the log-transmittance composited over the
    alphas of the band's Gaussians only, is bitwise what a band-only render
    gives in the same entry order. The return is then (accum, log_t,
    log_t_band, dropped); one expansion, sort, gather and walk serve both
    top-down maps."""
    if band is not None and differentiable:
        raise ValueError("the dual-transmittance walk is forward-only")
    if not differentiable:
        mean2d, conic, opacity, colors = (x.detach() for x in (mean2d, conic, opacity, colors))
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    data, packed, order, b = _prepare(mean2d, conic, opacity, colors, valid, radius, depth)
    layout = _csr_layout(packed[:b], order, data.shape[0], tiles_x, tiles_y)
    if band is None:
        accum_t, logt_t = _csr_blend(layout, data, tiles_x * tiles_y)
        return (*_to_images(accum_t, logt_t, width, height), layout.dropped)
    c_dim = colors.shape[1]
    if c_dim > BAND_COL - 6:
        raise ValueError(f"the dual walk carries at most {BAND_COL - 6} channels, got {c_dim}")
    n = data.shape[0]
    data = torch.cat(
        [data, data.new_zeros((n, BAND_COL - data.shape[1])), band.to(data.dtype)[:, None]], -1
    )  # colours at 6:6+C, the band bit at BAND_COL
    rows = _entry_rows(layout, data)
    with stage("render/csr_blend"):
        accum_t, logt_t, logt_band_t = blend_csr_dual_fwd(
            rows, layout.seg_tile, layout.seg_u0, layout.seg_v0, tiles_x * tiles_y, c_dim
        )
    accum, logt = _to_images(accum_t, logt_t, width, height)
    return accum, logt, _to_images(accum_t, logt_band_t, width, height)[1], layout.dropped


def rasterize_tiled_hybrid(
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
    xla_blend: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Exact differentiable compositing at capped + O(harmful memberships)
    cost: the k-capped blend runs for every tile; tiles that overflow the cap
    while their end-of-list transmittance is still above the blends' LOG_EPS
    exit (the harmful tiles) are recomposited with the CSR blend, and a
    per-tile select routes each tile's cotangent to the branch that made it.

    Returns (accum (H*W, C), log_transmittance (H*W,), dropped (),
    csr_overflow). `dropped` is the capped pass's harmful-truncation
    telemetry. `csr_overflow` (a host int) > 0 means the harmful expansion
    passed the entry budget: the result is then the k-capped render (the
    reference's fallback, taken here without a second render, since the
    capped pass is the same computation). One sort serves both halves; no
    CSR launch when no tile is harmful. The running totals
    `tracing.counter("hybrid.calls")` and `tracing.counter(
    "hybrid.harmful_tiles")` count calls and harmful tiles.
    xla_blend=True blends the capped half in blend_tiles_xla, as the
    reference's hybrid does with its XLA backend; the CSR half is B3/B4
    either way."""
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    data, packed, order, b = _prepare(mean2d, conic, opacity, colors, valid, radius, depth)
    accum_t, logt_t, overflow = _capped_tiles(
        data, packed, order, b, width=width, height=height, k_per_tile=k_per_tile,
        xla_blend=xla_blend,
    )
    with stage("render/harmful"):
        dropped = _harmful(logt_t, overflow)
        harm = (overflow > 0) & (logt_t.detach().amax(dim=1) > LOG_EPS)
        n_harm = host_value(harm.sum())
        tracing.count("hybrid.calls")
        tracing.count("hybrid.harmful_tiles", n_harm)
    csr_overflow = 0
    if n_harm:
        layout = _csr_layout(packed[:b], order, data.shape[0], tiles_x, tiles_y, harm)
        csr_overflow = layout.dropped
        if csr_overflow == 0:
            csr_accum, csr_logt = _csr_blend(layout, data, tiles_x * tiles_y)
            accum_t = torch.where(harm[:, None, None], csr_accum, accum_t)
            logt_t = torch.where(harm[:, None], csr_logt, logt_t)
    return (*_to_images(accum_t, logt_t, width, height), dropped, csr_overflow)


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
