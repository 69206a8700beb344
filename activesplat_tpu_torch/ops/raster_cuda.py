"""The blends and the bin's slot search: hand-written CUDA kernels, their
plain PyTorch twins, and the autograd Functions that pair the blends
(counterpart of activesplat_tpu/ops/raster_pallas.py, kernels B1-B6).

Tile blend (B1, B2): a tile's K depth-ordered Gaussians arrive as (K, 16)
float32 rows [mx, my, a, b, c, opacity, col0..col7, pad, pad]; the forward
composites them front to back over the tile's 16x16 pixels, in SEG=64-row
segments, and stops walking a tile once every pixel's log-transmittance is
below LOG_EPS (tested at each segment start). B1 launches two passes from
one C call: every segment composited by itself from transmittance 1 (one
block per tile segment, rank-major), then a per-tile combine (B3's);
tile_fwd_partials_plain and tile_fwd_combine_plain are the passes' plain
versions. The backward takes each
segment from the forward's stashed per-segment entry log-transmittance
and the suffix carry of the segments behind it. B2 launches two passes:
every segment's own suffix total (one block per tile segment), then each
segment walked from the fold of the later segments' totals (one block per
tile segment); tile_bwd_suffix_plain and tile_bwd_walk_plain are the
passes' plain versions.

CSR blend (B3, B4): the same over each tile's whole list, the lists of all
tiles concatenated as (E, 16) rows with each tile's run padded to a
CSEG=256 multiple, the exit tested at each 256-row segment start. B4
launches two passes over the N_PIECES=4 64-row pieces of every segment:
each piece's log step and total from transmittance 1 (one block per piece),
then each piece of a walked segment walked from the fold of its tile's
later totals (one block per piece), B2's walk written once in
csrc/blend_bwd_walk.cuh; csr_bwd_pieces_plain and csr_bwd_walk_plain are
the passes' plain versions.

Dual CSR blend (B5, forward only): B3's walk carrying a second
log-transmittance composited over the alphas masked by the band bit in
column BAND_COL=14; the exit tests the band carry alone.

B3 and B5 launch two passes written once in csrc/blend_csr_walk.cuh:
every segment composited by itself from transmittance 1 (one block per
segment), then a per-tile combine that walks the segments' partials in
order with the exit test; csr_partials_plain and csr_combine_plain are the
passes' plain versions.

Bin (B6, the k-capped bin's kernel route, ops/raster_tiled.py): two
kernels in csrc/bin_slots.cu with torch.cumsum between them. bin_count:
one packed AABB word per Gaussian and each 128-Gaussian block's member
count in every tile, (nb, T); bin_slots: from their inclusive cumsum over
blocks, each tile's depth-ordered member ids at list positions [off, off +
K), one block per 128-Gaussian block writing its members into their slots.
bin_count_plain and bin_slots_plain are their plain versions.

Gather backward (ops/raster_tiled.py's row gathers, no TPU kernel: the
JAX package leaves it to XLA): gather_rows_bwd sums each table row's
gathered gradient rows in position order, one thread per table element,
over the runs of a stable sort of the ids (gather_bwd_runs, plain PyTorch
on the device); the padding row's run is never read. Its CPU path is
autograd's own index backward, `_index_put_impl_`.

Each wrapper launches its CUDA kernel (csrc/blend_fwd.cu, blend_bwd.cu,
blend_csr_fwd.cu, blend_csr_bwd.cu, blend_csr_dual.cu, bin_slots.cu,
gather_bwd.cu) for a CUDA tensor, or raises; it runs its
twin only for a tensor that lies on the CPU. The twins run the same
algorithm in float32: the same segments, early exit and clamps, with a
vectorised in-segment cumsum. The backward twins are the explicit analytic
formula, not autograd. Each wrapper counts its launches in
`<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from activesplat_tpu_torch import _build
from activesplat_tpu_torch.ops.raster_xla import ALPHA_MAX, ALPHA_MIN

TILE = 16
PX = TILE * TILE  # 256 pixels per tile
SEG = 64  # rows per segment of the dense blend
CSEG = 256  # rows per segment of the CSR blend (each tile's run is CSEG-aligned)
N_PIECES = CSEG // SEG  # 64-row pieces of a CSR segment (B4's blocks)
N_ATTR = 16  # padded attribute count
ALL_WARPS = (1 << (PX // 32)) - 1  # a row's warp reach mask (B1): a bit per warp of a tile
MAX_CHANNELS = 8
BAND_COL = 14  # padding column of a CSR entry row carrying the band bit (B5)
LOG_EPS = -5.55  # log(1/256): tile saturated below this transmittance
BIN_BLOCK = 128  # Gaussians per block of the bin's counting front (B6)
BIN_MAX_BLOCKS = 4096  # the bin kernel route's gate (the reference's)
BIN_MAX_TILES = 256  # tile columns and rows a packed word's bytes hold

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check_rows(tile_data, tile_u0, tile_v0, n_channels):
    if tile_data.dtype != torch.float32 or tile_data.dim() != 3:
        raise ValueError(f"tile rows must be (T, K, 16) float32, got {tile_data.shape}")
    t, k, n_attr = tile_data.shape
    if n_attr != N_ATTR or k % SEG != 0:
        raise ValueError(f"tile rows need K % {SEG} == 0 and 16 columns: {tile_data.shape}")
    if not 1 <= n_channels <= MAX_CHANNELS:
        raise ValueError(f"n_channels must be in [1, 8], got {n_channels}")
    for origin in (tile_u0, tile_v0):
        if origin.dtype != torch.int32 or origin.shape != (t,):
            raise ValueError("tile origins must be (T,) int32")
        if origin.device != tile_data.device:
            raise ValueError("tile origins must lie on the rows' device")


def _cuda_args(*tensors):
    """Device pointers for the C interface; every tensor must be a
    contiguous, 16-byte aligned CUDA tensor."""
    ptrs = []
    for x in tensors:
        if x.device.type != "cuda" or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("kernel inputs must be contiguous, aligned CUDA tensors")
        ptrs.append(x.data_ptr())
    return ptrs


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tile blend runs on cuda or (plain) cpu, not {x.device}")
    return x.device.type


# --------------------------------------------------------------------------- #
# Plain PyTorch twins
# --------------------------------------------------------------------------- #


def _pixel_coords(tile_u0, tile_v0):
    local = torch.arange(PX, device=tile_u0.device)
    px = (tile_u0[:, None] + local % TILE).to(torch.float32)  # (T, PX)
    py = (tile_v0[:, None] + local // TILE).to(torch.float32)
    return px, py


def _segment_geometry(block, px, py):
    """(T, SEG, 16) rows x (T, PX) pixels -> the per-(row, pixel) terms."""
    ca, cb, cc, op = (block[:, :, i : i + 1] for i in range(2, 6))
    dx = block[:, :, 0:1] - px[:, None, :]  # (T, SEG, PX)
    dy = block[:, :, 1:2] - py[:, None, :]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    raw = op * torch.exp(power)
    alpha = torch.clamp(raw, max=ALPHA_MAX)
    live = (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    return dx, dy, power, raw, alpha, live


def _blend_segment(block, px, py, logt):
    """The front-to-back composite of one segment of rows (T, S, 16) over
    entry log-transmittances logt (T, PX): (alpha (T, S, PX), colour
    contribution (T, PX, 8), the segment's log-transmittance (T, PX))."""
    alpha = _segment_geometry(block, px, py)[4]
    logs = torch.log1p(-alpha)
    cum = torch.cumsum(logs, dim=1)
    weight = alpha * torch.exp(cum - logs + logt[:, None, :])  # (T, S, PX)
    contrib = torch.einsum("tsp,tsc->tpc", weight, block[:, :, 6 : 6 + MAX_CHANNELS])
    return alpha, contrib, cum[:, -1]


def _fwd_segment(block, px, py, accum, logt):
    """One segment of rows (T, S, 16) for a batch of T tiles: (accum, logt)
    after it. A tile whose max logT is already below LOG_EPS is left as it
    is (the early exit)."""
    walk = logt.amax(dim=1) >= LOG_EPS  # (T,) tile not yet saturated
    _, contrib, seg_logt = _blend_segment(block, px, py, logt)
    return (
        torch.where(walk[:, None, None], accum + contrib, accum),
        torch.where(walk[:, None], logt + seg_logt, logt),
    )


def _dual_segment(block, px, py, accum, logt, logt_band):
    """One segment through the dual walk: (accum, logt, logt_band) after it.
    The band carry composites alpha * band, the band bit read from column
    BAND_COL. A tile whose max band logT is below LOG_EPS is left as it is:
    band alpha <= alpha, so band saturation implies full saturation, and
    the full composite walks on past its own saturation until then."""
    walk = logt_band.amax(dim=1) >= LOG_EPS
    alpha, contrib, seg_logt = _blend_segment(block, px, py, logt)
    band = block[:, :, BAND_COL : BAND_COL + 1]  # (T, S, 1) 0/1
    seg_band = torch.cumsum(torch.log1p(-alpha * band), dim=1)[:, -1]
    return (
        torch.where(walk[:, None, None], accum + contrib, accum),
        torch.where(walk[:, None], logt + seg_logt, logt),
        torch.where(walk[:, None], logt_band + seg_band, logt_band),
    )


def _bwd_segment(block, px, py, logt_in, g, g_logt, b, walk=None, total=None):
    """The analytic backward of one segment of rows (T, S, 16), given its
    entry logT (T, PX), the padded colour cotangent g (T, PX, 8), the logT
    cotangent (T, PX) and the suffix carry b (T, PX) of the rows behind it.
    Returns (d_block (T, S, 14), the carry in front of the segment); a
    segment the forward skipped gets zero rows and leaves the carry. By
    default a segment is skipped when its own entry logT is below LOG_EPS at
    every pixel and the suffix behind row k is b + (sum_j ws_j - inclusive
    sum); `walk` (T,) bool and `total` (T, PX) replace the decision and the
    sum (B4's pieces: the decision is their segment's, the total pass 1's)."""
    if walk is None:
        walk = logt_in.amax(dim=1) >= LOG_EPS
    ca, cb, cc = (block[:, :, i : i + 1] for i in range(2, 5))
    dx, dy, power, raw, alpha, live = _segment_geometry(block, px, py)
    unclipped = live & (raw < ALPHA_MAX)
    logs = torch.log1p(-alpha)
    prefix = torch.cumsum(logs, dim=1) - logs
    t_k = torch.exp(logt_in[:, None, :] + prefix)  # (T, S, PX)
    s_k = torch.einsum("tsc,tpc->tsp", block[:, :, 6 : 6 + MAX_CHANNELS], g)
    w = alpha * t_k
    ws = w * s_k
    ws_sum = ws.sum(dim=1)
    if total is None:
        total = ws_sum
    # exclusive suffix sum: total - inclusive prefix
    b_k = b[:, None, :] + (total[:, None, :] - torch.cumsum(ws, dim=1))
    one_minus = torch.clamp(1.0 - alpha, min=1.0 / 256.0)
    d_alpha = t_k * s_k - (b_k + g_logt[:, None, :]) / one_minus
    d_alpha = torch.where(alpha > 0.0, d_alpha, torch.zeros_like(d_alpha))
    d_col = torch.einsum("tsp,tpc->tsc", w, g)
    d_raw = torch.where(unclipped, d_alpha, torch.zeros_like(d_alpha))
    d_power = d_raw * alpha  # alpha == raw where unclipped
    exp_power = torch.exp(torch.where(unclipped, power, torch.zeros_like(power)))
    d_block = torch.cat(
        [
            (d_power * (-(ca * dx + cb * dy))).sum(dim=2, keepdim=True),
            (d_power * (-(cc * dy + cb * dx))).sum(dim=2, keepdim=True),
            (d_power * (-0.5 * dx * dx)).sum(dim=2, keepdim=True),
            (d_power * (-dx * dy)).sum(dim=2, keepdim=True),
            (d_power * (-0.5 * dy * dy)).sum(dim=2, keepdim=True),
            (d_raw * exp_power).sum(dim=2, keepdim=True),
            d_col,
        ],
        dim=2,
    )  # (T, S, 14)
    return (
        torch.where(walk[:, None, None], d_block, torch.zeros_like(d_block)),
        torch.where(walk[:, None], b + ws_sum, b),
    )


def blend_tiles_fwd_plain(tile_data, tile_u0, tile_v0, n_channels=5, with_entry=False):
    """The forward kernel's algorithm in PyTorch (the CPU path)."""
    t, k, _ = tile_data.shape
    px, py = _pixel_coords(tile_u0, tile_v0)
    accum = tile_data.new_zeros((t, PX, MAX_CHANNELS))
    logt = tile_data.new_zeros((t, PX))
    entries = []
    for s in range(k // SEG):
        entries.append(logt)
        accum, logt = _fwd_segment(tile_data[:, s * SEG : (s + 1) * SEG], px, py, accum, logt)
    accum = accum[:, :, :n_channels].contiguous()
    if with_entry:
        return accum, logt, torch.stack(entries, dim=1)
    return accum, logt


def tile_fwd_partials_plain(tile_data, tile_u0, tile_v0, n_channels=5):
    """Pass 1 of B1 in PyTorch: every segment composited by itself from
    transmittance 1 (`_blend_segment` with logT 0). Returns (T, K/SEG, PX,
    C + 1): per pixel the colour partial sum_j alpha_j exp(excl_j) col_j and
    the log step sum_j log1p(-alpha_j)."""
    t, k, _ = tile_data.shape
    px, py = _pixel_coords(tile_u0, tile_v0)
    zero = tile_data.new_zeros((t, PX))
    out = tile_data.new_empty((t, k // SEG, PX, n_channels + 1))
    for s in range(k // SEG):
        _, contrib, step = _blend_segment(tile_data[:, s * SEG : (s + 1) * SEG], px, py, zero)
        out[:, s, :, :n_channels] = contrib[:, :, :n_channels]
        out[:, s, :, n_channels] = step
    return out


def tile_fwd_combine_plain(partials, n_channels=5, with_entry=False):
    """Pass 2 of B1 in PyTorch: each tile's segments in order from their
    partials (T, K/SEG, PX, C + 1). At each segment start the whole-tile exit
    (max logT < LOG_EPS), the stash takes the entry logT, then accum +=
    exp(logT) P and logT += L. Partials of segments after the exit are never
    used. Fed tile_fwd_partials_plain's partials, logT and the stash are
    blend_tiles_fwd_plain's bitwise. Returns (accum, logT[, entry])."""
    t, n_seg = partials.shape[:2]
    accum = partials.new_zeros((t, PX, n_channels))
    logt = partials.new_zeros((t, PX))
    entries = []
    for s in range(n_seg):
        entries.append(logt)
        walk = (logt.amax(dim=1) >= LOG_EPS)[:, None]
        q = partials[:, s]
        accum = torch.where(
            walk[:, :, None], accum + torch.exp(logt)[:, :, None] * q[:, :, :n_channels], accum
        )
        logt = torch.where(walk, logt + q[:, :, n_channels], logt)
    if with_entry:
        return accum, logt, torch.stack(entries, dim=1)
    return accum, logt


def blend_tiles_bwd_plain(tile_data, tile_u0, tile_v0, entry, g_accum, g_logt, n_channels=5):
    """The backward kernel's analytic formula in PyTorch (the CPU path)."""
    t, k, _ = tile_data.shape
    px, py = _pixel_coords(tile_u0, tile_v0)
    g = torch.nn.functional.pad(g_accum, (0, MAX_CHANNELS - n_channels))  # (T, PX, 8)
    b = tile_data.new_zeros((t, PX))
    d_rows = torch.zeros_like(tile_data)
    for s in reversed(range(k // SEG)):
        d_rows[:, s * SEG : (s + 1) * SEG, :14], b = _bwd_segment(
            tile_data[:, s * SEG : (s + 1) * SEG], px, py, entry[:, s], g, g_logt, b
        )
    return d_rows


def tile_bwd_suffix_plain(tile_data, tile_u0, tile_v0, entry, g_accum, n_channels=5):
    """Pass 1 of B2 in PyTorch: each segment's total S_s(p) = sum_j w_j s_j
    (the reference's per-segment sum of ws) from its stashed entry logT,
    `_bwd_segment` with carry 0, one segment at a time as the sequential
    twin runs it; 0 for a segment the forward skipped. (T, K/SEG, PX)."""
    t, k, _ = tile_data.shape
    px, py = _pixel_coords(tile_u0, tile_v0)
    g = torch.nn.functional.pad(g_accum, (0, MAX_CHANNELS - n_channels))
    zero = tile_data.new_zeros((t, PX))
    return torch.stack([
        _bwd_segment(tile_data[:, s * SEG : (s + 1) * SEG], px, py, entry[:, s], g, zero, zero)[1]
        for s in range(k // SEG)
    ], dim=1)


def tile_bwd_walk_plain(tile_data, tile_u0, tile_v0, entry, g_accum, g_logt, suffix,
                        n_channels=5):
    """Pass 2 of B2 in PyTorch: each segment's gradient rows from the carry
    b_in(s) = ((0 + S_{n-1}) + S_{n-2}) + ... + S_{s+1}, the fold of the
    later segments' totals `suffix` (T, K/SEG, PX) in the reference's order.
    Fed tile_bwd_suffix_plain's totals, bitwise blend_tiles_bwd_plain."""
    t, k, _ = tile_data.shape
    px, py = _pixel_coords(tile_u0, tile_v0)
    g = torch.nn.functional.pad(g_accum, (0, MAX_CHANNELS - n_channels))
    b = tile_data.new_zeros((t, PX))
    d_rows = torch.zeros_like(tile_data)
    for s in reversed(range(k // SEG)):
        d_rows[:, s * SEG : (s + 1) * SEG, :14] = _bwd_segment(
            tile_data[:, s * SEG : (s + 1) * SEG], px, py, entry[:, s], g, g_logt, b
        )[0]
        b = b + suffix[:, s]
    return d_rows


def _tile_segments(seg_tile, n_tiles):
    """Per-tile (first segment, segment count) of a CSR stream, int32. A
    tile with no segment gets count 0; padding segments (tile id n_tiles)
    belong to no tile."""
    n_seg = seg_tile.shape[0]
    dev = seg_tile.device
    idx = seg_tile.long()
    # scatters, not bincount: bincount waits for the device to size its output
    counts = torch.zeros((n_tiles + 1,), dtype=torch.int64, device=dev)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    starts = torch.full((n_tiles + 1,), n_seg, dtype=torch.int64, device=dev)
    starts.scatter_reduce_(0, idx, torch.arange(n_seg, device=dev), "amin")
    return starts[:n_tiles].to(torch.int32), counts[:n_tiles].to(torch.int32)


def _csr_tiles(entry_data, seg_tile, seg_u0, seg_v0, n_tiles):
    """The twins' view of a CSR stream: rows as (n_seg, CSEG, 16) blocks,
    per-tile first segment and count, pixel coordinates, and the number of
    segment ranks to walk."""
    n_seg = entry_data.shape[0] // CSEG
    starts, counts = _tile_segments(seg_tile, n_tiles)
    first = starts.long().clamp(max=max(n_seg - 1, 0))
    if n_seg == 0 or n_tiles == 0:
        origin = torch.zeros((n_tiles,), dtype=torch.int32, device=entry_data.device)
        return entry_data.view(n_seg, CSEG, N_ATTR), starts, counts, *_pixel_coords(origin, origin), 0
    px, py = _pixel_coords(seg_u0[first], seg_v0[first])
    return entry_data.view(n_seg, CSEG, N_ATTR), starts, counts, px, py, int(counts.max())


def blend_csr_fwd_plain(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels=5,
                        with_entry=False):
    """The CSR forward kernel's algorithm in PyTorch (the CPU path): step r
    blends the r-th segment of every tile that has one."""
    blocks, starts, counts, px, py, ranks = _csr_tiles(
        entry_data, seg_tile, seg_u0, seg_v0, n_tiles
    )
    accum = entry_data.new_zeros((n_tiles, PX, MAX_CHANNELS))
    logt = entry_data.new_zeros((n_tiles, PX))
    entry = entry_data.new_zeros((blocks.shape[0], PX))
    for r in range(ranks):
        act = torch.nonzero(counts > r).squeeze(1)
        seg = starts[act].long() + r
        entry[seg] = logt[act]
        accum[act], logt[act] = _fwd_segment(blocks[seg], px[act], py[act], accum[act], logt[act])
    accum = accum[:, :, :n_channels].contiguous()
    if with_entry:
        return accum, logt, entry
    return accum, logt


def blend_csr_bwd_plain(entry_data, seg_tile, seg_u0, seg_v0, entry, g_accum, g_logt,
                        n_tiles, n_channels=5):
    """The CSR backward kernel's analytic formula in PyTorch (the CPU path):
    segment ranks back to front, each tile's suffix carry starting at zero
    behind its last segment."""
    blocks, starts, counts, px, py, ranks = _csr_tiles(
        entry_data, seg_tile, seg_u0, seg_v0, n_tiles
    )
    g = torch.nn.functional.pad(g_accum, (0, MAX_CHANNELS - n_channels))
    b = entry_data.new_zeros((n_tiles, PX))
    d_data = torch.zeros_like(entry_data)
    d_blocks = d_data.view(blocks.shape)
    for r in reversed(range(ranks)):
        act = torch.nonzero(counts > r).squeeze(1)
        seg = starts[act].long() + r
        d_blocks[seg, :, :14], b[act] = _bwd_segment(
            blocks[seg], px[act], py[act], entry[seg], g[act], g_logt[act], b[act]
        )
    return d_data


def _csr_walked(entry, seg_tile, n_tiles):
    """(n_seg,) bool: the segments B4 walks, those of a tile whose stashed
    entry logT is at least LOG_EPS at some pixel. The decision is the whole
    256-row segment's, for each of its 64-row pieces."""
    return (seg_tile < n_tiles) & (entry.amax(dim=1) >= LOG_EPS)


def csr_bwd_pieces_plain(entry_data, seg_tile, seg_u0, seg_v0, entry, g_accum, n_tiles,
                         n_channels=5):
    """Pass 1 of B4 in PyTorch: each 64-row piece q of each walked segment
    walked front to back from transmittance 1. Returns (n_seg, N_PIECES, PX,
    2): per pixel the piece's log step L_q = sum_j log1p(-alpha_j) and its
    unscaled total W_q = sum_j alpha_j exp(local exclusive prefix_j) s_j,
    s_j = col_j . g_accum(p); zeros for skipped and padding segments."""
    n_seg = entry_data.shape[0] // CSEG
    out = entry_data.new_zeros((n_seg, N_PIECES, PX, 2))
    walked = torch.nonzero(_csr_walked(entry, seg_tile, n_tiles)).squeeze(1)
    if walked.numel() == 0:
        return out
    blocks = entry_data.view(n_seg, N_PIECES, SEG, N_ATTR)[walked]
    px, py = _pixel_coords(seg_u0[walked], seg_v0[walked])
    g = torch.nn.functional.pad(g_accum, (0, MAX_CHANNELS - n_channels))[seg_tile[walked].long()]
    for q in range(N_PIECES):
        block = blocks[:, q]
        alpha = _segment_geometry(block, px, py)[4]
        logs = torch.log1p(-alpha)
        cum = torch.cumsum(logs, dim=1)
        s_k = torch.einsum("tsc,tpc->tsp", block[:, :, 6 : 6 + MAX_CHANNELS], g)
        out[walked, q, :, 0] = cum[:, -1]
        out[walked, q, :, 1] = (alpha * torch.exp(cum - logs) * s_k).sum(dim=1)
    return out


def csr_bwd_walk_plain(entry_data, seg_tile, seg_u0, seg_v0, entry, g_accum, g_logt, pieces,
                       n_tiles, n_channels=5):
    """Pass 2 of B4 in PyTorch, from the piece totals `pieces` (n_seg,
    N_PIECES, PX, 2). Per segment and pixel: each piece's entry logT e_q =
    entry + ((L_0 + L_1) + ... + L_{q-1}) and scaled total P_q = exp(e_q)
    W_q; the segment total S = ((P_0 + P_1) + P_2) + P_3; the carry behind
    the segment b_tile = ((0 + S_last) + ...) + S_{s+1} over the tile's later
    segments; the carry behind piece q, b_tile + ((P_3 + P_2) + ... +
    P_{q+1}). Each piece of a walked segment is then walked from e_q with
    total P_q (`_bwd_segment` with the segment's walk decision). Skipped and
    padding segments get zero rows."""
    n_seg = entry_data.shape[0] // CSEG
    d_data = torch.zeros_like(entry_data)
    walked = torch.nonzero(_csr_walked(entry, seg_tile, n_tiles)).squeeze(1)
    if walked.numel() == 0:
        return d_data
    e, total = [], []
    steps = torch.zeros_like(entry)
    for q in range(N_PIECES):
        e.append(entry + steps)
        total.append(torch.exp(e[-1]) * pieces[:, q, :, 1])
        steps = steps + pieces[:, q, :, 0]
    seg_total = sum(total[1:], total[0])
    starts, counts = _tile_segments(seg_tile, n_tiles)
    b_tile = torch.zeros_like(entry)
    b = entry.new_zeros((n_tiles, PX))
    for r in reversed(range(int(counts.max()))):
        act = torch.nonzero(counts > r).squeeze(1)
        seg = starts[act].long() + r
        b_tile[seg] = b[act]
        b[act] = b[act] + seg_total[seg]
    blocks = entry_data.view(n_seg, N_PIECES, SEG, N_ATTR)[walked]
    d_blocks = d_data.view(n_seg, N_PIECES, SEG, N_ATTR)
    px, py = _pixel_coords(seg_u0[walked], seg_v0[walked])
    tile = seg_tile[walked].long()
    g = torch.nn.functional.pad(g_accum, (0, MAX_CHANNELS - n_channels))[tile]
    every = torch.ones_like(walked, dtype=torch.bool)
    behind = torch.zeros_like(b_tile)
    for q in reversed(range(N_PIECES)):
        carry = (b_tile + behind)[walked]
        d_blocks[walked, q, :, :14] = _bwd_segment(
            blocks[:, q], px, py, e[q][walked], g, g_logt[tile], carry, walk=every,
            total=total[q][walked],
        )[0]
        behind = behind + total[q]
    return d_data


def blend_csr_dual_fwd_plain(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels=3):
    """The dual CSR kernel's algorithm in PyTorch (the CPU path): step r
    walks the r-th segment of every tile that has one, both carries at
    once."""
    blocks, starts, counts, px, py, ranks = _csr_tiles(
        entry_data, seg_tile, seg_u0, seg_v0, n_tiles
    )
    accum = entry_data.new_zeros((n_tiles, PX, MAX_CHANNELS))
    logt = entry_data.new_zeros((n_tiles, PX))
    logt_band = entry_data.new_zeros((n_tiles, PX))
    for r in range(ranks):
        act = torch.nonzero(counts > r).squeeze(1)
        seg = starts[act].long() + r
        accum[act], logt[act], logt_band[act] = _dual_segment(
            blocks[seg], px[act], py[act], accum[act], logt[act], logt_band[act]
        )
    return accum[:, :, :n_channels].contiguous(), logt, logt_band


def partial_width(n_channels, dual=False):
    """Floats per pixel of a segment's partials: C colours, the log step
    and, for B5, the band log step."""
    return n_channels + 1 + int(dual)


def csr_partials_plain(entry_data, seg_u0, seg_v0, n_channels=5, dual=False):
    """Pass 1 in PyTorch: every segment composited by itself from
    transmittance 1 (`_blend_segment` with logT 0), 1,024 segments at a
    time to bound memory. Returns (n_seg, PX, partial_width): per pixel the
    colour partial sum_j alpha_j exp(excl_j) col_j, the log step
    sum_j log1p(-alpha_j) and, with `dual`, the band step over
    alpha_j * band_j. Padding segments are computed too (nothing reads
    them)."""
    n_seg = entry_data.shape[0] // CSEG
    blocks = entry_data.view(n_seg, CSEG, N_ATTR)
    out = entry_data.new_empty((n_seg, PX, partial_width(n_channels, dual)))
    chunk = 1024
    for lo in range(0, n_seg, chunk):
        block = blocks[lo : lo + chunk]
        px, py = _pixel_coords(seg_u0[lo : lo + chunk], seg_v0[lo : lo + chunk])
        alpha, contrib, step = _blend_segment(block, px, py, torch.zeros_like(px))
        out[lo : lo + chunk, :, :n_channels] = contrib[:, :, :n_channels]
        out[lo : lo + chunk, :, n_channels] = step
        if dual:
            band = block[:, :, BAND_COL : BAND_COL + 1]
            out[lo : lo + chunk, :, n_channels + 1] = torch.cumsum(
                torch.log1p(-alpha * band), dim=1
            )[:, -1]
    return out


def csr_combine_plain(partials, seg_tile, n_tiles, n_channels=5, dual=False, with_entry=False):
    """Pass 2 in PyTorch: each tile's segments in order from their partials.
    At each segment start the whole-tile exit (max logT < LOG_EPS, the band
    carry with `dual`), the stash takes the entry logT, then accum +=
    exp(logT) P and logT += L (the band carry likewise). Partials of
    segments after the exit are never used. Returns (accum, logT[, band
    logT][, entry]) as the wrappers do."""
    starts, counts = _tile_segments(seg_tile, n_tiles)
    n_seg = partials.shape[0]
    accum = partials.new_zeros((n_tiles, PX, n_channels))
    logt = partials.new_zeros((n_tiles, PX))
    logt_band = partials.new_zeros((n_tiles, PX))
    entry = partials.new_zeros((n_seg, PX))
    for r in range(int(counts.max()) if n_tiles and n_seg else 0):
        act = torch.nonzero(counts > r).squeeze(1)
        seg = starts[act].long() + r
        entry[seg] = logt[act]
        walk = ((logt_band if dual else logt)[act].amax(dim=1) >= LOG_EPS)[:, None]
        q = partials[seg]
        lt = logt[act]
        accum[act] = torch.where(
            walk[:, :, None], accum[act] + torch.exp(lt)[:, :, None] * q[:, :, :n_channels],
            accum[act],
        )
        logt[act] = torch.where(walk, lt + q[:, :, n_channels], lt)
        if dual:
            logt_band[act] = torch.where(walk, logt_band[act] + q[:, :, n_channels + 1],
                                         logt_band[act])
    return (accum, logt) + ((logt_band,) if dual else ()) + ((entry,) if with_entry else ())


DEAD_MARGIN = 1e-3  # log-domain margin of the dead-pair test (B1-B5)


def dead_pair_threshold(op, margin=DEAD_MARGIN):
    """The per-row dead-pair threshold of B1-B5, in float32 as the
    kernels compute it: log(ALPHA_MIN) - log(op) - margin, +inf for op <= 0. A
    (row, pixel) pair whose power is above 0 or below it has alpha 0 by the
    full formula, so the kernels skip its special functions."""
    op = op.to(torch.float32)
    log_min = torch.log(torch.tensor(ALPHA_MIN, dtype=torch.float32))
    thr = log_min - torch.log(op) - margin
    return torch.where(op <= 0, torch.full_like(op, float("inf")), thr)


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #


def _kernel(library: str, symbol: str):
    fn = getattr(_build.load(library), symbol)
    if fn.argtypes is None:
        fn.argtypes = [_ARG_TYPES[a] for a in _SIGNATURES[symbol]]
        fn.restype = ctypes.c_int
    return fn


# the arguments of each C entry point: p pointer (or stream), i int, l int64, f float
_ARG_TYPES = {"p": _P, "i": _I, "l": ctypes.c_int64, "f": ctypes.c_float}
_SIGNATURES = {
    "blend_tiles_fwd": "pppiiipppppp",
    "tile_fwd_partials": "pppiiifipppp",
    "tile_fwd_combine": "piiipppp",
    "tile_fwd_occupancy": "ip",
    "tile_bwd_suffix": "pppppiiifppp",
    "tile_bwd_walk": "pppppppiiipp",
    "tile_bwd_occupancy": "ip",
    "blend_csr_fwd_partials": "ppppiiifpppp",
    "blend_csr_fwd_combine": "pppiipppp",
    "csr_bwd_pieces": "ppppppiiifppp",
    "csr_bwd_walk": "ppppppppiiipp",
    "csr_bwd_occupancy": "ip",
    "blend_csr_dual_partials": "ppppiiifpppp",
    "blend_csr_dual_combine": "pppiipppp",
    "bin_count": "pppppiiippp",
    "bin_slots": "ppiiiiiipp",
    "gather_rows_bwd": "plppiipp",
}


def blend_tiles_fwd(tile_data, tile_u0, tile_v0, n_channels=5, with_entry=False):
    """B1. Returns (accum (T, PX, n_channels), log_transmittance (T, PX)
    [, entry (T, K/SEG, PX)]): `entry` is each segment's entry
    log-transmittance, the backward's residual. On the card, two launches
    from one C call: the segments' partials, then the per-tile combine."""
    _check_rows(tile_data, tile_u0, tile_v0, n_channels)
    if _device_kind(tile_data) == "cpu":
        return blend_tiles_fwd_plain(tile_data, tile_u0, tile_v0, n_channels, with_entry)
    t, k, _ = tile_data.shape
    accum = tile_data.new_empty((t, PX, n_channels))
    logt = tile_data.new_empty((t, PX))
    entry = tile_data.new_empty((t, k // SEG, PX)) if with_entry else None
    part = tile_data.new_empty((t, k // SEG, PX, n_channels + 1))
    skip_from = torch.empty((t,), dtype=torch.int32, device=tile_data.device)
    with torch.cuda.device(tile_data.device):
        ptrs = _cuda_args(tile_data, tile_u0, tile_v0, skip_from, part, accum, logt)
        _launch(_kernel("blend_fwd", "blend_tiles_fwd"), "blend_tiles_fwd", *ptrs[:3], t, k,
                n_channels, *ptrs[3:], None if entry is None else _cuda_args(entry)[0])
    blend_tiles_fwd.launches += 1
    if with_entry:
        return accum, logt, entry
    return accum, logt


def _check_partials(partials, n_channels):
    if not 1 <= n_channels <= MAX_CHANNELS:
        raise ValueError(f"n_channels must be in [1, 8], got {n_channels}")
    if (partials.dtype != torch.float32 or partials.dim() != 4
            or partials.shape[2:] != (PX, n_channels + 1)):
        raise ValueError(f"partials must be (T, K/{SEG}, {PX}, {n_channels + 1}) float32, "
                         f"got {tuple(partials.shape)}")


def tile_fwd_partials_cuda(tile_data, tile_u0, tile_v0, n_channels=5, margin=DEAD_MARGIN,
                           out=None, audit=None, drop_warps=0):
    """Pass 1 of B1 on the card: tile_fwd_partials_plain's partials (T,
    K/SEG, PX, C + 1) for every segment that the kernel does not skip; the
    skipped segments (after one that saturates its tile by itself) keep what
    `out` held (default: torch.empty). `margin` is the dead-pair test's;
    `audit`, an int32 (1,) tensor, counts the pairs that test or the warp
    reach mask kills although the full formula keeps them. `drop_warps`, a
    bit per warp, clears warps from every row's reach mask: a planted fault
    for the audit. The wrapper's pass; the smoke checks it."""
    _check_rows(tile_data, tile_u0, tile_v0, n_channels)
    t, k, _ = tile_data.shape
    if out is None:
        out = tile_data.new_empty((t, k // SEG, PX, n_channels + 1))
    _check_partials(out, n_channels)
    if out.shape[:2] != (t, k // SEG) or out.device != tile_data.device:
        raise ValueError(f"out must be ({t}, {k // SEG}, {PX}, {n_channels + 1}) on the rows' device")
    skip_from = torch.empty((t,), dtype=torch.int32, device=tile_data.device)
    with torch.cuda.device(tile_data.device):
        ptrs = _cuda_args(tile_data, tile_u0, tile_v0, skip_from, out)
        _launch(_kernel("blend_fwd", "tile_fwd_partials"), "tile_fwd_partials", *ptrs[:3], t, k,
                n_channels, margin, ALL_WARPS & ~drop_warps, *ptrs[3:],
                None if audit is None else _cuda_args(audit)[0])
    return out


def tile_fwd_combine_cuda(partials, n_channels=5, with_entry=False):
    """Pass 2 of B1 on the card: tile_fwd_combine_plain's outputs from the
    partials of pass 1. The wrapper's pass; the smoke checks it."""
    _check_partials(partials, n_channels)
    t, n_seg = partials.shape[:2]
    accum = partials.new_empty((t, PX, n_channels))
    logt = partials.new_empty((t, PX))
    entry = partials.new_empty((t, n_seg, PX)) if with_entry else None
    with torch.cuda.device(partials.device):
        ptrs = _cuda_args(partials, accum, logt)
        _launch(_kernel("blend_fwd", "tile_fwd_combine"), "tile_fwd_combine", ptrs[0], t,
                n_seg * SEG, n_channels, *ptrs[1:], None if entry is None else _cuda_args(entry)[0])
    return (accum, logt) if entry is None else (accum, logt, entry)


def tile_fwd_occupancy(n_channels=5):
    """B1's two kernels at C channels as the card runs them: {pass:
    {registers, static_smem, dynamic_smem, local_bytes, blocks_per_sm}}."""
    return _occupancy("blend_fwd", "tile_fwd_occupancy", n_channels, ("partials", "combine"))


def _check_bwd(tile_data, tile_u0, tile_v0, n_channels, **tensors):
    """B2's inputs: the rows as B1's, each of `tensors` (entry, g_accum,
    g_logt, suffix) float32 of its shape on the rows' device."""
    _check_rows(tile_data, tile_u0, tile_v0, n_channels)
    t, k, _ = tile_data.shape
    shapes = {"entry": (t, k // SEG, PX), "suffix": (t, k // SEG, PX),
              "g_accum": (t, PX, n_channels), "g_logt": (t, PX)}
    for name, x in tensors.items():
        if x.shape != shapes[name] or x.dtype != torch.float32 or x.device != tile_data.device:
            raise ValueError(f"{name} must be {shapes[name]} float32 on the rows' device")


def blend_tiles_bwd(tile_data, tile_u0, tile_v0, entry, g_accum, g_logt, n_channels=5):
    """B2. Gradient of blend_tiles_fwd with respect to the rows: (T, K, 16),
    columns 14 and 15 zero. On the card, two launches: the segments'
    suffix totals, then the walk."""
    _check_bwd(tile_data, tile_u0, tile_v0, n_channels, entry=entry, g_accum=g_accum,
               g_logt=g_logt)
    if _device_kind(tile_data) == "cpu":
        return blend_tiles_bwd_plain(
            tile_data, tile_u0, tile_v0, entry, g_accum, g_logt, n_channels
        )
    suffix = tile_bwd_suffix_cuda(tile_data, tile_u0, tile_v0, entry, g_accum, n_channels)
    d_rows = tile_bwd_walk_cuda(tile_data, tile_u0, tile_v0, entry, g_accum, g_logt, suffix,
                                n_channels)
    blend_tiles_bwd.launches += 1
    return d_rows


def tile_bwd_suffix_cuda(tile_data, tile_u0, tile_v0, entry, g_accum, n_channels=5,
                         margin=DEAD_MARGIN, out=None, audit=None):
    """Pass 1 of B2 on the card: tile_bwd_suffix_plain's totals (T, K/SEG,
    PX), every entry written (default scratch: torch.empty). `margin` is the
    dead-pair test's; `audit`, an int32 (1,) tensor, counts the pairs that
    test or the warp reach mask kills although the full formula keeps
    them. The wrapper's pass; the smoke checks it."""
    _check_bwd(tile_data, tile_u0, tile_v0, n_channels, entry=entry, g_accum=g_accum)
    t, k, _ = tile_data.shape
    if out is None:
        out = tile_data.new_empty((t, k // SEG, PX))
    with torch.cuda.device(tile_data.device):
        ptrs = _cuda_args(tile_data, tile_u0, tile_v0, entry, g_accum, out)
        _launch(_kernel("blend_bwd", "tile_bwd_suffix"), "tile_bwd_suffix", *ptrs[:5], t, k,
                n_channels, margin, ptrs[5], None if audit is None else _cuda_args(audit)[0])
    return out


def tile_bwd_walk_cuda(tile_data, tile_u0, tile_v0, entry, g_accum, g_logt, suffix,
                       n_channels=5):
    """Pass 2 of B2 on the card: tile_bwd_walk_plain's gradient rows from
    the totals `suffix`. The wrapper's pass; the smoke checks it."""
    _check_bwd(tile_data, tile_u0, tile_v0, n_channels, entry=entry, g_accum=g_accum,
               g_logt=g_logt, suffix=suffix)
    t, k, _ = tile_data.shape
    d_rows = torch.empty_like(tile_data)
    with torch.cuda.device(tile_data.device):
        ptrs = _cuda_args(tile_data, tile_u0, tile_v0, entry, g_accum, g_logt, suffix, d_rows)
        _launch(_kernel("blend_bwd", "tile_bwd_walk"), "tile_bwd_walk", *ptrs[:7], t, k,
                n_channels, ptrs[7])
    return d_rows


def tile_bwd_occupancy(n_channels=5):
    """B2's two kernels at C channels as the card runs them: {pass:
    {registers, static_smem, dynamic_smem, local_bytes, blocks_per_sm}}."""
    return _occupancy("blend_bwd", "tile_bwd_occupancy", n_channels, ("suffix", "walk"))


def _check_csr(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels):
    if entry_data.dtype != torch.float32 or entry_data.dim() != 2:
        raise ValueError(f"entry rows must be (E, 16) float32, got {entry_data.shape}")
    e, n_attr = entry_data.shape
    if n_attr != N_ATTR or e % CSEG != 0:
        raise ValueError(f"entry rows need E % {CSEG} == 0 and 16 columns: {entry_data.shape}")
    if not 1 <= n_channels <= MAX_CHANNELS:
        raise ValueError(f"n_channels must be in [1, 8], got {n_channels}")
    if n_tiles < 0:
        raise ValueError(f"n_tiles must be >= 0, got {n_tiles}")
    for x in (seg_tile, seg_u0, seg_v0):
        if x.dtype != torch.int32 or x.shape != (e // CSEG,):
            raise ValueError("segment maps must be (E/CSEG,) int32")
        if x.device != entry_data.device:
            raise ValueError("segment maps must lie on the rows' device")


def blend_csr_fwd(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels=5,
                  with_entry=False):
    """B3, the exact blend over CSR runs. entry_data holds each tile's whole
    depth-ordered list, padded to a CSEG multiple, so that every CSEG-row
    segment belongs to one tile; seg_tile maps segments to tiles (the
    segments of a tile consecutive, id n_tiles = padding, walked by no
    tile), seg_u0/seg_v0 give each segment's tile origin. Returns (accum
    (n_tiles, PX, n_channels), log_transmittance (n_tiles, PX) [, entry
    (E/CSEG, PX)]): `entry` is each segment's entry log-transmittance, zero
    for padding segments. Tiles with no segment get zeros."""
    _check_csr(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels)
    if _device_kind(entry_data) == "cpu":
        return blend_csr_fwd_plain(
            entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels, with_entry
        )
    partials = csr_partials_cuda(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels)
    out = csr_combine_cuda(partials, seg_tile, n_tiles, n_channels, with_entry=with_entry)
    blend_csr_fwd.launches += 1
    return out


def _launch(fn, name, *args):
    """Call a C entry point on the current stream; raise on a CUDA error."""
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def csr_partials_cuda(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels=5, dual=False,
                      margin=DEAD_MARGIN, out=None, audit=None):
    """Pass 1 of B3 (or of B5 with `dual`) on the card: the partials of
    csr_partials_plain, (n_seg, PX, partial_width), for every segment of a
    tile that the kernel does not skip. The skipped segments (after one
    that saturates its tile by itself) and padding segments keep what `out`
    held (default: torch.empty). `margin` is the dead-pair test's; `audit`,
    an int32 (1,) tensor, counts the pairs that test kills although the
    full formula keeps them. The wrappers' pass; the smoke checks it."""
    n_seg = entry_data.shape[0] // CSEG
    if out is None:
        out = entry_data.new_empty((n_seg, PX, partial_width(n_channels, dual)))
    # the per-tile index of the first segment that saturates its tile by itself
    skip_from = torch.full((max(n_tiles, 1),), 2**31 - 1, dtype=torch.int32,
                           device=entry_data.device)
    lib, sym = ("blend_csr_dual", "blend_csr_dual_partials") if dual else (
        "blend_csr_fwd", "blend_csr_fwd_partials")
    with torch.cuda.device(entry_data.device):
        ptrs = _cuda_args(entry_data, seg_tile, seg_u0, seg_v0, skip_from, out)
        _launch(_kernel(lib, sym), sym, *ptrs[:4], n_seg, n_tiles, n_channels, margin, *ptrs[4:],
                None if audit is None else _cuda_args(audit)[0])
    return out


def csr_combine_cuda(partials, seg_tile, n_tiles, n_channels=5, dual=False, with_entry=False):
    """Pass 2 of B3 (or of B5 with `dual`) on the card: csr_combine_plain's
    outputs from the partials of pass 1 (B5 has no stash). The wrappers'
    pass; the smoke checks it."""
    starts, counts = _tile_segments(seg_tile, n_tiles)
    accum = partials.new_empty((n_tiles, PX, n_channels))
    logt = partials.new_empty((n_tiles, PX))
    third = None  # B5's band carry, or B3's stash
    if dual:
        third = partials.new_empty((n_tiles, PX))
    elif with_entry:
        third = partials.new_zeros((partials.shape[0], PX))  # padding segments keep zeros
    sym = "blend_csr_dual_combine" if dual else "blend_csr_fwd_combine"
    with torch.cuda.device(partials.device):
        ptrs = _cuda_args(partials, starts, counts, accum, logt)
        _launch(_kernel("blend_csr_dual" if dual else "blend_csr_fwd", sym), sym, *ptrs[:3],
                n_tiles, n_channels, *ptrs[3:], None if third is None else _cuda_args(third)[0])
    return (accum, logt) if third is None else (accum, logt, third)


def _check_csr_bwd(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels, **tensors):
    """B4's inputs: the stream as B3's, each of `tensors` (entry, g_accum,
    g_logt, pieces) float32 of its shape on the rows' device."""
    _check_csr(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels)
    n_seg = entry_data.shape[0] // CSEG
    shapes = {"entry": (n_seg, PX), "g_accum": (n_tiles, PX, n_channels),
              "g_logt": (n_tiles, PX), "pieces": (n_seg, N_PIECES, PX, 2)}
    for name, x in tensors.items():
        if x.shape != shapes[name] or x.dtype != torch.float32 or x.device != entry_data.device:
            raise ValueError(f"{name} must be {shapes[name]} float32 on the rows' device")


def blend_csr_bwd(entry_data, seg_tile, seg_u0, seg_v0, entry, g_accum, g_logt, n_tiles,
                  n_channels=5):
    """B4. Gradient of blend_csr_fwd with respect to the entry rows: (E, 16),
    columns 14 and 15 zero, rows of skipped and padding segments zero. On
    the card, two launches: the 64-row pieces' totals, then the walk."""
    _check_csr_bwd(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels, entry=entry,
                   g_accum=g_accum, g_logt=g_logt)
    if _device_kind(entry_data) == "cpu":
        return blend_csr_bwd_plain(
            entry_data, seg_tile, seg_u0, seg_v0, entry, g_accum, g_logt, n_tiles, n_channels
        )
    pieces = csr_bwd_pieces_cuda(entry_data, seg_tile, seg_u0, seg_v0, entry, g_accum, n_tiles,
                                 n_channels)
    d_data = csr_bwd_walk_cuda(entry_data, seg_tile, seg_u0, seg_v0, entry, g_accum, g_logt,
                               pieces, n_tiles, n_channels)
    blend_csr_bwd.launches += 1
    return d_data


def csr_bwd_pieces_cuda(entry_data, seg_tile, seg_u0, seg_v0, entry, g_accum, n_tiles,
                        n_channels=5, margin=DEAD_MARGIN, out=None, audit=None):
    """Pass 1 of B4 on the card: csr_bwd_pieces_plain's (L, W) per piece and
    pixel, (n_seg, N_PIECES, PX, 2), every entry written (default scratch:
    torch.empty). `margin` is the dead-pair test's; `audit`, an int32 (1,)
    tensor, counts the pairs that test or the warp reach mask kills
    although the full formula keeps them. The wrapper's pass; the smoke
    checks it."""
    _check_csr_bwd(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels, entry=entry,
                   g_accum=g_accum)
    n_seg = entry_data.shape[0] // CSEG
    if out is None:
        out = entry_data.new_empty((n_seg, N_PIECES, PX, 2))
    with torch.cuda.device(entry_data.device):
        ptrs = _cuda_args(entry_data, seg_tile, seg_u0, seg_v0, entry, g_accum, out)
        _launch(_kernel("blend_csr_bwd", "csr_bwd_pieces"), "csr_bwd_pieces", *ptrs[:6], n_seg,
                n_tiles, n_channels, margin, ptrs[6], None if audit is None else _cuda_args(audit)[0])
    return out


def csr_bwd_walk_cuda(entry_data, seg_tile, seg_u0, seg_v0, entry, g_accum, g_logt, pieces,
                      n_tiles, n_channels=5):
    """Pass 2 of B4 on the card: csr_bwd_walk_plain's gradient rows from the
    piece totals `pieces`. The wrapper's pass; the smoke checks it."""
    _check_csr_bwd(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels, entry=entry,
                   g_accum=g_accum, g_logt=g_logt, pieces=pieces)
    n_seg = entry_data.shape[0] // CSEG
    d_data = torch.empty_like(entry_data)  # every row written: zeros where not walked
    with torch.cuda.device(entry_data.device):
        ptrs = _cuda_args(entry_data, seg_tile, seg_u0, seg_v0, entry, g_accum, g_logt, pieces,
                          d_data)
        _launch(_kernel("blend_csr_bwd", "csr_bwd_walk"), "csr_bwd_walk", *ptrs[:8], n_seg,
                n_tiles, n_channels, ptrs[8])
    return d_data


def _occupancy(library, symbol, n_channels, passes):
    """A source's two kernels at C channels as the card runs them: {pass:
    {registers, static_smem, dynamic_smem, local_bytes, blocks_per_sm}}."""
    out = (ctypes.c_int * 10)()
    rc = _kernel(library, symbol)(n_channels, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {rc}")
    keys = ("registers", "static_smem", "dynamic_smem", "local_bytes", "blocks_per_sm")
    return {name: dict(zip(keys, out[5 * i : 5 * i + 5])) for i, name in enumerate(passes)}


def csr_bwd_occupancy(n_channels=5):
    """B4's two kernels at C channels as the card runs them: {pass:
    {registers, static_smem, dynamic_smem, local_bytes, blocks_per_sm}}."""
    return _occupancy("blend_csr_bwd", "csr_bwd_occupancy", n_channels, ("pieces", "walk"))


def bin_count_plain(valid, tx0, tx1, ty0, ty1, tiles_x, tiles_y):
    """Pass 1 of the bin route in PyTorch, the reference's counting front
    (raster_tiled.py:141-156): the (block, tile) member counts as one
    float32 product of the (nb, 128, tiles_y) and (nb, 128, tiles_x)
    interval indicators, exact since a count is at most 128 and TF32 is
    off, and the packed AABB words, an invalid or padding Gaussian's the
    empty interval tx0 = 255 > tx1 = 0 as in the reference's byte planes.
    Returns (words (nb * 128,) int32, counts (nb, T) int32)."""
    n = valid.shape[0]
    nb = -(-n // BIN_BLOCK)
    pad = nb * BIN_BLOCK - n
    dev = valid.device
    cols = torch.arange(tiles_x, dtype=torch.float32, device=dev)
    rows = torch.arange(tiles_y, dtype=torch.float32, device=dev)
    in_x = ((cols >= tx0[:, None]) & (cols <= tx1[:, None]) & valid[:, None]).to(torch.float32)
    in_y = ((rows >= ty0[:, None]) & (rows <= ty1[:, None])).to(torch.float32)
    in_x = F.pad(in_x, (0, 0, 0, pad)).view(nb, BIN_BLOCK, tiles_x)
    in_y = F.pad(in_y, (0, 0, 0, pad)).view(nb, BIN_BLOCK, tiles_y)
    counts = torch.bmm(in_y.transpose(1, 2), in_x)  # (nb, ty, tx)

    x0, x1, y0, y1 = (b.to(torch.int64) for b in (tx0, tx1, ty0, ty1))
    word = torch.where(valid, (x0 << 24) | (x1 << 16) | (y0 << 8) | y1, 255 << 24)
    word = F.pad(word, (0, pad), value=255 << 24)
    word = torch.where(word >= 1 << 31, word - (1 << 32), word).to(torch.int32)  # as int32 bits
    return word, counts.view(nb, tiles_x * tiles_y).to(torch.int32)


def bin_slots_plain(cum_t, aabb, k, slot_offset, tiles_x, n):
    """Pass 2 of the bin route in PyTorch, computed as the reference's
    two-level slot search: each slot's block from the count of blocks whose
    inclusive count is at most the slot, the block's membership bits from
    the packed AABB words, and the in-block prefix."""
    cum = cum_t.T.contiguous()  # (T, nb): each tile's row, for the search
    t, nb = cum.shape
    ks = slot_offset + torch.arange(k, dtype=torch.int32, device=cum.device)
    blk = torch.searchsorted(cum, ks.expand(t, k).contiguous(), right=True)  # (T, K)
    blk_safe = blk.clamp(max=nb - 1)
    prior = torch.where(
        blk_safe > 0, torch.gather(cum, 1, (blk_safe - 1).clamp(min=0)), 0
    )  # members of the tile before the block
    words = aabb.view(nb, BIN_BLOCK)[blk_safe]  # (T, K, BLK)
    tile = torch.arange(t, device=cum.device)
    ttx = (tile % tiles_x)[:, None, None]
    tty = torch.div(tile, tiles_x, rounding_mode="floor")[:, None, None]
    bits = (
        (((words >> 24) & 0xFF) <= ttx) & (ttx <= ((words >> 16) & 0xFF))
        & (((words >> 8) & 0xFF) <= tty) & (tty <= (words & 0xFF))
    )
    local = torch.cumsum(bits.to(torch.int32), dim=2)
    needed = (ks[None, :] - prior + 1)[:, :, None]
    pos = (local < needed).sum(dim=2)
    indices = blk_safe * BIN_BLOCK + pos
    return torch.where(ks[None, :] < cum[:, -1:], indices, n)


def _check_bin_count(valid, bounds, tiles_x, tiles_y):
    if valid.dtype != torch.bool or valid.dim() != 1 or not 1 <= valid.shape[0]:
        raise ValueError(f"valid must be (N,) bool with N >= 1, got {tuple(valid.shape)}")
    n = valid.shape[0]
    if -(-n // BIN_BLOCK) > BIN_MAX_BLOCKS:
        raise ValueError(f"at most {BIN_MAX_BLOCKS} blocks of {BIN_BLOCK} Gaussians, got N={n}")
    for x in bounds:
        if x.dtype != torch.float32 or x.shape != (n,) or x.device != valid.device:
            raise ValueError(f"tile bounds must be ({n},) float32 on valid's device")
    if not (1 <= tiles_x <= BIN_MAX_TILES and 1 <= tiles_y <= BIN_MAX_TILES):
        raise ValueError(f"the packed words hold at most {BIN_MAX_TILES} x {BIN_MAX_TILES} "
                         f"tiles, got {tiles_x} x {tiles_y}")


def bin_count(valid, tx0, tx1, ty0, ty1, tiles_x, tiles_y):
    """B6, pass 1 of the route. `valid` (N,) bool and the tile bounds (N,)
    float32 from raster_tiled.tile_aabbs (integral, clamped to the grid).
    Returns (words (nb * 128,) int32: tx0 << 24 | tx1 << 16 | ty0 << 8 |
    ty1 a Gaussian, 255 << 24 for an invalid or padding one; counts (nb, T)
    int32: each 128-Gaussian block's members in each tile). On the card one
    launch."""
    _check_bin_count(valid, (tx0, tx1, ty0, ty1), tiles_x, tiles_y)
    if _device_kind(valid) == "cpu":
        return bin_count_plain(valid, tx0, tx1, ty0, ty1, tiles_x, tiles_y)
    out = bin_count_cuda(valid, tx0, tx1, ty0, ty1, tiles_x, tiles_y)
    bin_count.launches += 1
    return out


def bin_count_cuda(valid, tx0, tx1, ty0, ty1, tiles_x, tiles_y):
    """Pass 1 of B6 on the card: bin_count_plain's (words, counts). The
    wrapper's pass; the smoke checks it."""
    _check_bin_count(valid, (tx0, tx1, ty0, ty1), tiles_x, tiles_y)
    n = valid.shape[0]
    nb = -(-n // BIN_BLOCK)
    t = tiles_x * tiles_y
    words = torch.empty((nb * BIN_BLOCK,), dtype=torch.int32, device=valid.device)
    counts = torch.empty((nb, t), dtype=torch.int32, device=valid.device)
    with torch.cuda.device(valid.device):
        ptrs = _cuda_args(valid, tx0, tx1, ty0, ty1, words, counts)
        _launch(_kernel("bin_slots", "bin_count"), "bin_count", *ptrs[:5], n, tiles_x, t,
                *ptrs[5:])
    return words, counts


def _check_bin_slots(cum_t, aabb):
    if (cum_t.dtype != torch.int32 or cum_t.dim() != 2
            or not 1 <= cum_t.shape[0] <= BIN_MAX_BLOCKS):
        raise ValueError(f"cum_t must be (nb, T) int32 with 1 <= nb <= {BIN_MAX_BLOCKS}: "
                         f"{tuple(cum_t.shape)}")
    nb = cum_t.shape[0]
    if aabb.dtype != torch.int32 or aabb.shape != (nb * BIN_BLOCK,) or aabb.device != cum_t.device:
        raise ValueError(f"aabb must be ({nb * BIN_BLOCK},) int32 on cum_t's device")


def bin_slots(cum_t, aabb, k, slot_offset, tiles_x, n):
    """B6, pass 2 of the route. The depth-ordered member ids at list
    positions [slot_offset, slot_offset + k) of every tile: (T, k) int64,
    the sentinel n past a tile's count. `cum_t` (nb, T) int32 holds each
    tile's inclusive cumsum of member counts over 128-Gaussian blocks (nb
    <= BIN_MAX_BLOCKS; the reference's layout); `aabb` (nb * 128,) int32
    the packed words of bin_count. On the card one launch; `launches`
    counts the route's calls."""
    _check_bin_slots(cum_t, aabb)
    if _device_kind(cum_t) == "cpu":
        return bin_slots_plain(cum_t, aabb, k, slot_offset, tiles_x, n)
    out = bin_slots_cuda(cum_t, aabb, k, slot_offset, tiles_x, n)
    bin_slots.launches += 1
    return out


def bin_slots_cuda(cum_t, aabb, k, slot_offset, tiles_x, n):
    """Pass 2 of B6 on the card: bin_slots_plain's ids, every slot written.
    The wrapper's pass; the smoke checks it."""
    _check_bin_slots(cum_t, aabb)
    nb, t = cum_t.shape
    out = torch.empty((t, k), dtype=torch.int64, device=cum_t.device)
    with torch.cuda.device(cum_t.device):
        ptrs = _cuda_args(cum_t, aabb, out)
        _launch(_kernel("bin_slots", "bin_slots"), "bin_slots", *ptrs[:2], nb, t, k,
                int(slot_offset), tiles_x, n, ptrs[2])
    return out


def blend_csr_dual_fwd(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels=3):
    """B5, forward only: B3's walk over the same stream, carrying a second
    log-transmittance over alpha * band, the band bit (0 or 1) in column
    BAND_COL of each entry row; colours stay in columns 6:6+C. The whole-
    tile exit tests the band carry alone. Returns (accum (n_tiles, PX,
    n_channels), log_transmittance, band log_transmittance (n_tiles, PX));
    tiles with no segment get zeros."""
    _check_csr(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels)
    if _device_kind(entry_data) == "cpu":
        return blend_csr_dual_fwd_plain(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels)
    partials = csr_partials_cuda(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels,
                                 dual=True)
    out = csr_combine_cuda(partials, seg_tile, n_tiles, n_channels, dual=True)
    blend_csr_dual_fwd.launches += 1
    return out


def gather_bwd_runs(ids, n_rows):
    """The gather backward kernel's preparation, plain PyTorch on the ids'
    device with no host sync: (perm (R,) int64, the positions of the
    flattened ids in a stable sort of them as int32 keys, so each row's
    positions in increasing order; starts (n_rows,) int32, the first sorted
    position of each table row). Row g < n_rows - 1 gathered the rows
    perm[starts[g]:starts[g + 1]]; row n_rows - 1 the rest that are in
    range."""
    keys = ids.reshape(-1).to(torch.int32)
    sorted_keys, perm = torch.sort(keys, stable=True)
    rows = torch.arange(n_rows, dtype=torch.int32, device=ids.device)
    return perm, torch.searchsorted(sorted_keys, rows, out_int32=True)


def _check_gather_bwd(grad, ids, n_rows):
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids must be int32 or int64, got {ids.dtype}")
    if grad.dim() != ids.dim() + 1 or grad.shape[:-1] != ids.shape or grad.shape[-1] < 1:
        raise ValueError(f"grad must be ids' shape {tuple(ids.shape)} and a width, got "
                         f"{tuple(grad.shape)}")
    if grad.device != ids.device:
        raise ValueError("ids must lie on grad's device")
    if not 1 <= n_rows < 2**31 - 1 or ids.numel() >= 2**31 or n_rows * grad.shape[-1] >= 2**31:
        raise ValueError(f"at most 2**31 ids and table elements, got {ids.numel()} ids and "
                         f"{n_rows} rows")


def gather_rows_bwd(grad, ids, n_rows):
    """The row gathers' backward: the gradient (n_rows, W) of table[ids]
    for an (n_rows, W) table whose last row pads the lists; `grad` has ids'
    shape and W columns. Each row below the last is the sum of its gathered
    rows in position order from zero. On the card one launch after
    gather_bwd_runs: the last row is zero and its run is never read (no
    caller reads that row's gradient); float32 only. On the CPU autograd's
    own index backward, `_index_put_impl_` with accumulate and unsafe=True
    (no host read of the ids' range): its last row sums the padding rows.
    `launches` counts the kernel's calls."""
    _check_gather_bwd(grad, ids, n_rows)
    width = grad.shape[-1]
    if _device_kind(grad) == "cpu":
        return torch.ops.aten._index_put_impl_(grad.new_zeros((n_rows, width)), [ids], grad,
                                               True, True)
    if grad.dtype != torch.float32:
        raise ValueError(f"the gather backward kernel takes float32, got {grad.dtype}")
    rows = grad.reshape(-1, width)  # a view for the blends' layouts: no copy
    if rows.stride(1) != 1:
        rows = rows.contiguous()
    out = grad.new_empty((n_rows, width))
    with torch.cuda.device(grad.device):
        perm, starts = gather_bwd_runs(ids, n_rows)
        _launch(_kernel("gather_bwd", "gather_rows_bwd"), "gather_rows_bwd", rows.data_ptr(),
                rows.stride(0), *_cuda_args(perm, starts), n_rows, width, _cuda_args(out)[0])
    gather_rows_bwd.launches += 1
    return out


blend_tiles_fwd.launches = 0
blend_tiles_bwd.launches = 0
blend_csr_fwd.launches = 0
blend_csr_bwd.launches = 0
blend_csr_dual_fwd.launches = 0
bin_slots.launches = 0
bin_count.launches = 0
gather_rows_bwd.launches = 0
KERNELS = (
    blend_tiles_fwd, blend_tiles_bwd, blend_csr_fwd, blend_csr_bwd, blend_csr_dual_fwd, bin_slots,
    bin_count,
)


def reset_launch_counts() -> None:
    for fn in (*KERNELS, gather_rows_bwd):
        fn.launches = 0


class BlendTiles(torch.autograd.Function):
    """Differentiable tile blend: B1 forward (stashing entry logT when a
    gradient is needed) paired with the B2 analytic backward."""

    @staticmethod
    def forward(ctx, tile_data, tile_u0, tile_v0, n_channels):
        if not ctx.needs_input_grad[0]:
            return blend_tiles_fwd(tile_data, tile_u0, tile_v0, n_channels)
        accum, logt, entry = blend_tiles_fwd(
            tile_data, tile_u0, tile_v0, n_channels, with_entry=True
        )
        ctx.save_for_backward(tile_data, tile_u0, tile_v0, entry)
        ctx.n_channels = n_channels
        return accum, logt

    @staticmethod
    @once_differentiable
    def backward(ctx, g_accum, g_logt):
        tile_data, tile_u0, tile_v0, entry = ctx.saved_tensors
        t = tile_data.shape[0]
        if g_accum is None:
            g_accum = tile_data.new_zeros((t, PX, ctx.n_channels))
        if g_logt is None:
            g_logt = tile_data.new_zeros((t, PX))
        d_rows = blend_tiles_bwd(
            tile_data, tile_u0, tile_v0, entry,
            g_accum.contiguous(), g_logt.contiguous(), ctx.n_channels,
        )
        return d_rows, None, None, None


def blend_tiles(tile_data, tile_u0, tile_v0, n_channels=5):
    """Differentiable fused tile blend: (accum, log_transmittance)."""
    return BlendTiles.apply(tile_data, tile_u0, tile_v0, n_channels)


class BlendCSR(torch.autograd.Function):
    """Differentiable exact CSR blend: B3 forward (stashing each segment's
    entry logT when a gradient is needed) paired with the B4 analytic
    backward."""

    @staticmethod
    def forward(ctx, entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels):
        if not ctx.needs_input_grad[0]:
            return blend_csr_fwd(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels)
        accum, logt, entry = blend_csr_fwd(
            entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels, with_entry=True
        )
        ctx.save_for_backward(entry_data, seg_tile, seg_u0, seg_v0, entry)
        ctx.n_tiles, ctx.n_channels = n_tiles, n_channels
        return accum, logt

    @staticmethod
    @once_differentiable
    def backward(ctx, g_accum, g_logt):
        entry_data, seg_tile, seg_u0, seg_v0, entry = ctx.saved_tensors
        if g_accum is None:
            g_accum = entry_data.new_zeros((ctx.n_tiles, PX, ctx.n_channels))
        if g_logt is None:
            g_logt = entry_data.new_zeros((ctx.n_tiles, PX))
        d_data = blend_csr_bwd(
            entry_data, seg_tile, seg_u0, seg_v0, entry,
            g_accum.contiguous(), g_logt.contiguous(), ctx.n_tiles, ctx.n_channels,
        )
        return d_data, None, None, None, None, None


def blend_csr(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels=5):
    """Differentiable exact CSR blend: (accum, log_transmittance)."""
    return BlendCSR.apply(entry_data, seg_tile, seg_u0, seg_v0, n_tiles, n_channels)
