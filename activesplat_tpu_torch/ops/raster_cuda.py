"""The tile blend: hand-written CUDA kernels, their plain PyTorch twins, and
the autograd Function that pairs them (counterpart of
activesplat_tpu/ops/raster_pallas.py, kernels B1 and B2).

A tile's K depth-ordered Gaussians arrive as (K, 16) float32 rows
[mx, my, a, b, c, opacity, col0..col7, pad, pad]; the forward composites
them front to back over the tile's 16x16 pixels, in SEG=64-row segments, and
stops walking a tile once every pixel's log-transmittance is below LOG_EPS
(tested at each segment start). The backward walks the segments back to
front from the forward's stashed per-segment entry log-transmittance.

Each wrapper launches its CUDA kernel (csrc/blend_fwd.cu, csrc/blend_bwd.cu)
for a CUDA tensor, or raises; it runs its twin only for a tensor that lies on
the CPU. The twins run the same algorithm in float32: the same segments,
early exit and clamps, with a vectorised in-segment cumsum. The backward twin
is the explicit analytic formula, not autograd. Each wrapper counts its
launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from activesplat_tpu_torch import _build
from activesplat_tpu_torch.ops.raster_xla import ALPHA_MAX, ALPHA_MIN

TILE = 16
PX = TILE * TILE  # 256 pixels per tile
SEG = 64  # rows per segment
N_ATTR = 16  # padded attribute count
MAX_CHANNELS = 8
LOG_EPS = -5.55  # log(1/256): tile saturated below this transmittance

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


def blend_tiles_fwd_plain(tile_data, tile_u0, tile_v0, n_channels=5, with_entry=False):
    """The forward kernel's algorithm in PyTorch (the CPU path)."""
    t, k, _ = tile_data.shape
    px, py = _pixel_coords(tile_u0, tile_v0)
    accum = tile_data.new_zeros((t, PX, MAX_CHANNELS))
    logt = tile_data.new_zeros((t, PX))
    entries = []
    for s in range(k // SEG):
        entries.append(logt)
        walk = logt.amax(dim=1) >= LOG_EPS  # (T,) tile not yet saturated
        block = tile_data[:, s * SEG : (s + 1) * SEG]
        alpha = _segment_geometry(block, px, py)[4]
        logs = torch.log1p(-alpha)
        cum = torch.cumsum(logs, dim=1)
        weight = alpha * torch.exp(cum - logs + logt[:, None, :])  # (T, SEG, PX)
        contrib = torch.einsum("tsp,tsc->tpc", weight, block[:, :, 6 : 6 + MAX_CHANNELS])
        accum = torch.where(walk[:, None, None], accum + contrib, accum)
        logt = torch.where(walk[:, None], logt + cum[:, -1], logt)
    accum = accum[:, :, :n_channels].contiguous()
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
        logt_in = entry[:, s]  # (T, PX)
        walk = logt_in.amax(dim=1) >= LOG_EPS
        block = tile_data[:, s * SEG : (s + 1) * SEG]
        ca, cb, cc = (block[:, :, i : i + 1] for i in range(2, 5))
        dx, dy, power, raw, alpha, live = _segment_geometry(block, px, py)
        unclipped = live & (raw < ALPHA_MAX)
        logs = torch.log1p(-alpha)
        prefix = torch.cumsum(logs, dim=1) - logs
        t_k = torch.exp(logt_in[:, None, :] + prefix)  # (T, SEG, PX)
        s_k = torch.einsum("tsc,tpc->tsp", block[:, :, 6 : 6 + MAX_CHANNELS], g)
        w = alpha * t_k
        ws = w * s_k
        # exclusive suffix sum: total - inclusive prefix
        b_k = b[:, None, :] + (ws.sum(dim=1, keepdim=True) - torch.cumsum(ws, dim=1))
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
        )  # (T, SEG, 14)
        d_rows[:, s * SEG : (s + 1) * SEG, :14] = torch.where(
            walk[:, None, None], d_block, torch.zeros_like(d_block)
        )
        b = torch.where(walk[:, None], b + ws.sum(dim=1), b)
    return d_rows


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #


def _kernel(library: str, symbol: str, n_args: int):
    fn = getattr(_build.load(library), symbol)
    if fn.argtypes is None:
        fn.argtypes = [_P if i not in _INT_ARGS[symbol] else _I for i in range(n_args)]
        fn.restype = ctypes.c_int
    return fn


# positions of the int arguments of each C entry point (the rest are pointers)
_INT_ARGS = {"blend_tiles_fwd": (3, 4, 5), "blend_tiles_bwd": (6, 7, 8)}


def blend_tiles_fwd(tile_data, tile_u0, tile_v0, n_channels=5, with_entry=False):
    """B1. Returns (accum (T, PX, n_channels), log_transmittance (T, PX)
    [, entry (T, K/SEG, PX)]): `entry` is each segment's entry
    log-transmittance, the backward's residual."""
    _check_rows(tile_data, tile_u0, tile_v0, n_channels)
    if _device_kind(tile_data) == "cpu":
        return blend_tiles_fwd_plain(tile_data, tile_u0, tile_v0, n_channels, with_entry)
    t, k, _ = tile_data.shape
    accum = tile_data.new_empty((t, PX, n_channels))
    logt = tile_data.new_empty((t, PX))
    entry = tile_data.new_empty((t, k // SEG, PX)) if with_entry else None
    fn = _kernel("blend_fwd", "blend_tiles_fwd", 10)
    with torch.cuda.device(tile_data.device):
        ptrs = _cuda_args(tile_data, tile_u0, tile_v0, accum, logt)
        rc = fn(
            *ptrs[:3], t, k, n_channels, *ptrs[3:],
            None if entry is None else _cuda_args(entry)[0],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"blend_tiles_fwd launch failed: CUDA error {rc}")
    blend_tiles_fwd.launches += 1
    if with_entry:
        return accum, logt, entry
    return accum, logt


def blend_tiles_bwd(tile_data, tile_u0, tile_v0, entry, g_accum, g_logt, n_channels=5):
    """B2. Gradient of blend_tiles_fwd with respect to the rows: (T, K, 16),
    columns 14 and 15 zero."""
    _check_rows(tile_data, tile_u0, tile_v0, n_channels)
    t, k, _ = tile_data.shape
    for name, x, shape in (
        ("entry", entry, (t, k // SEG, PX)),
        ("g_accum", g_accum, (t, PX, n_channels)),
        ("g_logt", g_logt, (t, PX)),
    ):
        if x.shape != shape or x.dtype != torch.float32 or x.device != tile_data.device:
            raise ValueError(f"{name} must be {shape} float32 on the rows' device")
    if _device_kind(tile_data) == "cpu":
        return blend_tiles_bwd_plain(
            tile_data, tile_u0, tile_v0, entry, g_accum, g_logt, n_channels
        )
    d_rows = torch.empty_like(tile_data)
    fn = _kernel("blend_bwd", "blend_tiles_bwd", 11)
    with torch.cuda.device(tile_data.device):
        ptrs = _cuda_args(tile_data, tile_u0, tile_v0, entry, g_accum, g_logt, d_rows)
        rc = fn(
            *ptrs[:6], t, k, n_channels, ptrs[6],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"blend_tiles_bwd launch failed: CUDA error {rc}")
    blend_tiles_bwd.launches += 1
    return d_rows


blend_tiles_fwd.launches = 0
blend_tiles_bwd.launches = 0
KERNELS = (blend_tiles_fwd, blend_tiles_bwd)


def reset_launch_counts() -> None:
    for fn in KERNELS:
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
