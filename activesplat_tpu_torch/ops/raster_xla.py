"""Dense chunked alpha-compositing rasterizer (counterpart of
activesplat_tpu/ops/raster_xla.py; the name is kept so that the module's
counterpart is easy to find).

Gaussians are depth-sorted once; a loop walks the sorted set in fixed-size
chunks, computes each chunk's (chunk, pixels) opacity matrix and composites it
with the running per-pixel log-transmittance

    T_g = exp( sum_{h<g} log(1 - alpha_h) ).

This is the render path for k_per_tile=0 and the port's own CPU oracle for
the tile-binned path. Each chunk is checkpointed, so the backward keeps
O(chunks * pixels) memory instead of O(gaussians * pixels).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ALPHA_MIN = 1.0 / 255.0  # per-pixel contribution cutoff (CUDA rasterizer parity)
ALPHA_MAX = 0.99  # max per-Gaussian alpha (CUDA rasterizer parity)


def _blend_chunk(accum, log_t, mean2d, conic, opacity, colors, valid, px, py):
    dx = mean2d[:, 0:1] - px[None, :]  # (G, P)
    dy = mean2d[:, 1:2] - py[None, :]
    a, b, c = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(opacity[:, None] * torch.exp(power), max=ALPHA_MAX)
    keep = (power <= 0.0) & (alpha >= ALPHA_MIN) & valid[:, None]
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    logs = torch.log1p(-alpha)
    cum = torch.cumsum(logs, 0)
    weight = alpha * torch.exp(cum - logs + log_t[None, :])  # (G, P)
    return accum + weight.T @ colors, log_t + cum[-1]


def rasterize_sorted(
    mean2d: torch.Tensor,  # (N, 2) depth-ascending order
    conic: torch.Tensor,  # (N, 3)
    opacity: torch.Tensor,  # (N,)
    colors: torch.Tensor,  # (N, C) channels to composite
    valid: torch.Tensor,  # (N,) bool
    *,
    width: int,
    height: int,
    chunk: int = 128,
    row_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front-to-back alpha compositing over pre-sorted Gaussians.

    `row_offset` renders rows [row_offset, row_offset + height) of a larger
    frame (the row-sharded render, parallel/sharded.py).

    Returns (accum (H*W, C), log_transmittance (H*W,))."""
    n = mean2d.shape[0]
    pad = -(-n // chunk) * chunk - n
    mean2d, conic, colors = (F.pad(x, (0, 0, 0, pad)) for x in (mean2d, conic, colors))
    opacity = F.pad(opacity, (0, pad))
    valid = F.pad(valid, (0, pad))

    p = width * height
    dev, dtype = colors.device, colors.dtype
    idx = torch.arange(p, dtype=dtype, device=dev)
    px = idx % width
    py = torch.floor(idx / width) + row_offset

    accum = torch.zeros((p, colors.shape[-1]), dtype=dtype, device=dev)
    log_t = torch.zeros((p,), dtype=dtype, device=dev)
    remat = torch.is_grad_enabled()
    for s in range(0, n + pad, chunk):
        args = (
            mean2d[s : s + chunk], conic[s : s + chunk], opacity[s : s + chunk],
            colors[s : s + chunk], valid[s : s + chunk], px, py,
        )
        if remat:
            accum, log_t = checkpoint(
                _blend_chunk, accum, log_t, *args, use_reentrant=False
            )
        else:
            accum, log_t = _blend_chunk(accum, log_t, *args)
    return accum, log_t


def depth_sort(depth: torch.Tensor, valid: torch.Tensor, *arrays):
    """Sort per-Gaussian arrays by camera depth, invalid entries last. The
    ordering is a constant for autograd (the CUDA reference sorts by a
    detached key)."""
    key = torch.where(valid, depth.detach(), torch.full_like(depth, float("inf")))
    order = torch.argsort(key, stable=True)
    return tuple(x[order] for x in ((depth, valid) + arrays))
