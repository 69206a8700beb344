"""SSIM and PSNR for the mapping loss (counterpart of
activesplat_tpu/ops/ssim.py).

Windowed SSIM of the reference (slam_external.py:66-97): 11x11 Gaussian
window, sigma 1.5, zero ('same') padding, C1=0.01^2, C2=0.03^2. The separable
blurs are the same banded-Toeplitz matrices as in the JAX package, applied as
float32 matmuls (TF32 is off, see device.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_C1 = 0.01**2
_C2 = 0.03**2


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _toeplitz_band(n: int, window_size: int, sigma: float, valid: bool) -> np.ndarray:
    """(n_out, n) banded blur matrix: row i holds the window centered at i
    ('same' zero padding) or at i+k//2 (VALID)."""
    win = _gaussian_window(window_size, sigma)
    k = window_size
    if valid:
        m = np.zeros((n - k + 1, n), np.float32)
        for i in range(n - k + 1):
            m[i, i : i + k] = win
    else:
        m = np.zeros((n, n), np.float32)
        for i in range(n):
            lo = max(0, i - k // 2)
            hi = min(n, i + k // 2 + 1)
            m[i, lo:hi] = win[lo - (i - k // 2) : hi - (i - k // 2)]
    return m


@functools.lru_cache(maxsize=16)
def _band_on(device: torch.device, n: int, window_size: int, sigma: float, valid: bool):
    """The blur matrix, copied to `device` once rather than every call."""
    return torch.from_numpy(_toeplitz_band(n, window_size, sigma, valid)).to(device)


def _blur_matmul(img: torch.Tensor, window_size: int, sigma: float, valid: bool):
    """Separable blur of an (H, W, C) image as two banded-Toeplitz matmuls."""
    h, w, c = img.shape
    kh = _band_on(img.device, h, window_size, sigma, valid)
    kw = _band_on(img.device, w, window_size, sigma, valid)
    x = torch.tensordot(kh, img, dims=([1], [0]))  # (H_out, W, C)
    return torch.einsum("hwc,vw->hvc", x, kw)  # (H_out, W_out, C)


def _blurred_moments(img_a, img_b, window_size, sigma, valid):
    stacked = torch.cat(
        [img_a, img_b, img_a * img_a, img_b * img_b, img_a * img_b], dim=-1
    )  # (H, W, 5C)
    blurred = _blur_matmul(stacked, window_size, sigma, valid)
    c = img_a.shape[-1]
    mu_a, mu_b, b_aa, b_bb, b_ab = (blurred[..., i * c : (i + 1) * c] for i in range(5))
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    return mu_aa, mu_bb, mu_ab, b_aa - mu_aa, b_bb - mu_bb, b_ab - mu_ab


def ssim(img_a: torch.Tensor, img_b: torch.Tensor, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM over (H, W, C) images in [0, 1]."""
    mu_aa, mu_bb, mu_ab, s_aa, s_bb, s_ab = _blurred_moments(
        img_a, img_b, window_size, sigma, valid=False
    )
    score = ((2 * mu_ab + _C1) * (2 * s_ab + _C2)) / (
        (mu_aa + mu_bb + _C1) * (s_aa + s_bb + _C2)
    )
    return score.mean()


def ssim_cs(img_a: torch.Tensor, img_b: torch.Tensor, window_size: int = 11, sigma: float = 1.5):
    """Per-channel (SSIM, contrast-structure) means over (H, W, C) images
    with VALID windowing (pytorch_msssim's `_ssim` semantics). Returns two
    (C,) tensors."""
    mu_aa, mu_bb, mu_ab, s_aa, s_bb, s_ab = _blurred_moments(
        img_a, img_b, window_size, sigma, valid=True
    )
    cs_map = (2 * s_ab + _C2) / (s_aa + s_bb + _C2)
    ssim_map = ((2 * mu_ab + _C1) / (mu_aa + mu_bb + _C1)) * cs_map
    return ssim_map.mean(dim=(0, 1)), cs_map.mean(dim=(0, 1))


def psnr(img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
    """PSNR in dB for images in [0, 1] (reference: calc_psnr,
    slam_external.py:49-51)."""
    mse = torch.mean((img_a - img_b) ** 2)
    return -10.0 * torch.log10(mse + 1e-12)
