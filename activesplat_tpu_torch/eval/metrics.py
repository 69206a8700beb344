"""Image, depth and trajectory quality metrics (counterpart of
activesplat_tpu/eval/metrics.py).

The reference's metric suite (src/mapper/splatam/utils/eval_helpers.py;
BASELINE.md): PSNR, MS-SSIM, LPIPS, depth L1/RMSE, ATE RMSE. The image
metrics run in float32 on `device` (CUDA unless the caller names the CPU),
SSIM's blurs as banded matmuls with TF32 off (ops/ssim.py); the depth and
trajectory metrics run in numpy on the host, as in the JAX package. LPIPS
runs on the converted AlexNet weights that ACTIVESPLAT_LPIPS_WEIGHTS names
(eval/lpips.py) and is absent without them; the JAX package's torchmetrics
branch is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from activesplat_tpu_torch.device import DeviceLike, resolve_device
from activesplat_tpu_torch.eval import lpips as lpips_alex
from activesplat_tpu_torch.ops.ssim import psnr as _psnr, ssim as _ssim, ssim_cs

SCORE_KEYS = ("psnr", "ssim", "ms_ssim", "depth_l1", "depth_rmse")
# pytorch_msssim's level weights
MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _image(x, dev: torch.device) -> torch.Tensor:
    """A float32 tensor on `dev` from a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def psnr(img_a, img_b, device: DeviceLike = None) -> float:
    dev = resolve_device(device)
    return float(_psnr(_image(img_a, dev), _image(img_b, dev)))


def ssim(img_a, img_b, device: DeviceLike = None) -> float:
    dev = resolve_device(device)
    return float(_ssim(_image(img_a, dev), _image(img_b, dev)))


def ms_ssim_levels(height: int, width: int, max_levels: int = 5) -> int:
    """Largest pyramid depth whose coarsest level still fits the 11-px VALID
    SSIM window UNDER TRUNCATING 2x downsampling (size -> size // 2 per
    level; the naive `min_side > 10 * 2**(L-1)` bound over-admits borderline
    sizes like 42 px, whose truncated pyramid 42->20->10 leaves no valid
    window)."""
    size = min(height, width)
    levels = 0
    while levels < max_levels and size >= 11:
        levels += 1
        size //= 2
    return max(levels, 1)


def ms_ssim(img_a, img_b, levels: int = 5, device: DeviceLike = None) -> float:
    """Multi-scale SSIM matching `pytorch_msssim.ms_ssim` (the reference's
    eval metric, eval_helpers.py:483-484): per level, VALID-windowed SSIM;
    the contrast-structure term at levels 0..L-2 and the full SSIM only at
    the coarsest level; relu-clamped per-channel means; weighted
    per-channel product, then mean over channels. 2x average-pool between
    levels, odd sizes truncated.

    Every pyramid level must fit the 11-px window (ms_ssim_levels picks a
    legal depth)."""
    dev = resolve_device(device)
    a = _image(img_a, dev)
    b = _image(img_b, dev)
    if a.ndim == 2:
        a = a[:, :, None]
        b = b[:, :, None]
    if ms_ssim_levels(a.shape[0], a.shape[1], levels) < levels:
        raise ValueError(f"image {tuple(a.shape[:2])} too small for {levels}-level MS-SSIM")
    return float(ms_ssim_torch(a, b, levels))


def _halve(x: torch.Tensor) -> torch.Tensor:
    """2x average pool of an (H, W, C) image, odd sizes truncated, in the
    JAX package's order of summation."""
    h = (x.shape[0] // 2) * 2
    w = (x.shape[1] // 2) * 2
    return (x[:h:2, :w:2] + x[1:h:2, :w:2] + x[:h:2, 1:w:2] + x[1:h:2, 1:w:2]) / 4.0


def ms_ssim_torch(a: torch.Tensor, b: torch.Tensor, levels: int) -> torch.Tensor:
    """The tensor core of ms_ssim on (H, W, C) float32 images (counterpart
    of ms_ssim_jax): stays on the images' device, so scorers fetch one
    value per frame. Callers validate `levels` with ms_ssim_levels()."""
    weights = torch.tensor(MS_SSIM_WEIGHTS[:levels], dtype=torch.float32, device=a.device)
    per_level = []  # (C,) tensors: cs at 0..L-2, ssim at L-1
    for level in range(levels):
        ssim_pc, cs_pc = ssim_cs(a, b)
        per_level.append(torch.relu(ssim_pc if level == levels - 1 else cs_pc))
        if level < levels - 1:
            a, b = _halve(a), _halve(b)
    stacked = torch.stack(per_level)  # (levels, C)
    return torch.prod(stacked ** weights[:, None], dim=0).mean()


def ms_ssim_safe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """MS-SSIM at the deepest pyramid the (H, W, C) images support (5 at
    the reference's 256 px, fewer for small frames); below the 11-px VALID
    window no level fits, so single-scale SSIM (gaussian-windowed) stands
    in."""
    if min(a.shape[0], a.shape[1]) < 11:
        return _ssim(a, b)
    return ms_ssim_torch(a, b, ms_ssim_levels(a.shape[0], a.shape[1]))


def depth_metrics(depth_pred: np.ndarray, depth_gt: np.ndarray) -> Tuple[float, float]:
    """(L1, RMSE) over valid GT depth (eval_helpers.py:236-245)."""
    depth_pred, depth_gt = _host(depth_pred), _host(depth_gt)
    mask = depth_gt > 0
    if not mask.any():
        return 0.0, 0.0
    diff = depth_pred[mask] - depth_gt[mask]
    return float(np.abs(diff).mean()), float(np.sqrt((diff**2).mean()))


def align_trajectories(est: np.ndarray, gt: np.ndarray):
    """Horn alignment of (N, 3) trajectories: returns (rot, trans,
    per-point residuals) (evaluate_ate semantics, eval_helpers.py:24-79)."""
    est = np.asarray(est, np.float64).T  # (3, N)
    gt = np.asarray(gt, np.float64).T
    est_c = est - est.mean(1, keepdims=True)
    gt_c = gt - gt.mean(1, keepdims=True)
    w = est_c @ gt_c.T
    u, _, vt = np.linalg.svd(w)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    rot = (u @ s @ vt).T  # maps est -> gt
    trans = gt.mean(1, keepdims=True) - rot @ est.mean(1, keepdims=True)
    residuals = np.linalg.norm(rot @ est + trans - gt, axis=0)
    return rot, trans, residuals


def ate_rmse(est_c2w: np.ndarray, gt_c2w: np.ndarray) -> float:
    """ATE RMSE over (N, 4, 4) pose arrays."""
    _, _, residuals = align_trajectories(est_c2w[:, :3, 3], gt_c2w[:, :3, 3])
    return float(np.sqrt((residuals**2).mean()))


def lpips_available() -> bool:
    """Whether ACTIVESPLAT_LPIPS_WEIGHTS names a weights file."""
    return lpips_alex.available()


def lpips(img_a, img_b, device: DeviceLike = None) -> Optional[float]:
    """LPIPS(alex) of two (H, W, 3) images on `device`, or None when no
    weights are configured (eval_helpers.py:16,485-487)."""
    return lpips_alex.lpips(img_a, img_b, device=device)


def frame_scores(
    rgb_pred: torch.Tensor,
    rgb_gt: torch.Tensor,
    depth_pred: torch.Tensor,
    depth_gt: torch.Tensor,
    levels: int,
) -> torch.Tensor:
    """(5,) scores [psnr, ssim, ms_ssim, depth_l1, depth_rmse] of one frame
    on the tensors' device, mirroring frame_report (counterpart of
    frame_scores_jax): the caller reads the five values in one copy.
    levels 0 scores MS-SSIM as SSIM (images below the 11-px window)."""
    # unclamped, like frame_report and the reference's eval (only LPIPS
    # clamps, eval_helpers.py:485-486)
    a = rgb_pred.float()
    b = rgb_gt.float()
    mask = depth_gt > 0
    n_valid = mask.sum().clamp_min(1)
    diff = torch.where(mask, depth_pred - depth_gt, 0.0)
    l1 = diff.abs().sum() / n_valid
    rmse = torch.sqrt((diff * diff).sum() / n_valid)
    ssim_val = _ssim(a, b)
    ms_val = ms_ssim_torch(a, b, levels) if levels >= 1 else ssim_val
    return torch.stack([_psnr(a, b), ssim_val, ms_val, l1, rmse])


def frame_report(rgb_pred, rgb_gt, depth_pred, depth_gt,
                 device: DeviceLike = None) -> Dict[str, float]:
    """psnr / ssim / ms_ssim (on `device`), depth_l1 / depth_rmse (numpy on
    the host) and lpips where weights exist, of one frame. The images may
    be numpy arrays or tensors."""
    dev = resolve_device(device)
    l1, rmse = depth_metrics(depth_pred, depth_gt)
    a, b = _image(rgb_pred, dev), _image(rgb_gt, dev)
    p, s, m = torch.stack([_psnr(a, b), _ssim(a, b), ms_ssim_safe(a, b)]).tolist()
    out = {"psnr": p, "ssim": s, "ms_ssim": m, "depth_l1": l1, "depth_rmse": rmse}
    value = lpips_alex.lpips(a, b, device=dev)
    if value is not None:
        out["lpips"] = value
    return out
