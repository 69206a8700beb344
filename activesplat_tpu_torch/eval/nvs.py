"""Novel-view-synthesis evaluation of a fitted Gaussian map (counterpart of
activesplat_tpu/eval/nvs.py).

eval_nvs parity (reference: src/mapper/splatam/utils/eval_helpers.py:627-806):
for each held-out view, render rgb/depth/silhouette from the map; a frame is
a VALID novel view when < 0.1% of its pixels are holes (silhouette below
sil_thres while GT depth is valid); metrics are valid-depth-masked PSNR,
MS-SSIM, LPIPS (when weights exist) and depth L1/RMSE normalized by the
valid-pixel count, averaged over valid frames only. The render and every
metric run on `device` (CUDA unless the caller names the CPU), one host
read per frame and one more for LPIPS.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from activesplat_tpu_torch.device import DeviceLike, resolve_device
from activesplat_tpu_torch.eval import lpips as lpips_alex
from activesplat_tpu_torch.eval.metrics import ms_ssim_safe
from activesplat_tpu_torch.io.manifest import load_frame, load_manifest, manifest_intrinsics
from activesplat_tpu_torch.io.params_io import buffer_from_params, load_params
from activesplat_tpu_torch.models.gaussians import GaussianBuffer, make_camera
from activesplat_tpu_torch.ops.render import render
from activesplat_tpu_torch.ops.ssim import psnr

NVS_KEYS = ("psnr", "ms_ssim", "depth_rmse", "depth_l1")


def eval_nvs(
    buf: GaussianBuffer,
    frames: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],  # (rgb, depth, c2w)
    intrinsics: np.ndarray,
    width: int,
    height: int,
    sil_thres: float = 0.98,
    eval_every: int = 1,
    chunk: int = 256,
    k_per_tile: int = 0,
    mask_with_silhouette: bool = False,  # mapping_iters==0 mode (eval_helpers.py:706)
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Returns averaged psnr / ms_ssim / depth_rmse / depth_l1 (+ lpips when
    available) over valid novel views, plus the valid-frame ratio. The map
    `buf` must lie on `device`. k_per_tile > 0 renders exactly over CSR
    runs (B3, forward only); 0 with the dense rasterizer."""
    dev = resolve_device(device)
    net = lpips_alex.network(device=dev)
    per_frame: List[Dict[str, float]] = []
    valid_flags: List[bool] = []
    for idx, (rgb_gt, depth_gt, c2w) in enumerate(frames):
        if idx != 0 and (idx + 1) % eval_every != 0:
            continue
        cam = make_camera(width, height, intrinsics, np.linalg.inv(c2w), device=dev)
        rgb_gt = torch.as_tensor(np.asarray(rgb_gt, np.float32), device=dev)
        depth_gt = torch.as_tensor(np.asarray(depth_gt, np.float32), device=dev)
        with torch.no_grad():
            out = render(buf, cam, chunk=chunk, k_per_tile=k_per_tile, exact=k_per_tile > 0)
            valid_depth = depth_gt > 0
            presence = out.alpha > sil_thres
            holes = ~(presence | ~valid_depth)
            pix_mask = valid_depth & presence if mask_with_silhouette else valid_depth
            w_im = out.rgb * pix_mask[..., None]
            w_gt = rgb_gt * pix_mask[..., None]
            n_valid = valid_depth.sum().clamp_min(1)
            d_err = out.depth - depth_gt
            if mask_with_silhouette:
                d_err = d_err * presence
            d_err = d_err * valid_depth
            values = torch.stack([
                psnr(w_im, w_gt),
                ms_ssim_safe(w_im, w_gt),
                # NOT a true RMSE: sqrt applies per pixel, so this equals
                # the masked L1 — a quirk replicated from the reference
                # (eval_helpers.py eval_nvs: torch.sqrt((diff**2))
                # elementwise); metrics.depth_metrics computes the real RMSE
                torch.sqrt(d_err**2).sum() / n_valid,
                d_err.abs().sum() / n_valid,
                holes.sum().float(),
            ]).double().tolist()
            report = dict(zip(NVS_KEYS, values))
            if net is not None:
                report["lpips"] = float(net(w_im.clamp(0.0, 1.0), w_gt.clamp(0.0, 1.0)))
        valid_flags.append(values[-1] / holes.numel() * 100 <= 0.1)
        per_frame.append(report)

    valid = np.asarray(valid_flags)
    if not valid.any():
        return {"valid_frame_ratio": 0.0, "num_eval_frames": len(per_frame)}
    out = {
        k: float(np.mean([r[k] for r, v in zip(per_frame, valid) if v]))
        for k in per_frame[0]
    }
    out["valid_frame_ratio"] = float(valid.mean())
    out["num_eval_frames"] = len(per_frame)
    return out


def eval_nvs_from_dump(
    params_path: str,
    gaussians_data_dir: str,
    holdout_every: int = 5,
    device: DeviceLike = None,
    **kwargs,
) -> Dict[str, float]:
    """NVS eval on a gaussians_data dump: frames NOT in the training split
    (every ``holdout_every``-th, offset 1 — the first train frame is skipped
    as in the reference, eval_helpers.py:663-664) score the saved map."""
    dev = resolve_device(device)
    buf = buffer_from_params(load_params(params_path), device=dev)
    manifest = load_manifest(gaussians_data_dir)
    frames = []
    for i, entry in enumerate(manifest["frames"]):
        if i % holdout_every != 1:  # hold-out split
            continue
        rgb, depth, w2c = load_frame(gaussians_data_dir, entry)
        frames.append((rgb, depth, np.linalg.inv(w2c)))
    return eval_nvs(buf, frames, manifest_intrinsics(manifest), manifest["w"], manifest["h"],
                    device=dev, **kwargs)
