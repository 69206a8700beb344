"""Offline replay fit (counterpart of activesplat_tpu/runtime/offline_fit.py):
fit a Gaussian map to a recorded gaussians_data/ dump.

The CLI for BASELINE config 1 (the SplaTAM offline path the reference drives
via config/splatam): read a dumped dataset (gaussians_data/{rgb,depth,
transforms.json} — the byte layout the online mapper writes,
splatam/__init__.py:281-330), run the online mapping loop over its frames at
ground-truth poses on `device` (CUDA unless the caller names the CPU), save
params.npz, and report averaged PSNR / SSIM / MS-SSIM / depth metrics over
the fitted views.

    python -m activesplat_tpu_torch.runtime.offline_fit \
        --data results/<run>/gaussians_data --out /tmp/fit [--iters 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from activesplat_tpu_torch.device import DeviceLike, resolve_device
from activesplat_tpu_torch.eval.metrics import frame_report
from activesplat_tpu_torch.io.manifest import load_frame, load_manifest, manifest_intrinsics
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.mapper.splatam import SplaTAMMapper
from activesplat_tpu_torch.models.gaussians import make_camera
from activesplat_tpu_torch.ops.render import render


def fit_offline(
    gaussians_data_dir: str,
    cfg: Optional[MapperConfig] = None,
    out_dir: Optional[str] = None,
    frame_stride: int = 1,
    eval_stride: int = 1,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Fit a map to every ``frame_stride``-th dumped frame and return
    averaged eval metrics (psnr / ssim / ms_ssim / depth_l1 / depth_rmse,
    plus mapping timing). The eval render is the k-capped one of the
    mapping config (cfg.k_per_tile; 0 renders dense), as in the JAX
    package."""
    dev = resolve_device(device)
    manifest = load_manifest(gaussians_data_dir)
    intr = manifest_intrinsics(manifest)
    w, h = manifest["w"], manifest["h"]
    entries = manifest["frames"][::frame_stride]
    cfg = cfg or MapperConfig()
    mapper = SplaTAMMapper(cfg, w, h, intr, step_num=len(entries) + 1, results_dir=out_dir,
                           save_dataset=False, device=dev)
    frames = []
    for frame_id, entry in enumerate(entries):
        rgb, depth, w2c = load_frame(gaussians_data_dir, entry)
        c2w = np.linalg.inv(w2c)
        frames.append((rgb, depth, c2w))
        mapper.run({"rgb": rgb, "depth": depth, "c2w": c2w, "frame_id": frame_id})

    reports = []
    for rgb_gt, depth_gt, c2w in frames[::eval_stride]:
        cam = make_camera(w, h, intr, np.linalg.inv(c2w), device=dev)
        with torch.no_grad():
            out = render(mapper.buf, cam, chunk=cfg.chunk, k_per_tile=cfg.k_per_tile)
        reports.append(frame_report(out.rgb, rgb_gt, out.depth, depth_gt, device=dev))
    metrics = {k: float(np.mean([r[k] for r in reports])) for k in reports[0]}
    metrics["num_frames"] = len(frames)
    metrics["num_gaussians"] = int(mapper.num_gaussians())
    metrics["avg_mapping_iter_ms"] = (
        1000.0 * mapper.mapping_iter_time_sum / max(mapper.mapping_iter_time_count, 1)
    )
    if out_dir is not None:
        mapper.post_processing()
        with open(os.path.join(out_dir, "offline_fit_metrics.json"), "w") as fh:
            json.dump(metrics, fh, indent=2)
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser(description="Offline gaussians_data fit (PyTorch/CUDA)")
    parser.add_argument("--data", required=True, help="gaussians_data directory")
    parser.add_argument("--out", default=None, help="output results dir")
    parser.add_argument("--iters", type=int, default=None, help="mapping iters")
    parser.add_argument("--map_every", type=int, default=1)
    parser.add_argument("--kf_every", type=int, default=5)
    parser.add_argument("--frame_stride", type=int, default=1)
    parser.add_argument("--k_per_tile", type=int, default=256)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    cfg = MapperConfig(map_every=args.map_every, kf_every=args.kf_every,
                       k_per_tile=args.k_per_tile)
    if args.iters is not None:
        cfg = dataclasses.replace(cfg, mapping_iters=args.iters)
    metrics = fit_offline(args.data, cfg, out_dir=args.out, frame_stride=args.frame_stride,
                          device=args.device)
    print(json.dumps(metrics, indent=2))


if __name__ == "__main__":
    main()
