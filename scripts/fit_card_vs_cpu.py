#!/usr/bin/env python3
"""Where fit_offline on the card parts from fit_offline on the CPU.

    python3 scripts/fit_card_vs_cpu.py

Records chip_smoke.py's small episode on the CPU (single_room, 48x48, 18
steps; the keyframe picks made deterministic, the current frame every
iteration), then runs fit_offline on its dump with the small episode's
mapper config on the CPU and twice on the card, the picks deterministic.
Prints, for every Adam step, each parameter field's largest gradient, the
count of gradients above 1e-6 of it, how many of those change sign
between the devices and their relative error (median, 99th percentile);
after every frame, each field's largest parameter difference and the share
of parameters off by more than 1e-4 + 1e-4 |x|; the end metrics of the
three fits; and whether the card's two fits are bitwise equal. Needs one
CUDA card.
"""

import importlib.util
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
FIELDS = ("means3d", "rgb", "quats", "logit_opacities", "log_scales")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fit_card_vs_cpu: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from activesplat_tpu_torch.mapper import splatam, step
    from activesplat_tpu_torch.mapper.config import MapperConfig
    from activesplat_tpu_torch.runtime.dataloader import RGBDSensor, SyntheticDataset
    from activesplat_tpu_torch.runtime.launch import run_episode
    from activesplat_tpu_torch.runtime.offline_fit import fit_offline
    from activesplat_tpu_torch.runtime.synthetic import BoxWorld

    card = smoke.nvidia_smi("name,power.limit")
    cfg = smoke.SMALL_EPISODE
    rand = torch.rand
    torch.rand = lambda *a, **k: torch.full_like(rand(*a, **k), 1 - 2.0**-24)
    grads, params, metrics = {}, {}, {}
    real_adam, real_run = step.adam_update, splatam.SplaTAMMapper.run

    def adam(p, g, *a, **k):
        grads[key].append([t.detach().cpu() for t in g.tensors()])
        return real_adam(p, g, *a, **k)

    def run(self, batch):
        out = real_run(self, batch)
        params[key].append([t.detach().cpu().clone() for t in self.buf.params.tensors()])
        return out

    with tempfile.TemporaryDirectory() as tmp:
        np.random.seed(0)
        sensor = RGBDSensor.from_fov(cfg["res"], cfg["res"], 90.0, depth_min=0.0, depth_max=10.0)
        ds = SyntheticDataset(BoxWorld.single_room(seed=2), sensor, step_num=cfg["steps"],
                              start_position=np.array(cfg["start"]), turn_angle_deg=cfg["turn"],
                              tilt_angle_deg=15.0, results_dir=tmp, scene_id="small")
        run_episode(ds, tmp, mapper_cfg=MapperConfig(**smoke.SMALL_EPISODE_CFG), pixel_max=56,
                    max_ticks=300, pano_scale=0.4, device="cpu")
        step.adam_update, splatam.SplaTAMMapper.run = adam, run
        try:
            for key, dev in (("cpu", "cpu"), ("card", "cuda"), ("card again", "cuda")):
                grads[key], params[key] = [], []
                metrics[key] = fit_offline(os.path.join(tmp, "gaussians_data"),
                                           MapperConfig(**smoke.SMALL_EPISODE_CFG), device=dev)
        finally:
            step.adam_update, splatam.SplaTAMMapper.run = real_adam, real_run
            torch.rand = rand

    print(f"gradients handed to Adam, card against CPU, on {card}:")
    for i, (ga, gb) in enumerate(zip(grads["cpu"], grads["card"])):
        row = []
        for name, x, y in zip(FIELDS, ga, gb):
            sig = x.abs() > 1e-6 * x.abs().max()
            flips = int((sig & (torch.sign(x) != torch.sign(y))).sum())
            rel = ((x - y).abs() / x.abs())[sig]
            q = (float(rel.median()), float(rel.quantile(0.99))) if rel.numel() else (0.0, 0.0)
            row.append(f"{name} max {float(x.abs().max()):.2e} significant {int(sig.sum())} "
                       f"sign flips {flips} rel p50 {q[0]:.1e} p99 {q[1]:.1e}")
        print(f"  step {i}: " + "; ".join(row))
    print("parameters after each frame, card against CPU (largest difference / share off):")
    for f, (pa, pb) in enumerate(zip(params["cpu"], params["card"])):
        cells = []
        for name, x, y in zip(FIELDS, pa, pb):
            err = (x - y).abs()
            off = float((err > 1e-4 + 1e-4 * x.abs()).float().mean())
            cells.append(f"{name} {float(err.max()):.2e}/{off:.1e}")
        print(f"  frame {f}: " + ", ".join(cells))
    same = all(torch.equal(x, y) for pa, pb in zip(params["card"], params["card again"])
               for x, y in zip(pa, pb))
    print(f"the card's two fits bitwise equal: {same}")
    for key, m in metrics.items():
        print(f"{key}: " + ", ".join(f"{k} {v}" for k, v in m.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
