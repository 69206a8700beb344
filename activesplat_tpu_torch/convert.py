"""State carried across from the JAX package.

The JAX package's map, cameras and keyframes, given as numpy arrays, become
the port's tensors on a chosen device; `buffer_to_numpy` goes the other way
for the parity tests. Nothing here imports the JAX package: callers hand over
plain arrays (for a JAX pytree, `np.asarray` of each leaf).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from activesplat_tpu_torch.device import DeviceLike, resolve_device
from activesplat_tpu_torch.mapper.keyframes import KeyframeStore
from activesplat_tpu_torch.models.gaussians import (
    PARAM_FIELDS,
    Camera,
    GaussianBuffer,
    GaussianParams,
    make_camera,
)

BUFFER_FIELDS = ("active", "timestep", "max_radius", "grad_accum", "denom")


def _tensor(x, dev: torch.device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=dev)


def buffer_from_numpy(d: Mapping[str, np.ndarray], device: DeviceLike = None):
    """GaussianBuffer from the keys means3d, rgb, quats, logit_opacities,
    log_scales, active, timestep, max_radius, grad_accum, denom."""
    dev = resolve_device(device)
    params = GaussianParams(*(_tensor(d[f], dev) for f in PARAM_FIELDS))
    return GaussianBuffer(
        params=params,
        active=_tensor(d["active"], dev, torch.bool),
        **{f: _tensor(d[f], dev) for f in BUFFER_FIELDS[1:]},
    )


def buffer_to_numpy(buf: GaussianBuffer) -> Dict[str, np.ndarray]:
    """The inverse of buffer_from_numpy."""
    out = {f: getattr(buf.params, f).detach().cpu().numpy() for f in PARAM_FIELDS}
    for f in BUFFER_FIELDS:
        out[f] = getattr(buf, f).detach().cpu().numpy()
    return out


def camera_from_numpy(d: Mapping, device: DeviceLike = None) -> Camera:
    """Camera from the keys width, height, fx, fy, cx, cy, w2c and, if
    present, near and far."""
    intr = np.array(
        [
            [float(d["fx"]), 0.0, float(d["cx"])],
            [0.0, float(d["fy"]), float(d["cy"])],
            [0.0, 0.0, 1.0],
        ]
    )
    return make_camera(
        int(d["width"]),
        int(d["height"]),
        intr,
        np.asarray(d["w2c"], np.float32),
        near=float(d.get("near", 0.01)),
        far=float(d.get("far", 100.0)),
        device=device,
    )


def keyframes_from_numpy(d: Mapping, device: DeviceLike = None) -> KeyframeStore:
    """KeyframeStore from the keys rgb, depth, w2c, frame_id and count."""
    dev = resolve_device(device)
    return KeyframeStore(
        rgb=_tensor(d["rgb"], dev),
        depth=_tensor(d["depth"], dev),
        w2c=_tensor(d["w2c"], dev),
        frame_id=_tensor(d["frame_id"], dev, torch.int32),
        count=int(np.asarray(d["count"])),
    )
