"""LPIPS (alex) in PyTorch, weights-gated (counterpart of
activesplat_tpu/eval/lpips_jax.py).

The reference scores NVS quality with torchmetrics'
LearnedPerceptualImagePatchSimilarity(net_type='alex', normalize=True)
(eval_helpers.py:21-22, 485-487). The pretrained weights are not part of
the repository, so the metric runs only where a converted checkpoint is
named:

    ACTIVESPLAT_LPIPS_WEIGHTS=/path/to/lpips_alex.npz

The npz schema is the JAX package's (conv kernels HWIO, biases, linear
heads as (C,) vectors), so one file serves both packages;
`convert_torch_state_dict` makes it once from a torchmetrics or lpips
checkpoint.

Architecture (the LPIPS 'alex' pipeline):
  input [0,1] -> x*2-1 -> (x - shift)/scale   (the LPIPS ScalingLayer)
  AlexNet features with ReLU taps after conv1..conv5 (max-pooling before
  conv2 and conv3), per-tap channel-unit-normalize, squared difference,
  non-negative 1x1 linear head, spatial mean, sum over the 5 taps.
The convolutions are cuDNN's (F.conv2d) on the card; TF32 is off
(device.set_precision), as the JAX package computes them at
Precision.HIGHEST.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from activesplat_tpu_torch.device import DeviceLike, resolve_device

# (kernel, stride, pad, out_channels, maxpool_before)
ALEX_LAYERS = (
    (11, 4, 2, 64, False),
    (5, 1, 2, 192, True),
    (3, 1, 1, 384, True),
    (3, 1, 1, 256, False),
    (3, 1, 1, 256, False),
)
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)
NORM_EPS = 1e-10


def weights_path() -> Optional[str]:
    path = os.environ.get("ACTIVESPLAT_LPIPS_WEIGHTS")
    return path if path and os.path.exists(path) else None


def available() -> bool:
    return weights_path() is not None


def load_weights(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def random_weights(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Weights in the npz schema drawn from `rng` (conv kernels and biases
    N(0, 0.1), linear heads U(0, 1)): the pipeline runs on them where the
    pretrained ones are absent. The JAX package's tests draw theirs with
    the same recipe (tests/test_lpips.py make_weights)."""
    weights = {}
    c_in = 3
    for i, (k, _, _, c_out, _) in enumerate(ALEX_LAYERS):
        weights[f"conv{i}_w"] = rng.normal(0, 0.1, (k, k, c_in, c_out)).astype(np.float32)
        weights[f"conv{i}_b"] = rng.normal(0, 0.1, (c_out,)).astype(np.float32)
        weights[f"lin{i}_w"] = rng.uniform(0, 1, (c_out,)).astype(np.float32)
        c_in = c_out
    return weights


class LPIPSAlex(nn.Module):
    """LPIPS(alex) on weights in the npz schema (conv kernels HWIO, stored
    here as OIHW buffers)."""

    def __init__(self, weights: Mapping[str, np.ndarray]):
        super().__init__()
        for i in range(len(ALEX_LAYERS)):
            w = np.asarray(weights[f"conv{i}_w"], np.float32).transpose(3, 2, 0, 1)  # HWIO -> OIHW
            self.register_buffer(f"conv{i}_w", torch.from_numpy(np.ascontiguousarray(w)))
            self.register_buffer(f"conv{i}_b", torch.as_tensor(
                np.asarray(weights[f"conv{i}_b"], np.float32)))
            self.register_buffer(f"lin{i}_w", torch.as_tensor(
                np.asarray(weights[f"lin{i}_w"], np.float32).reshape(1, -1, 1, 1)))
        self.register_buffer("shift", torch.from_numpy(SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(SCALE).view(1, 3, 1, 1))

    def features(self, x: torch.Tensor):
        """AlexNet ReLU taps of a scaled (N, 3, H, W) batch."""
        taps = []
        for i, (_, stride, pad, _, pool_before) in enumerate(ALEX_LAYERS):
            if pool_before:
                x = F.max_pool2d(x, 3, stride=2)
            x = F.relu(F.conv2d(x, getattr(self, f"conv{i}_w"), getattr(self, f"conv{i}_b"),
                                stride=stride, padding=pad))
            taps.append(x)
        return taps

    def forward(self, img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
        """LPIPS of two (H, W, 3) images in [0, 1]: a 0-d tensor."""

        def prep(img):
            x = img.permute(2, 0, 1)[None] * 2.0 - 1.0
            return (x - self.shift) / self.scale

        # one batch of two images through the network
        taps = self.features(torch.cat([prep(img_a), prep(img_b)]))
        total = img_a.new_zeros(())
        for i, f in enumerate(taps):
            # normalize_tensor semantics: x / (||x|| + eps), eps outside the
            # sqrt (the lpips package's util)
            n = f / (torch.sqrt((f * f).sum(1, keepdim=True)) + NORM_EPS)
            diff2 = (n[0:1] - n[1:2]) ** 2
            total = total + (diff2 * getattr(self, f"lin{i}_w")).sum(1).mean()
        return total


# one network per (weights file, device): the AlexNet upload must not repeat
# per evaluated frame
_CACHE: Dict[tuple, LPIPSAlex] = {}


def network(weights: Optional[Mapping[str, np.ndarray]] = None,
            device: DeviceLike = None) -> Optional[LPIPSAlex]:
    """The LPIPS network on `device` for `weights`, or for the env-named
    file (cached), or None when neither exists."""
    dev = resolve_device(device)
    if weights is not None:
        return LPIPSAlex(weights).to(dev)
    path = weights_path()
    if path is None:
        return None
    key = (path, str(dev))
    if key not in _CACHE:
        _CACHE[key] = LPIPSAlex(load_weights(path)).to(dev)
    return _CACHE[key]


def lpips(img_a, img_b, weights: Optional[Mapping[str, np.ndarray]] = None,
          device: DeviceLike = None) -> Optional[float]:
    """LPIPS(alex) of two (H, W, 3) [0,1] images (numpy arrays or tensors),
    computed on `device`, or None when no weights are configured."""
    net = network(weights, device)
    if net is None:
        return None
    dev = net.shift.device

    def prep(img):
        if isinstance(img, torch.Tensor):
            x = img.detach().to(dev, torch.float32)
        else:
            x = torch.as_tensor(np.asarray(img, np.float32), device=dev)
        return x.clamp(0.0, 1.0)

    with torch.no_grad():
        return float(net(prep(img_a), prep(img_b)))


def convert_torch_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """Map a torchmetrics / lpips 'alex' state_dict into the npz schema.

    Handles both naming families: the lpips package's
    `net.slice{1..5}.<idx>.weight` + `lin{0..4}.model.1.weight`, and
    torchmetrics' `net.*` re-export of the same. Conv kernels convert
    OIHW -> HWIO; linear heads flatten to (C,)."""

    def host(v):
        return np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float32)

    out: Dict[str, np.ndarray] = {}
    convs = sorted(
        (k for k in state_dict if ".weight" in k and "slice" in k),
        key=lambda k: (int(k.split("slice")[1].split(".")[0]), k),
    )
    for i, wk in enumerate(convs):
        out[f"conv{i}_w"] = host(state_dict[wk]).transpose(2, 3, 1, 0)
        out[f"conv{i}_b"] = host(state_dict[wk.replace(".weight", ".bias")])
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in state_dict:
                out[f"lin{i}_w"] = host(state_dict[key]).reshape(-1)
    missing = {f"conv{i}_{s}" for i in range(5) for s in "wb"} | {f"lin{i}_w" for i in range(5)}
    missing -= set(out)
    if missing:
        raise ValueError(f"unrecognized LPIPS checkpoint; missing {sorted(missing)}")
    return out
