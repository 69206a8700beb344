"""Keyframe storage and overlap-based selection on the device (counterpart of
activesplat_tpu/mapper/keyframes.py).

A fixed-capacity store of keyframe rgb/depth/w2c tensors; the per-iteration
keyframe gather of a mapping event reads it without a host round trip.
Selection follows the reference (keyframe_selection_overlap,
keyframe_selection.py:40-96): sample valid-depth pixels of the current frame,
backproject, project into each stored keyframe, keep keyframes with any
in-view overlap, and pick k of them uniformly at random.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from activesplat_tpu_torch.device import DeviceLike, resolve_device
from activesplat_tpu_torch.mapper.geometry import backproject


@dataclasses.dataclass
class KeyframeStore:
    rgb: torch.Tensor  # (K, H, W, 3) f32
    depth: torch.Tensor  # (K, H, W) f32
    w2c: torch.Tensor  # (K, 4, 4) f32
    frame_id: torch.Tensor  # (K,) i32, -1 = empty
    count: int  # number of committed keyframes (host-side bookkeeping)

    @staticmethod
    def empty(capacity: int, height: int, width: int, device: DeviceLike = None):
        dev = resolve_device(device)
        return KeyframeStore(
            rgb=torch.zeros((capacity, height, width, 3), dtype=torch.float32, device=dev),
            depth=torch.zeros((capacity, height, width), dtype=torch.float32, device=dev),
            w2c=torch.eye(4, dtype=torch.float32, device=dev).repeat(capacity, 1, 1),
            frame_id=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
            count=0,
        )

    @property
    def capacity(self) -> int:
        return self.rgb.shape[0]

    @property
    def scratch_slot(self) -> int:
        """Last slot, reserved for the *current frame* during a mapping
        event (splatam/__init__.py:434-436)."""
        return self.capacity - 1

    def _write(self, slot: int, rgb, depth, w2c, frame_id) -> None:
        self.rgb[slot] = rgb
        self.depth[slot] = depth
        self.w2c[slot] = w2c
        self.frame_id[slot] = frame_id

    def with_scratch(self, rgb, depth, w2c, frame_id) -> "KeyframeStore":
        """Write the current frame into the scratch slot, in place (the store
        is large; the JAX package returns a new pytree instead)."""
        self._write(self.scratch_slot, rgb, depth, w2c, frame_id)
        return self

    def committed(self, rgb, depth, w2c, frame_id) -> "KeyframeStore":
        """Append a keyframe at the next free slot, in place (capacity - 1 is
        scratch; overflow overwrites the last regular slot)."""
        self._write(min(self.count, self.capacity - 2), rgb, depth, w2c, frame_id)
        self.count = min(self.count + 1, self.capacity - 1)
        return self


def select_keyframes_overlap(
    store: KeyframeStore,
    depth_cur: torch.Tensor,  # (H, W)
    w2c_cur: torch.Tensor,  # (4, 4)
    fx,
    fy,
    cx,
    cy,
    generator: torch.Generator,
    num_select: int,
    pixels: int = 1600,
    edge: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (selected slot ids (num_select,), valid mask (num_select,)).

    Only keyframes with slot < count - 1 participate (the last committed
    keyframe is added separately by the caller, splatam/__init__.py:428-433).
    `generator` lies on the store's device."""
    h, w = depth_cur.shape
    dev = depth_cur.device
    flat_depth = depth_cur.reshape(-1)
    valid_px = flat_depth > 0
    # uniform over all pixels when none has depth (multinomial needs mass)
    weights = valid_px.float() + (~valid_px.any()).float()
    px_idx = torch.multinomial(weights, pixels, replacement=True, generator=generator)

    c2w_cur = torch.linalg.inv(w2c_cur)
    pts = backproject(depth_cur, fx, fy, cx, cy, c2w_cur)[px_idx]  # (pixels, 3)

    p_cam = torch.einsum("nj,kij->kni", pts, store.w2c[:, :3, :3]) + store.w2c[:, None, :3, 3]
    z = p_cam[..., 2] + 1e-5
    u = fx * p_cam[..., 0] / z + cx
    v = fy * p_cam[..., 1] / z + cy
    inside = (u > edge) & (u < w - edge) & (v > edge) & (v < h - edge) & (z > 0)
    percent = inside.float().mean(dim=1)  # (K,)
    slot_ids = torch.arange(store.capacity, device=dev)
    eligible = (slot_ids < store.count - 1) & (percent > 0.0)

    # uniform random choice among eligible via Gumbel top-k
    uniform = torch.rand(store.capacity, generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(uniform + 1e-12) + 1e-12)
    scores = torch.where(eligible, gumbel, torch.full_like(gumbel, -float("inf")))
    top_scores, top_ids = torch.topk(scores, num_select)
    return top_ids.to(torch.int32), torch.isfinite(top_scores)
