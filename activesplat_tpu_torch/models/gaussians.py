"""The Gaussian map (counterpart of activesplat_tpu/models/gaussians.py).

As in the JAX package, the map lives in a *fixed-capacity* buffer with an
``active`` mask instead of tensors that are concatenated and sliced as the map
grows (reference slam_external.py:126-164). Densification writes into free
slots, pruning clears mask bits. Slot order is part of the map's state (it is
what params.npz and densify parity see), so the port keeps it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from activesplat_tpu_torch.device import DeviceLike, resolve_device

PARAM_FIELDS = ("means3d", "rgb", "quats", "logit_opacities", "log_scales")


@dataclasses.dataclass
class GaussianParams:
    """Learnable per-Gaussian parameters; leading dim = buffer capacity.

    Raw storage as in the reference (splatam.py:89-95): unnormalized quats,
    log scales, logit opacities; activations are applied at render time."""

    means3d: torch.Tensor  # (C, 3) world-frame centers
    rgb: torch.Tensor  # (C, 3) linear color in [0, 1]
    quats: torch.Tensor  # (C, 4) unnormalized wxyz rotations
    logit_opacities: torch.Tensor  # (C,)
    log_scales: torch.Tensor  # (C, 3) anisotropic or (C, 1) isotropic

    @property
    def capacity(self) -> int:
        return self.means3d.shape[0]

    @property
    def isotropic(self) -> bool:
        return self.log_scales.shape[-1] == 1

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f) for f in PARAM_FIELDS)

    def map(self, fn, *others: "GaussianParams") -> "GaussianParams":
        """Apply fn field by field (over this and any other params)."""
        return GaussianParams(
            *(
                fn(getattr(self, f), *(getattr(o, f) for o in others))
                for f in PARAM_FIELDS
            )
        )

    def replace(self, **changes) -> "GaussianParams":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class GaussianBuffer:
    """Gaussian map = parameters + occupancy/bookkeeping state (the
    reference's ``variables`` dict, splatam.py:110-113)."""

    params: GaussianParams
    active: torch.Tensor  # (C,) bool
    timestep: torch.Tensor  # (C,) f32 — frame id at which each Gaussian was added
    max_radius: torch.Tensor  # (C,) f32 — running max screen-space radius
    grad_accum: torch.Tensor  # (C,) f32 — accumulated ||d loss/d mean2d||
    denom: torch.Tensor  # (C,) f32 — number of grad accumulation events

    @property
    def capacity(self) -> int:
        return self.params.capacity

    @property
    def device(self) -> torch.device:
        return self.active.device

    def num_active(self) -> torch.Tensor:
        return self.active.sum(dtype=torch.int32)

    def replace(self, **changes) -> "GaussianBuffer":
        return dataclasses.replace(self, **changes)

    @staticmethod
    def empty(
        capacity: int, isotropic: bool = False, device: DeviceLike = None
    ) -> "GaussianBuffer":
        dev = resolve_device(device)
        scale_dim = 1 if isotropic else 3
        f32 = dict(dtype=torch.float32, device=dev)
        quats = torch.zeros((capacity, 4), **f32)
        quats[:, 0] = 1.0
        params = GaussianParams(
            means3d=torch.zeros((capacity, 3), **f32),
            rgb=torch.zeros((capacity, 3), **f32),
            quats=quats,
            logit_opacities=torch.zeros((capacity,), **f32),
            log_scales=torch.full((capacity, scale_dim), -10.0, **f32),
        )
        return GaussianBuffer(
            params=params,
            active=torch.zeros((capacity,), dtype=torch.bool, device=dev),
            timestep=torch.zeros((capacity,), **f32),
            max_radius=torch.zeros((capacity,), **f32),
            grad_accum=torch.zeros((capacity,), **f32),
            denom=torch.zeros((capacity,), **f32),
        )

    def to(self, device) -> "GaussianBuffer":
        """The buffer on `device`: itself where it lies there already, else
        a copy."""
        if torch.device(device) == self.device:
            return self
        return GaussianBuffer(
            params=self.params.map(lambda x: x.to(device)),
            **{f.name: getattr(self, f.name).to(device)
               for f in dataclasses.fields(self) if f.name != "params"},
        )

    def grown(self, new_capacity: int) -> "GaussianBuffer":
        """A copy with capacity extended to ``new_capacity``; the new slots
        are inactive, with normalizable quats and log scale -10."""
        if new_capacity < self.capacity:
            raise ValueError(f"cannot shrink {self.capacity} to {new_capacity}")
        fresh = GaussianBuffer.empty(
            new_capacity, self.params.isotropic, device=self.device
        )
        n = self.capacity
        for f in PARAM_FIELDS:
            getattr(fresh.params, f)[:n] = getattr(self.params, f)
        for f in ("active", "timestep", "max_radius", "grad_accum", "denom"):
            getattr(fresh, f)[:n] = getattr(self, f)
        return fresh


def _scatter_drop(dst: torch.Tensor, target: torch.Tensor, src: torch.Tensor):
    """dst.at[target].set(src, mode="drop"): targets equal to len(dst) land in
    a spare row that is cut off again (no host sync for a boolean mask)."""
    spare = torch.cat([dst, dst[:1]], 0)
    spare[target] = src.to(dst.dtype)
    return spare[: dst.shape[0]]


def insert_gaussians(
    buf: GaussianBuffer,
    new_params: GaussianParams,
    new_valid: torch.Tensor,
    frame_id,
) -> Tuple[GaussianBuffer, torch.Tensor]:
    """Write candidate Gaussians into free slots of the buffer.

    Candidates whose ``new_valid`` bit is set go to the first free slots, in
    order (free slots ascending, stable). Candidates that do not fit are
    dropped and counted. Returns (new_buffer, num_dropped)."""
    capacity = buf.capacity
    new_valid = new_valid.to(torch.bool)

    free = ~buf.active
    # stable: free slots first, each group in ascending slot order
    slot_order = torch.argsort((~free).to(torch.uint8), stable=True)
    num_free = free.sum()

    cand_rank = torch.cumsum(new_valid.to(torch.int64), 0) - 1
    fits = new_valid & (cand_rank < num_free)
    target = torch.where(
        fits, slot_order[cand_rank.clamp(0, capacity - 1)], capacity
    )

    def scatter(dst, src):
        return _scatter_drop(dst, target, src)

    p = buf.params
    params = GaussianParams(
        *(scatter(getattr(p, f), getattr(new_params, f)) for f in PARAM_FIELDS)
    )
    n_inserted = fits.sum(dtype=torch.int32)
    num_dropped = new_valid.sum(dtype=torch.int32) - n_inserted
    frame = torch.as_tensor(
        frame_id, dtype=torch.float32, device=buf.device
    ).expand(new_valid.shape)
    new_buf = GaussianBuffer(
        params=params,
        active=scatter(buf.active, torch.ones_like(new_valid)),
        timestep=scatter(buf.timestep, frame),
        # reference resets these bookkeeping arrays on densification
        # (splatam.py:372-375)
        max_radius=torch.zeros_like(buf.max_radius),
        grad_accum=torch.zeros_like(buf.grad_accum),
        denom=torch.zeros_like(buf.denom),
    )
    return new_buf, num_dropped


def prune_mask(buf: GaussianBuffer, remove: torch.Tensor) -> GaussianBuffer:
    """Deactivate Gaussians where ``remove`` is set (reference: remove_points,
    slam_external.py:143-164 — a mask clear instead of tensor surgery)."""
    return buf.replace(active=buf.active & ~remove)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera (OpenCV convention). Intrinsics are 0-dim float32
    tensors on the render device, so geometry runs in float32 as in the
    reference package."""

    width: int
    height: int
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    w2c: torch.Tensor  # (4, 4) OpenCV world-to-camera
    near: float = 0.01
    far: float = 100.0

    @property
    def device(self) -> torch.device:
        return self.w2c.device

    def replace(self, **changes) -> "Camera":
        return dataclasses.replace(self, **changes)


def make_camera(
    width: int,
    height: int,
    intrinsics: np.ndarray,
    w2c,
    near: float = 0.01,
    far: float = 100.0,
    device: DeviceLike = None,
) -> Camera:
    dev = resolve_device(device)
    intrinsics = np.asarray(intrinsics)

    def scalar(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    return Camera(
        width=int(width),
        height=int(height),
        fx=scalar(intrinsics[0, 0]),
        fy=scalar(intrinsics[1, 1]),
        cx=scalar(intrinsics[0, 2]),
        cy=scalar(intrinsics[1, 2]),
        w2c=torch.tensor(np.asarray(w2c), dtype=torch.float32, device=dev),
        near=near,
        far=far,
    )
