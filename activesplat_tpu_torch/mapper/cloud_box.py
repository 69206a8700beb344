"""The axis-aligned box of a depth frame's world-space cloud, as the
change log records it (`SplaTAMMapper._log_change`).

The box is numpy's: back-project every valid pixel (depth > 0) in float64,
rotate and translate by c2w through numpy's matrix product, take the
extremes. Only a few pixels can hold an extreme, so a native pass
(csrc/cloud_box.cpp, built at first use by `_build.build_host` into
`build/libcloud_box-<hash>.so`) picks every pixel whose world coordinate
lies within a rounding bound of one, keeps of each run of such pixels at
one depth along a row or a column its two ends (numpy's coordinate is
monotone along it), and numpy's own lines run on just those: the box is the
same, bit for bit. Two or more pixels take the same BLAS product as the
whole cloud does (a single row would take numpy's matrix-vector path, whose
sums round otherwise), and the pass leaves one pixel only when the frame
has one valid pixel. Where a valid pixel is +inf or the pose or intrinsics
could overflow the bound, numpy's lines run on every valid pixel, so
non-finite values propagate as they always have.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from activesplat_tpu_torch import _build

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "cloud_box.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"

_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use; raises if either fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build.build_host(SOURCE, BUILD_DIR, "the change log's bound pass")))
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.cloud_box_candidates.argtypes = [
        np.ctypeslib.ndpointer(np.float32, ndim=2, flags="C_CONTIGUOUS"),  # depth (H, W)
        ctypes.c_int64, ctypes.c_int64,  # height width
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,  # fx fy cx cy
        f64,  # rotation, 9 row-major
        f64,  # translation, 3
        i64,  # candidates out, room for H * W
        i64,  # valid pixels out, 1
    ]
    lib.cloud_box_candidates.restype = ctypes.c_int64
    _lib = lib
    return lib


def candidates(depth: np.ndarray, intrinsics: np.ndarray,
               c2w: np.ndarray) -> Tuple[Optional[np.ndarray], int]:
    """(the flat indices, in row-major order, of pixels among which the
    cloud's extremes lie, the number of valid pixels) for a float32 (H, W)
    depth frame, the (3, 3) intrinsics and the (4, 4) camera-to-world pose;
    (None, 0) where a valid pixel is +inf or the bound could overflow."""
    depth = np.ascontiguousarray(depth)  # float32: the pointer's type checks it
    h, w = depth.shape
    idx = np.empty(h * w, np.int64)
    valid = np.zeros(1, np.int64)
    m = get_lib().cloud_box_candidates(
        depth, h, w, float(intrinsics[0, 0]), float(intrinsics[1, 1]), float(intrinsics[0, 2]),
        float(intrinsics[1, 2]), np.ascontiguousarray(c2w[:3, :3], np.float64).reshape(9),
        np.ascontiguousarray(c2w[:3, 3], np.float64), idx, valid)
    return (None, 0) if m < 0 else (idx[:m], int(valid[0]))


def cloud_box(depth: np.ndarray, intrinsics: np.ndarray,
              c2w: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """(box (2, 3) float64: the cloud's minimum and maximum, valid pixels,
    rows numpy's formula evaluated) for the arguments of `candidates`. With
    no valid pixel the box is the camera's position, twice."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    idx, pixels = candidates(depth, intrinsics, c2w)
    if idx is None:  # a non-finite pixel or bound: every valid pixel
        v, u = np.nonzero(depth > 0)
        pixels = len(v)
    else:
        v, u = np.divmod(idx, depth.shape[1])
    if len(v) == 0:
        p = c2w[:3, 3][None]
    else:
        z = depth[v, u].astype(np.float64)
        x = (u - cx) / fx * z
        y = (v - cy) / fy * z
        p = np.stack([x, y, z], -1) @ c2w[:3, :3].T + c2w[:3, 3]
    return np.stack([p.min(0), p.max(0)]), pixels, len(v)
