"""ctypes bridge to the native C++ raycaster (counterpart of
activesplat_tpu/runtime/native_raycast.py), built from the port's own
csrc/raycast.cpp at first use.

The library goes to `build/libraycast-<hash>.so` at the checkout's root,
built by `_build.build_host`: the hash covers the source, the compiler flags
and what `-march=native` means to the compiler on this host. It is written
to a temporary file and moved into place, so processes that build at once
agree.

Unlike the JAX package, nothing falls back to the numpy raycaster: a build
or load that fails raises with the compiler's message. Only
ACTIVESPLAT_NATIVE=0 selects the numpy path (runtime/synthetic.py). Set CXX
to name another compiler than g++.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from activesplat_tpu_torch import _build

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "raycast.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"

_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """The library's path, compiling it first if it is missing."""
    return _build.build_host(SOURCE, BUILD_DIR, "the native raycaster")


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use; raises if either fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.raycast_rgbd.argtypes = [
        f64,  # c2w, 16 row-major
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,  # fx fy cx cy
        ctypes.c_int, ctypes.c_int,  # width height
        f64,  # room size
        f64,  # obstacles (K, 6)
        ctypes.c_int,  # K
        ctypes.c_double, ctypes.c_double,  # depth_min depth_max
        f32,  # rgb out (H, W, 3)
        f32,  # depth out (H, W)
    ]
    lib.raycast_rgbd.restype = None
    _lib = lib
    return lib


def raycast(
    c2w: np.ndarray,
    intrinsics: np.ndarray,
    width: int,
    height: int,
    size,
    obstacles: np.ndarray,
    depth_min: float,
    depth_max: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """(rgb (H, W, 3) float32 in [0, 1], depth (H, W) float32): BoxWorld.render
    in C++."""
    lib = get_lib()
    rgb = np.empty((height, width, 3), np.float32)
    depth = np.empty((height, width), np.float32)
    obstacles = np.ascontiguousarray(np.asarray(obstacles, np.float64).reshape(-1, 6))
    lib.raycast_rgbd(
        np.ascontiguousarray(c2w, np.float64).reshape(16),
        float(intrinsics[0, 0]),
        float(intrinsics[1, 1]),
        float(intrinsics[0, 2]),
        float(intrinsics[1, 2]),
        int(width),
        int(height),
        np.ascontiguousarray(size, np.float64),
        obstacles,
        len(obstacles),
        float(depth_min),
        float(depth_max),
        rgb,
        depth,
    )
    return rgb, depth
