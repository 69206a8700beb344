"""Core constants, enums and timers (counterpart of
activesplat_tpu/utils/__init__.py; reference src/utils/__init__.py)."""

import time
from contextlib import contextmanager
from enum import Enum

import numpy as np

# OpenCV camera frame: +x right, +y down, +z forward; OpenGL: +x right, +y
# up, -z forward. The involution between the two (reference:
# src/utils/__init__.py:10-17).
OPENCV_TO_OPENGL = np.diag([1.0, -1.0, -1.0, 1.0])


class GlobalState(Enum):
    """Run-mode of the whole system (reference: src/utils/__init__.py:59-65)."""

    REPLAY = "REPLAY"
    AUTO_PLANNING = "AUTO_PLANNING"
    MANUAL_PLANNING = "MANUAL_PLANNING"
    MANUAL_CONTROL = "MANUAL_CONTROL"
    PAUSE = "PAUSE"
    QUIT = "QUIT"


class PoseDataType(Enum):
    """Pose convention tags (reference: src/dataloader/__init__.py:27-32)."""

    C2W_OPENCV = "C2W_OPENCV"
    C2W_OPENGL = "C2W_OPENGL"
    W2C_OPENCV = "W2C_OPENCV"
    W2C_OPENGL = "W2C_OPENGL"


def convert_to_c2w_opencv(pose: np.ndarray, pose_data_type: PoseDataType) -> np.ndarray:
    """Any tagged pose -> OpenCV c2w (convert_to_c2w_opencv,
    src/dataloader/__init__.py:46-53)."""
    pose = np.asarray(pose, np.float64)
    if pose_data_type in (PoseDataType.C2W_OPENGL, PoseDataType.W2C_OPENGL):
        pose = OPENCV_TO_OPENGL @ pose @ OPENCV_TO_OPENGL
    if pose_data_type in (PoseDataType.W2C_OPENCV, PoseDataType.W2C_OPENGL):
        pose = np.linalg.inv(pose)
    return pose


class Timer:
    """Accumulating wall-clock stage timer (the role of the reference's
    CUDA-event timing, src/utils/__init__.py:33-57). Where there is a card
    it waits for the queued work (torch.cuda.synchronize) at the start and
    end of each timed region, so the region's device work is inside it."""

    def __init__(self) -> None:
        import torch  # only the timer needs it; the rest of utils is numpy

        self.total_s = 0.0
        self.count = 0
        self.sync = torch.cuda.synchronize if torch.cuda.is_available() else None

    @contextmanager
    def time(self):
        if self.sync:
            self.sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                self.sync()
            self.total_s += time.perf_counter() - start
            self.count += 1

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.total_s / max(self.count, 1)


def start_timing() -> float:
    return time.perf_counter()


def end_timing(start: float) -> float:
    """Milliseconds since ``start``."""
    return (time.perf_counter() - start) * 1000.0
