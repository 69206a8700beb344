"""Quaternion and pose helpers."""

import numpy as np

# OpenCV camera frame: +x right, +y down, +z forward; OpenGL: +x right, +y
# up, -z forward. The involution between the two (reference:
# src/utils/__init__.py:10-17).
OPENCV_TO_OPENGL = np.diag([1.0, -1.0, -1.0, 1.0])
