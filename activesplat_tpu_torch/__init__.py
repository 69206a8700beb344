"""ActiveSplat on PyTorch and CUDA: the port of `activesplat_tpu` to one
NVIDIA H100.

The module layout follows the JAX package so that each module's counterpart
is found under the same name:

  ops/        projection, dense and tile-binned rasterizers, SSIM, and the
              hand-written CUDA blend kernels (ops/raster_cuda.py, sources
              in csrc/, built by _build.py)
  models/     the fixed-capacity Gaussian buffer and cameras
  mapper/     config, Adam, geometry, keyframes and the mapping step
  queries/    the planner's map queries: top-down maps, panorama
              invisibility and the host-side hole scoring
  runtime/    the procedural BoxWorld scene and the benchmark's map
  utils/      quaternion, pose and intrinsics helpers; stage timers
  convert.py  the JAX package's state, as numpy arrays, into the port's tensors

The package imports torch, numpy and scipy only. Entry points run on CUDA
unless the caller passes device="cpu" (see device.py).
"""

from activesplat_tpu_torch.device import resolve_device, set_precision

__version__ = "0.1.0"

# The reference pins its f32 matmuls to full precision (Precision.HIGHEST);
# TF32 would keep about three decimal digits.
set_precision()

__all__ = ["resolve_device", "set_precision"]
