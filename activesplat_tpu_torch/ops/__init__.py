"""Projection, rasterizers, SSIM and the CUDA tile-blend kernels."""
