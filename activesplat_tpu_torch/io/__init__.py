"""Result writers and readers with the JAX package's file formats:
params.npz, transforms.json with its PNG frames, and the metrics log."""

from activesplat_tpu_torch.io.params_io import load_params, save_params  # noqa: F401
