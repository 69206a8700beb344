"""Mapper hyper-parameters (copy of activesplat_tpu/mapper/config.py).

Defaults reproduce the reference's config surface: the SplaTAM module config
(config/splatam/online_habitat_sim.py) plus the per-dataset mapper block
(config/datasets/gibson.json "mapper"). The port keeps its own copy so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class LearningRates:
    """Per-parameter-group Adam LRs (online_habitat_sim.py:61-69)."""

    means3d: float = 0.0001
    rgb: float = 0.0025
    quats: float = 0.001
    logit_opacities: float = 0.05
    log_scales: float = 0.001


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    """prune_gaussians schedule (pruning_dict, online_habitat_sim.py:71-80;
    consumed by slam_external.py:171-192). Iteration indices count within one
    mapping event, matching the reference's per-frame `iter` loop variable."""

    start_after: int = 0
    remove_big_after: int = 0
    stop_after: int = 20
    prune_every: int = 20
    removal_opacity_threshold: float = 0.005
    final_removal_opacity_threshold: float = 0.005
    reset_opacities: bool = False
    reset_opacities_every: int = 500  # doesn't consider iter 0

    def removal_fires(self, iteration: int) -> bool:
        return (
            iteration <= self.stop_after
            and iteration >= self.start_after
            and iteration % self.prune_every == 0
        )

    def reset_fires(self, iteration: int) -> bool:
        return (
            iteration <= self.stop_after
            and self.reset_opacities
            and iteration > 0
            and iteration % self.reset_opacities_every == 0
        )


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    seed: int = 0
    # scheduling (gibson.json mapper block)
    map_every: int = 5
    kf_every: int = 5
    mapping_window_size: int = 12
    mapping_iters: int = 2
    # losses (online_habitat_sim.py mapping block)
    loss_w_im: float = 0.5
    loss_w_depth: float = 1.0
    sil_thres: float = 0.98
    use_sil_for_loss: bool = False
    ignore_outlier_depth_loss: bool = False
    lrs: LearningRates = LearningRates()
    use_wandb: bool = False
    # densification
    add_new_gaussians: bool = True
    densify_downscale_factor: int = 1
    new_gaussian_depth_limit: float = 5.0  # splatam.py:348
    # gradient-based clone/split densification (off by default, as in the
    # reference), fed by the mean2d gradient tap (mapper/step.py)
    use_gs_densification: bool = False
    densify_grad_thresh: float = 0.05
    densify_percent_dense: float = 0.01
    # pruning (prune_gaussians, online_habitat_sim.py:70 — off by default)
    prune_gaussians: bool = False
    prune: PruneConfig = PruneConfig()
    # gaussian init
    gaussian_distribution: str = "anisotropic"
    scene_radius_depth_ratio: float = 3.0
    # buffer management: fixed-capacity growth buckets
    initial_capacity: int = 1 << 17
    max_capacity: int = 1 << 22
    keyframe_capacity: int = 512
    # rasterizer: chunk size for the dense path; k_per_tile > 0 switches to
    # the tile-binned rasterizer (ops/raster_tiled.py)
    chunk: int = 256
    k_per_tile: int = 256
    # k_per_tile overflow policy (read by the mapper driver, mapper/splatam.py)
    k_per_tile_max: int = 1024
    k_overflow_tolerance: int = 0
    k_overflow_patience: int = 3
    k_overflow_min_active: int = 8192
    # Exact (uncapped) training compositing: "off" keeps the k-capped path,
    # "on" trains through the CSR blend, "hybrid" through the capped blend
    # with CSR recompositing of harmfully overflowing tiles; "auto" trains
    # k-capped until the mapper driver (mapper/splatam.py) switches it to
    # "hybrid" at the k_per_tile ceiling.
    exact_training: str = "auto"
    exact_online_metrics: bool = True
    quantize_frame_transfer: bool = True
    use_mesh: bool = False
    # adam
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-15  # torch Adam eps used by the reference
    # keyframe selection
    kf_select_pixels: int = 1600
    kf_select_edge: int = 20

    def lr_tuple(self) -> Tuple[float, float, float, float, float]:
        return (
            self.lrs.means3d,
            self.lrs.rgb,
            self.lrs.quats,
            self.lrs.logit_opacities,
            self.lrs.log_scales,
        )
