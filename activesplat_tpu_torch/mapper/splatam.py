"""The per-frame online mapper (counterpart of
activesplat_tpu/mapper/splatam.py).

Frame scheduling (map_every / kf_every), first-frame init, densification with
buffer growth, the mapping event split at prune fire points, the exact online
scores, gradient densification, keyframe commits, periodic checkpoints, the
map version and its change log, k_per_tile escalation with the
exact_training "auto" -> "hybrid" switch, the dataset dump and the final
params.npz export. Tracking is skipped: ground-truth poses are written into
the camera trajectory, as in the reference (splatam/__init__.py:399-405).

With cfg.use_mesh, or an explicit mesh, the mapping events, the
densification render and the panorama queries shard over a device mesh
(parallel/sharded.py).

Differences from the JAX package, on purpose: no relay retries; random
draws come from one torch.Generator (so the same seed picks other keyframes
than jax.random), whose state a checkpoint stores under its own key; the
keyframe dumps are written by the port's PNG codec with a JET table equal
to OpenCV's (io/colormaps.py).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from activesplat_tpu_torch.device import DeviceLike, resolve_device
from activesplat_tpu_torch.io.colormaps import JET_RGB
from activesplat_tpu_torch.io.manifest import DatasetDumper
from activesplat_tpu_torch.io.metrics_log import get_tracker
from activesplat_tpu_torch.io.params_io import (
    buffer_from_params,
    load_params,
    save_params,
    save_params_ckpt,
)
from activesplat_tpu_torch.io.png import write_png
from activesplat_tpu_torch.mapper import MapperState, MapperType
from activesplat_tpu_torch.mapper.cloud_box import cloud_box
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.mapper.keyframes import KeyframeStore
from activesplat_tpu_torch.mapper.step import (
    densify_gradient_phase,
    densify_phase,
    first_frame_phase,
    mapping_phase,
    prune_phase,
)
from activesplat_tpu_torch.models.gaussians import Camera, GaussianBuffer, make_camera
from activesplat_tpu_torch.ops.render import render
from activesplat_tpu_torch.ops.ssim import psnr
from activesplat_tpu_torch.parallel.sharded import RenderMesh, mesh_for_height, visible_devices
from activesplat_tpu_torch.queries.clusters import _dbscan_exact, resize_linear_u8
from activesplat_tpu_torch.queries.panorama import global_invisibility, local_invisibility
from activesplat_tpu_torch.utils import OPENCV_TO_OPENGL
from activesplat_tpu_torch.utils.tracing import attach, fetch, format_stage_report, host_value, stage
from activesplat_tpu_torch.utils.transforms import mat_to_q_pos, rot_axis

@torch.no_grad()
def _exact_online_scores(buf, cam, rgb_gt, depth_gt, *, chunk: int, k_per_tile: int):
    """Exact render + (psnr, depth_l1) for online progress metrics, with
    bg=0 as the k-capped training render uses (so psnr against psnr_train
    isolates the truncation). One (2,) tensor: one host read."""
    out = render(
        buf, cam, bg=torch.zeros(3, dtype=torch.float32, device=cam.device), chunk=chunk,
        k_per_tile=k_per_tile, exact=k_per_tile > 0,
    )
    a = torch.clamp(out.rgb, 0.0, 1.0)
    b = torch.clamp(rgb_gt.to(torch.float32), 0.0, 1.0)
    mask = depth_gt > 0
    n_valid = torch.clamp(mask.sum(), min=1)
    l1 = torch.where(mask, torch.abs(out.depth - depth_gt), 0.0).sum() / n_valid
    return torch.stack([psnr(a, b), l1])


class SplaTAMMapper:
    def __init__(
        self,
        cfg: MapperConfig,
        width: int,
        height: int,
        intrinsics: np.ndarray,
        step_num: int,
        results_dir: Optional[str] = None,
        depth_scale: float = 1.0,
        save_dataset: bool = True,
        save_checkpoints: bool = False,
        checkpoint_interval: int = 5,
        pano_scale: float = 1.0,
        device: DeviceLike = None,
        mesh: Optional[RenderMesh] = None,
    ):
        self.device = resolve_device(device)
        self.pano_scale = pano_scale
        self.cfg = cfg
        self.width, self.height = int(width), int(height)
        # shard every training render's rows over a device mesh: built here
        # when cfg.use_mesh is set, over the visible devices of the map's
        # type; an explicit `mesh` wins
        if mesh is None and cfg.use_mesh:
            mesh = mesh_for_height(self.height, visible_devices(self.device.type))
            if mesh is None:
                print(f"mapper: use_mesh is set but fewer than two {self.device.type} devices "
                      f"split {self.height} rows into whole 16 px tile rows; rendering unsharded")
        if mesh is not None and cfg.use_gs_densification:
            print("mapper: use_gs_densification needs the single-device mean2d gradient tap "
                  "— disabling the mesh")
            mesh = None
        self.mesh = mesh
        # densify renders at height / densify_downscale_factor: its own
        # (possibly smaller) mesh must split THAT height into whole tile rows
        self._densify_mesh = None
        if mesh is not None:
            f = max(int(cfg.densify_downscale_factor), 1)
            self._densify_mesh = mesh_for_height(self.height // f, mesh.devices)
            print(f"mapper: sharding renders over {mesh.px} devices "
                  f"({self.height // mesh.px} rows each)")
        self.intrinsics = np.asarray(intrinsics, np.float64)
        self.step_num = int(step_num)
        self.results_dir = results_dir
        self.save_checkpoints = save_checkpoints
        self.checkpoint_interval = checkpoint_interval

        # mutable scheduling knobs (the set_mapper service swaps these)
        self.kf_every = cfg.kf_every
        self.map_every = cfg.map_every
        self.mapping_iters = cfg.mapping_iters

        self.buf = GaussianBuffer.empty(
            cfg.initial_capacity, isotropic=cfg.gaussian_distribution == "isotropic",
            device=self.device,
        )
        self.store = KeyframeStore.empty(cfg.keyframe_capacity, self.height, self.width,
                                         device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

        self.tracking_idx = 0
        self.mapping_idx: Optional[int] = None
        # bumped whenever the Gaussian buffer changes; map-query caches key on it
        self.map_version = 0
        # per-version change AABBs: each buffer mutation logs the AABB of the
        # frame's valid-depth cloud (aabb_since, boxes_since)
        self._change_log: List[tuple] = []  # [(version, (2, 3) aabb), ...]
        self._change_log_floor = 0  # versions <= floor have been trimmed
        self._change_log_cap = 4096
        self.scene_radius: float = 1.0
        self.est_c2w: List[np.ndarray] = []
        self.gt_w2c_rel: List[np.ndarray] = []  # gradslam-convention relative w2c
        self.cam_quats: List[np.ndarray] = []  # absolute OpenCV w2c as quat/trans
        self.cam_trans: List[np.ndarray] = []
        self.keyframe_time_indices: List[int] = []
        self._first_pose_gl: Optional[np.ndarray] = None

        self._overflow_streak = 0
        self._overflow_warned_frame = -(10**9)
        # (capacity, k_per_tile, exact_training) transitions, one entry each
        self.shape_history: List[Dict] = []
        self.mapping_iter_time_sum = 0.0
        self.mapping_iter_time_count = 0
        self.mapping_frame_time_sum = 0.0
        self.mapping_frame_time_count = 0
        self.last_metrics: Dict[str, float] = {}
        self.online_metrics: List[Dict[str, float]] = []
        self.tracker = get_tracker(cfg.use_wandb, results_dir)
        # the latest high-loss reorientation pose, set by the mapper node's
        # local query and published with each pose (mapper_node.py)
        self.high_loss_samples_pose_c2w: Optional[np.ndarray] = None

        self.dumper: Optional[DatasetDumper] = None
        if results_dir is not None:
            gdir = os.path.join(results_dir, "gaussians_data")
            if os.path.exists(os.path.join(gdir, "rgb")):
                shutil.rmtree(gdir)
            self.dumper = DatasetDumper(
                gdir, self.width, self.height,
                intrinsics[0, 0], intrinsics[1, 1], intrinsics[0, 2], intrinsics[1, 2],
                depth_scale=depth_scale, save_images=save_dataset,
            )

    # ------------------------------------------------------------------ #

    def _camera(self, w2c: np.ndarray) -> Camera:
        return make_camera(self.width, self.height, self.intrinsics, w2c, device=self.device)

    def _check_tile_overflow(self, dropped: int, frame_id: int) -> None:
        """k_per_tile escalation: sustained harmful drops during training
        double k (up to k_per_tile_max); at the ceiling exact_training
        "auto" switches the training render to "hybrid" (capped blend plus
        CSR recompositing of harmfully overflowing tiles), and "off" warns."""
        if dropped <= self.cfg.k_overflow_tolerance:
            self._overflow_streak = 0
            return
        self._overflow_streak += 1
        if self._overflow_streak < self.cfg.k_overflow_patience:
            return
        self._overflow_streak = 0
        if self.num_gaussians() < self.cfg.k_overflow_min_active:
            return  # tiny scene: truncation costs less than growing k
        if self.cfg.k_per_tile >= self.cfg.k_per_tile_max:
            if self.cfg.exact_training == "auto":
                print(
                    f"k_per_tile at ceiling {self.cfg.k_per_tile_max} with "
                    f"{dropped} harmful memberships dropped — switching the "
                    "training render to hybrid exact compositing "
                    "(exact_training auto -> hybrid: capped blend + CSR on "
                    "harmfully overflowing tiles only)"
                )
                self.cfg = dataclasses.replace(self.cfg, exact_training="hybrid")
                return
            if self.cfg.exact_training in ("on", "hybrid"):
                return  # training is already unbiased; nothing to escalate
            if frame_id - self._overflow_warned_frame >= 50:
                self._overflow_warned_frame = frame_id
                print(
                    f"WARNING: tile lists overflowing ({dropped} memberships "
                    f"dropped) with k_per_tile already at the ceiling "
                    f"{self.cfg.k_per_tile_max}; dense tiles are truncating "
                    "far splats — raise MapperConfig.k_per_tile_max"
                )
            return
        new_k = min(self.cfg.k_per_tile * 2, self.cfg.k_per_tile_max)
        print(
            f"k_per_tile overflow: {dropped} tile memberships dropped for "
            f"{self.cfg.k_overflow_patience} consecutive mapping events — "
            f"escalating k_per_tile {self.cfg.k_per_tile} -> {new_k}"
        )
        self.cfg = dataclasses.replace(self.cfg, k_per_tile=new_k)

    def _grow_if_needed(self, dropped: int, headroom: int) -> bool:
        if dropped <= 0:
            return False
        needed = self.num_gaussians() + dropped + headroom
        new_cap = self.buf.capacity
        while new_cap < needed and new_cap < self.cfg.max_capacity:
            new_cap *= 2
        if new_cap > self.buf.capacity:
            self.buf = self.buf.grown(new_cap)
            return True
        return False

    # ------------------------------------------------------------------ #

    def run(self, batch: Optional[Dict[str, np.ndarray]]) -> MapperState:
        """Feed one frame {rgb (H,W,3) f32, depth (H,W) f32, c2w (4,4) OpenCV,
        frame_id int}. Returns the mapper state for this frame
        (run semantics: splatam/__init__.py:139-174)."""
        if batch is None:
            return MapperState.MAPPING
        frame_id = int(batch["frame_id"])
        if frame_id != self.tracking_idx:
            raise ValueError(f"frame ids must be consecutive, got {frame_id} != {self.tracking_idx}")
        self.tracking_idx += 1

        if self.mapping_idx is None:
            state = MapperState.BOOTSTRAP
            self.mapping_idx = 0
        elif self.tracking_idx <= self.step_num:
            self.mapping_idx = frame_id
            state = MapperState.MAPPING
        else:
            return MapperState.IDLE

        self._mapping(batch, frame_id)
        return state

    # ------------------------------------------------------------------ #

    def _frame_to_device(self, rgb: np.ndarray, depth: np.ndarray):
        """The frame on the device as float32. With quantize_frame_transfer
        it crosses as uint8 RGB and uint16 millimetres (2.7x fewer bytes)
        and is dequantized on the device, by a multiply with the float32
        reciprocal as XLA computes the reference's division by a constant
        (so the keyframe store holds the reference's values bitwise)."""
        dev = self.device
        if not self.cfg.quantize_frame_transfer:
            return torch.from_numpy(rgb).to(dev), torch.from_numpy(depth).to(dev)
        rgb_u8 = np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)
        depth_u16 = np.clip(np.round(depth * 1000.0), 0, 65535).astype(np.uint16)
        return (
            torch.from_numpy(rgb_u8).to(dev).to(torch.float32) * float(np.float32(1 / 255)),
            torch.from_numpy(depth_u16).to(dev).to(torch.float32) * float(np.float32(1 / 1000)),
        )

    def _mapping(self, batch: Dict[str, np.ndarray], frame_id: int) -> None:
        t_frame = time.time()
        buf_before = self.buf  # every buffer update makes a new object
        rgb = np.asarray(batch["rgb"], np.float32)
        depth = np.asarray(batch["depth"], np.float32)
        c2w = np.asarray(batch["c2w"], np.float64)
        w2c = np.linalg.inv(c2w)
        self.est_c2w.append(c2w)

        # trajectory bookkeeping: absolute OpenCV w2c as quat/trans
        # (splatam/__init__.py:400-405) and the gradslam-convention
        # relative-to-first-frame w2c (splatam/__init__.py:333-338)
        quat, pos = mat_to_q_pos(w2c)
        self.cam_quats.append(quat)
        self.cam_trans.append(pos)
        pose_gl = OPENCV_TO_OPENGL @ w2c.T @ OPENCV_TO_OPENGL
        if self._first_pose_gl is None:
            self._first_pose_gl = pose_gl
        rel_pose = np.linalg.inv(self._first_pose_gl) @ pose_gl
        self.gt_w2c_rel.append(np.linalg.inv(rel_pose))

        if self.dumper is not None:
            self.dumper.add_frame(frame_id, rgb, depth, w2c)

        cam = self._camera(w2c)
        w2c_t = torch.tensor(w2c, dtype=torch.float32, device=self.device)
        with stage("mapper/frame_transfer"):
            rgb_j, depth_j = self._frame_to_device(rgb, depth)

        if frame_id == 0:
            with stage("mapper/first_frame"):
                self.buf, dropped, scene_radius = first_frame_phase(
                    self.buf, cam, rgb_j, depth_j, self.cfg
                )
                if self._grow_if_needed(host_value(dropped), self.width * self.height):
                    self.buf, dropped, scene_radius = first_frame_phase(
                        self.buf, cam, rgb_j, depth_j, self.cfg
                    )
                self.scene_radius = host_value(scene_radius)

        # scheduling (splatam/__init__.py:395-397): iterations run every frame
        # if mapping_iters >= map_every, otherwise only on map frames
        iter_per_frame = int(self.mapping_iters // self.map_every)
        if iter_per_frame == 0 and frame_id % self.map_every == 0:
            iter_per_frame = int(self.mapping_iters)

        is_map_frame = frame_id == 0 or (frame_id + 1) % self.map_every == 0

        # densification on map frames (splatam/__init__.py:408-417)
        if is_map_frame and self.cfg.add_new_gaussians and frame_id > 0:
            with stage("mapper/densify"):
                args = (cam, rgb_j, depth_j, float(frame_id), self.cfg, self._densify_mesh)
                self.buf, dropped, _ = densify_phase(self.buf, *args)
                if self._grow_if_needed(host_value(dropped), 4096):
                    self.buf, dropped, _ = densify_phase(self.buf, *args)

        # the mapping event, split into segments at prune-schedule fire points
        # (each segment re-initializes Adam and redraws its keyframe window)
        if iter_per_frame > 0:
            t_iter = time.time()
            with stage("mapper/mapping_iters"):
                pd = self.cfg.prune

                def fires(i):
                    return self.cfg.prune_gaussians and (pd.removal_fires(i) or pd.reset_fires(i))

                i = 0
                while i < iter_per_frame:
                    if fires(i):
                        self.buf, _ = prune_phase(self.buf, self.cfg, i, self.scene_radius)
                    nxt = next((j for j in range(i + 1, iter_per_frame) if fires(j)), iter_per_frame)
                    self.buf, self.store, metrics = mapping_phase(
                        self.buf, self.store, rgb_j, depth_j, w2c_t, frame_id, cam,
                        self.generator, self.cfg, nxt - i, mesh=self.mesh,
                    )
                    i = nxt
                packed = host_value(metrics["packed"])  # one read, which waits for the event
            self.mapping_iter_time_sum += time.time() - t_iter
            self.mapping_iter_time_count += iter_per_frame
            self.last_metrics = {
                "loss": float(packed[0]),
                "psnr": float(packed[1]),
                "depth_l1": float(packed[2]),
                "dropped": int(packed[3]),
                "rgb_l1": float(packed[4]),
                "ssim": float(packed[5]),
            }
            exact_on = self.cfg.exact_online_metrics and self.cfg.k_per_tile > 0
            if exact_on and self.cfg.exact_training in ("on", "hybrid"):
                # the training render is already exact: its scores are the
                # exact online scores
                self.last_metrics["psnr_train"] = self.last_metrics["psnr"]
                self.last_metrics["depth_l1_train"] = self.last_metrics["depth_l1"]
            elif exact_on:
                # progress from the exact render, as the reference's
                # report_progress renders uncapped (eval_helpers.py:153-277)
                with stage("mapper/exact_online"):
                    ex = host_value(_exact_online_scores(
                        self.buf, cam, rgb_j, depth_j,
                        chunk=self.cfg.chunk, k_per_tile=self.cfg.k_per_tile,
                    ))
                self.last_metrics["psnr_train"] = self.last_metrics["psnr"]
                self.last_metrics["depth_l1_train"] = self.last_metrics["depth_l1"]
                self.last_metrics["psnr"] = float(ex[0])
                self.last_metrics["depth_l1"] = float(ex[1])
            self._check_tile_overflow(self.last_metrics["dropped"], frame_id)
            self.online_metrics.append({"frame": frame_id, **self.last_metrics})
            self.tracker.log(self.last_metrics, step=frame_id)

        # gradient-based clone/split densification (off by default, as in
        # the reference config online_habitat_sim.py:81)
        if self.cfg.use_gs_densification and is_map_frame and frame_id > 0:
            with stage("mapper/densify_gradient"):
                args = (self.scene_radius, float(frame_id), self.generator, self.cfg)
                self.buf, dropped, _ = densify_gradient_phase(self.buf, *args)
                if self._grow_if_needed(host_value(dropped), 4096):
                    self.buf, dropped, _ = densify_gradient_phase(self.buf, *args)

        # keyframe commit (splatam/__init__.py:514-524)
        if (
            frame_id == 0
            or (frame_id + 1) % self.kf_every == 0
            or frame_id == self.step_num - 2
        ) and np.isfinite(w2c).all():
            with stage("mapper/kf_commit"):
                self.store.committed(rgb_j, depth_j, w2c_t, frame_id)
            self.keyframe_time_indices.append(frame_id)

        if self.save_checkpoints and self.results_dir and frame_id % self.checkpoint_interval == 0:
            ckpt_dir = os.path.join(self.results_dir, "gaussians_data", "checkpoints")
            self.save_checkpoint(ckpt_dir, frame_id)

        if self.buf is not buf_before:
            self.map_version += 1
            with stage("mapper/change_log"):
                self._log_change(depth, c2w)
        shape = {
            "capacity": int(self.buf.capacity),
            "k_per_tile": int(self.cfg.k_per_tile),
            "exact_training": self.cfg.exact_training
            if self.cfg.exact_training in ("on", "hybrid")
            else False,
        }
        if not self.shape_history or {k: self.shape_history[-1].get(k) for k in shape} != shape:
            self.shape_history.append({"frame": frame_id, **shape})
        self.mapping_frame_time_sum += time.time() - t_frame
        self.mapping_frame_time_count += 1

    def _log_change(self, depth: np.ndarray, c2w: np.ndarray) -> None:
        """Record the current frame's cloud AABB against the new map_version;
        the span gets the valid pixels and the rows numpy back-projected."""
        box, pixels, rows = cloud_box(depth, self.intrinsics, c2w)
        attach(pixels=pixels, rows=rows)
        self._change_log.append((self.map_version, box))
        if len(self._change_log) > self._change_log_cap:
            drop = len(self._change_log) - self._change_log_cap
            self._change_log_floor = self._change_log[drop - 1][0]
            del self._change_log[:drop]

    def boxes_since(self, version: int) -> Optional[np.ndarray]:
        """(M, 2, 3) per-frame change AABBs with map_version > `version`, or
        None when unknowable (changes that old were trimmed from the log).
        M == 0 means the map has not changed."""
        if version < self._change_log_floor:
            return None
        boxes = [b for v, b in self._change_log if v > version]
        return np.stack(boxes) if boxes else np.zeros((0, 2, 3))

    def aabb_since(self, version: int) -> Optional[np.ndarray]:
        """Union AABB of all map changes with map_version > `version`, or
        None when unknowable; an empty range gives an inverted box that
        intersects nothing."""
        boxes = self.boxes_since(version)
        if boxes is None:
            return None
        if len(boxes) == 0:
            return np.array([[np.inf] * 3, [-np.inf] * 3])
        return np.stack([boxes[:, 0].min(0), boxes[:, 1].max(0)])

    # ------------------------------------------------------------------ #

    def post_processing(self) -> Optional[str]:
        """Final export (post_processing semantics, splatam/__init__.py:544-578):
        params.npz, transforms.json, the keyframe RGB|depth dumps and the
        online metric summaries."""
        self.tracker.finish()
        iters = max(self.mapping_iter_time_count, 1)
        frames = max(self.mapping_frame_time_count, 1)
        print(f"Average Mapping/Iteration Time: {self.mapping_iter_time_sum / iters * 1000:.2f} ms")
        print(f"Average Mapping/Frame Time: {self.mapping_frame_time_sum / frames:.4f} s")
        print("Stage timing (host wall-clock; device times come from torch.profiler):")
        print(format_stage_report())
        if self.results_dir is None:
            return None
        t = len(self.cam_quats)
        out_dir = os.path.join(self.results_dir, "gaussians_data")
        path = save_params(
            out_dir,
            self.buf,
            np.stack(self.cam_quats, -1)[None],  # (1, 4, T)
            np.stack(self.cam_trans, -1)[None],  # (1, 3, T)
            self.intrinsics,
            np.eye(4, dtype=np.float32),
            self.width,
            self.height,
            np.stack(self.gt_w2c_rel, 0) if t else np.zeros((0, 4, 4)),
            np.array(self.keyframe_time_indices),
        )
        if self.dumper is not None:
            self.dumper.write()
        # keyframe RGB | depth side-by-side dumps (save_keyframes role,
        # common_utils.py:46-59)
        kf_dir = os.path.join(out_dir, "keyframes")
        os.makedirs(kf_dir, exist_ok=True)
        count = self.store.count
        frame_ids = fetch(self.store.frame_id[:count])
        for slot in range(count):
            rgb_u8 = (np.clip(fetch(self.store.rgb[slot]), 0, 1) * 255).astype(np.uint8)
            dep = fetch(self.store.depth[slot])
            top = dep.max() if dep.max() > 0 else 1.0
            dep_u8 = np.clip(dep / top * 255, 0, 255).astype(np.uint8)
            write_png(os.path.join(kf_dir, f"{int(frame_ids[slot]):04d}.png"),
                      np.hstack([rgb_u8, JET_RGB[dep_u8]]))

        if self.online_metrics:
            with open(os.path.join(out_dir, "online_psnr.txt"), "w") as fh:
                fh.writelines(f"{m['psnr']}\n" for m in self.online_metrics)
            with open(os.path.join(out_dir, "online_depth_l1.txt"), "w") as fh:
                fh.writelines(f"{m['depth_l1']}\n" for m in self.online_metrics)
        print("Saved SplaTAM results to:", out_dir)
        return path

    def save_checkpoint(self, ckpt_dir: str, frame_id: int) -> str:
        """Mid-run checkpoint in the JAX package's layout: params{t}.npz,
        keyframe_time_indices{t}.npy and mapper_state{t}.npz with the
        keyframe store, trajectory, scene radius and schedule counters.
        The random state is the port's generator's, under
        `torch_generator_state`; `rng_key` holds jax.random.PRNGKey(seed),
        so the JAX package resumes from the seed's stream."""
        path = save_params_ckpt(ckpt_dir, self.buf, frame_id)
        np.save(
            os.path.join(ckpt_dir, f"keyframe_time_indices{frame_id}.npy"),
            np.array(self.keyframe_time_indices),
        )
        count = self.store.count
        np.savez(
            os.path.join(ckpt_dir, f"mapper_state{frame_id}.npz"),
            kf_rgb=fetch(self.store.rgb[:count]),
            kf_depth=fetch(self.store.depth[:count]),
            kf_w2c=fetch(self.store.w2c[:count]),
            kf_frame_id=fetch(self.store.frame_id[:count]),
            est_c2w=np.asarray(self.est_c2w),
            gt_w2c_rel=np.asarray(self.gt_w2c_rel),
            cam_quats=np.asarray(self.cam_quats),
            cam_trans=np.asarray(self.cam_trans),
            keyframe_time_indices=np.array(self.keyframe_time_indices),
            scene_radius=np.float64(self.scene_radius),
            tracking_idx=np.int64(self.tracking_idx),
            mapping_idx=np.int64(-1 if self.mapping_idx is None else self.mapping_idx),
            first_pose_gl=(
                np.zeros((0, 4)) if self._first_pose_gl is None else self._first_pose_gl
            ),
            rng_key=np.array([0, self.cfg.seed], np.uint32),
            torch_generator_state=self.generator.get_state().numpy(),
        )
        return path

    def load_map(self, params_path: str, state_path: Optional[str] = None) -> None:
        """Resume from a params{t}.npz (the port's or the JAX package's).
        With the sibling mapper_state{t}.npz (found by name) the keyframe
        store, trajectory, scene radius and schedule counters are restored,
        and the generator's state when the file holds the port's; without
        it only the Gaussian buffer is."""
        params = load_params(params_path)
        n = params["means3D"].shape[0]
        capacity = self.cfg.initial_capacity
        while capacity < n:  # the run may have grown past the initial bucket
            capacity *= 2
        self.buf = buffer_from_params(params, capacity=capacity, device=self.device)

        if state_path is None:
            base = os.path.basename(params_path)
            if base.startswith("params") and base.endswith(".npz"):
                candidate = os.path.join(
                    os.path.dirname(params_path),
                    f"mapper_state{base[len('params'):-len('.npz')]}.npz",
                )
                if os.path.exists(candidate):
                    state_path = candidate
        if state_path is None:
            return

        with np.load(state_path) as st:
            count = st["kf_rgb"].shape[0]
            dev = self.device
            self.store.rgb[:count] = torch.from_numpy(st["kf_rgb"]).to(dev)
            self.store.depth[:count] = torch.from_numpy(st["kf_depth"]).to(dev)
            self.store.w2c[:count] = torch.from_numpy(st["kf_w2c"]).to(dev)
            self.store.frame_id[:count] = torch.from_numpy(st["kf_frame_id"]).to(dev)
            self.store.count = count
            self.est_c2w = list(st["est_c2w"])
            self.gt_w2c_rel = list(st["gt_w2c_rel"])
            self.cam_quats = list(st["cam_quats"])
            self.cam_trans = list(st["cam_trans"])
            self.keyframe_time_indices = [int(x) for x in st["keyframe_time_indices"]]
            self.scene_radius = float(st["scene_radius"])
            self.tracking_idx = int(st["tracking_idx"])
            mi = int(st["mapping_idx"])
            self.mapping_idx = None if mi < 0 else mi
            if st["first_pose_gl"].size:
                self._first_pose_gl = np.asarray(st["first_pose_gl"])
            if "torch_generator_state" in st.files:
                self.generator.set_state(torch.from_numpy(st["torch_generator_state"]))

    # ------------------------------------------------------------------ #
    # map-query renders: views, panoramic invisibility

    def render_rgbd(self, c2w: np.ndarray, scale_modifier: float = 1.0):
        """Render the map from a pose: (rgb uint8 (H,W,3), depth meters (H,W)),
        white background (render_rgbd semantics, splatam/__init__.py:604-632)."""
        rgb, depth = self.render_rgbd_float(self._camera(np.linalg.inv(c2w)), scale_modifier)
        return (rgb * 255).astype(np.uint8), depth

    @torch.no_grad()
    def render_rgbd_float(self, cam: Camera, scale_modifier: float = 1.0, bg: float = 1.0):
        """Exact render from a Camera: (rgb float (H,W,3) in [0,1], depth
        meters (H,W)); bg white by default, 0.0 for the training background."""
        out = render(
            self.buf, cam, bg=torch.full((3,), bg, dtype=torch.float32, device=self.device),
            scale_modifier=scale_modifier, chunk=self.cfg.chunk,
            k_per_tile=self.cfg.k_per_tile, exact=self.cfg.k_per_tile > 0,
        )
        return np.clip(fetch(out.rgb), 0.0, 1.0), fetch(out.depth)

    @torch.no_grad()
    def render_view(self, cam: Camera, scale_modifier: float = 1.0) -> Dict[str, np.ndarray]:
        """Full-channel view render (render_o3d_image role,
        splatam/__init__.py:634-695): rgb (float), depth and opacity, in one
        host read."""
        out = render(
            self.buf, cam, bg=torch.ones(3, device=self.device), scale_modifier=scale_modifier,
            chunk=self.cfg.chunk, k_per_tile=self.cfg.k_per_tile, exact=self.cfg.k_per_tile > 0,
        )
        both = fetch(torch.cat([out.rgb, out.depth[..., None], out.alpha[..., None]], dim=-1))
        return {"rgb": both[..., :3], "depth": both[..., 3], "opacity": both[..., 4]}

    def get_global_invisibility(self, view_c2w: np.ndarray, node_positions):
        """Per-node (invisibility, hole volume, reach) scores."""
        return global_invisibility(self.buf, np.asarray(view_c2w), node_positions,
                                   chunk=self.cfg.chunk, scale=self.pano_scale, mesh=self.mesh)

    def get_local_invisibility(self, view_c2w: np.ndarray,
                               cluster_invisibility_threshold: float = 25.0):
        return local_invisibility(self.buf, np.asarray(view_c2w), cluster_invisibility_threshold,
                                  chunk=self.cfg.chunk, scale=self.pano_scale, mesh=self.mesh)

    @torch.no_grad()
    def get_high_loss_samples(
        self,
        rgb_gt: np.ndarray,
        depth_gt: np.ndarray,
        c2w: np.ndarray,
        cluster_invisibility_threshold: float = 25.0,
        hfov_deg: float = 90.0,
        vfov_deg: float = 90.0,
    ) -> Optional[np.ndarray]:
        """Reorientation target from depth-error clusters of the current view
        (get_high_loss_samples, splatam/__init__.py:185-252): pixels where the
        map renders behind the ground-truth depth with high confidence are
        clustered; a rotation toward the biggest cluster is returned if it
        lies more than 5 degrees off centre."""
        out = render(
            self.buf, self._camera(np.linalg.inv(c2w)), chunk=self.cfg.chunk,
            k_per_tile=self.cfg.k_per_tile, exact=self.cfg.k_per_tile > 0,
        )
        depth, opacity = fetch(out.depth), fetch(out.alpha)
        depth_error = np.abs(depth - depth_gt) * (depth_gt > 0)
        mask = (depth > depth_gt) & (depth_error > 0.3) & (opacity > 0.8)
        mask_small = resize_linear_u8(mask.astype(np.uint8), int(hfov_deg), int(vfov_deg))
        points = np.column_stack(np.where(mask_small > 0))
        if len(points) == 0 or mask_small.sum() <= 20:
            return None
        labels = _dbscan_exact(points, 5, 10)
        centers, sums = [], []
        for label in set(labels.tolist()):
            if label == -1:
                continue
            members = points[labels == label]
            total = float(mask_small[members[:, 0], members[:, 1]].sum())
            if total > cluster_invisibility_threshold:
                centers.append(members.mean(0))
                sums.append(total)
        if not sums:
            return None
        c = centers[int(np.argmax(sums))]
        h_angle = np.deg2rad(c[1] / mask_small.shape[1] * hfov_deg - hfov_deg / 2)
        v_angle = np.deg2rad(c[0] / mask_small.shape[0] * vfov_deg - vfov_deg / 2)
        if abs(h_angle) <= np.deg2rad(5) and abs(v_angle) <= np.deg2rad(5):
            return None
        pose = rot_axis(np.asarray(c2w, np.float64), "y", h_angle)
        return rot_axis(pose, "x", v_angle)

    # ------------------------------------------------------------------ #
    # knobs used by the set_mapper service

    def truncation_bias(self) -> Optional[Dict[str, float]]:
        """k_per_tile training-truncation bias from the online metric record:
        per map frame, the exact render's psnr/depth_l1 against the k-capped
        training render's (*_train). psnr_delta == 0 means the cap was
        lossless."""
        rows = [m for m in self.online_metrics if "psnr_train" in m]
        if not rows:
            return None
        d_psnr = np.array([m["psnr"] - m["psnr_train"] for m in rows])
        d_l1 = np.array([m["depth_l1_train"] - m["depth_l1"] for m in rows])
        return {
            "frames": len(rows),
            "psnr_delta_mean": float(d_psnr.mean()),
            "psnr_delta_last100_mean": float(d_psnr[-100:].mean()),
            "psnr_delta_max": float(d_psnr.max()),
            "depth_l1_delta_mean": float(d_l1.mean()),
            "depth_l1_delta_last100_mean": float(d_l1[-100:].mean()),
        }

    def get_kf_every(self) -> int:
        return int(self.kf_every)

    def set_kf_every(self, value: int) -> None:
        self.kf_every = int(value)

    def get_map_every(self) -> int:
        return int(self.map_every)

    def set_map_every(self, value: int) -> None:
        self.map_every = int(value)

    def get_mapping_iters(self) -> int:
        return int(self.mapping_iters)

    def get_step_num(self) -> int:
        return self.step_num

    def get_mapper_type(self) -> MapperType:
        return MapperType.SplaTAM

    def num_gaussians(self) -> int:
        return host_value(self.buf.num_active())
