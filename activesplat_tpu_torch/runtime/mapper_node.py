"""Mapper-side node (counterpart of activesplat_tpu/runtime/mapper_node.py):
the headless equivalent of the reference's Visualizer orchestrator
(src/visualizer/visualizer.py, minus the Open3D GUI).

Owns the dataset (simulator), the online mapper, and the top-down grid; serves
the reference's mapper-side services (get_dataset_config, get_topdown_config,
get_topdown, get_opacity, set_mapper, reset_env), drives movement from the
cmd_vel topic and maps frames published on the frames topic. All reference Condition-variable rendezvous become synchronous
calls: a get_topdown call renders fresh maps on the spot.

The mapper and its queries run on `device` (CUDA unless the caller names
another); the simulator, the score cache and the horizon box stay on the
host. The runtime recorder, the live view and its orbit overlay are not
ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from activesplat_tpu_torch.device import DeviceLike
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.mapper.geometry import backproject
from activesplat_tpu_torch.mapper.splatam import SplaTAMMapper
from activesplat_tpu_torch.queries.topdown import (
    IncrementalTopdown,
    TopdownConfig,
    topdown_config_from_bbox,
)
from activesplat_tpu_torch.runtime.bus import Bus
from activesplat_tpu_torch.runtime.dataloader import SyntheticDataset, twist_to_action
from activesplat_tpu_torch.utils import GlobalState, PoseDataType, convert_to_c2w_opencv
from activesplat_tpu_torch.utils.tracing import stage


class MapperNode:
    def __init__(
        self,
        bus: Bus,
        dataset: SyntheticDataset,
        mapper_cfg: MapperConfig,
        results_dir: str,
        pixel_max: int = 360,
        single_floor_expansion=(0.25, 2.0),  # (foot, head) — gibson.json mapper block
        agent_foot_adjust: float = 0.0,
        save_dataset: bool = True,
        pano_scale: float = 1.0,
        pano_cache: str = "version",  # off | version
        pano_cache_capacity: int = 1024,
        device: DeviceLike = None,
    ) -> None:
        self.bus = bus
        self.dataset = dataset
        self.results_dir = results_dir
        os.makedirs(results_dir, exist_ok=True)
        self.global_state = GlobalState.AUTO_PLANNING

        sensor = dataset.sensor
        self.mapper = SplaTAMMapper(
            mapper_cfg,
            sensor.width,
            sensor.height,
            sensor.intrinsics,
            step_num=dataset.step_num + 1,
            results_dir=results_dir,
            depth_scale=sensor.depth_scale,
            save_dataset=save_dataset,
            pano_scale=pano_scale,
            device=device,
        )

        # --- first frame + top-down grid geometry (visualizer.py:166-273) ---
        frame0 = dataset.get_frame()
        sensor_h = float(frame0["c2w"][1, 3])
        agent_foot = sensor_h - float(sensor.position[1])
        agent_head = agent_foot + dataset.agent_height
        cfg_ds = dataset.dataset_config(results_dir)
        bbox = np.asarray(cfg_ds["scene_bbox"], np.float64).copy()
        # single-floor slab: clamp the height band around the agent
        bbox[1, 0] = max(bbox[1, 0], agent_foot - single_floor_expansion[0])
        bbox[1, 1] = min(bbox[1, 1], agent_head + single_floor_expansion[1])
        self.topdown_cfg: TopdownConfig = topdown_config_from_bbox(
            bbox,
            agent_foot=agent_foot + agent_foot_adjust,
            agent_head=agent_head,
            pixel_max=pixel_max,
            height_axis=1,
        )
        self.movement_fail_times = 0
        self._topdown_cache: Optional[tuple] = None  # (map_version, free, unobs)
        # Incremental topdown engine: exact changed-box diff vs a param
        # snapshot, windowed re-render when the change is local.
        self._topdown_inc = IncrementalTopdown(self.topdown_cfg)
        # Panorama score cache (get_opacity GLOBAL): the reference re-renders
        # every node's 3-view panorama on every SELECT_TARGET tick
        # (splatam/__init__.py:697-759). Keyed on the quantized node
        # position; modes:
        #   "off"     — always fresh (reference behavior);
        #   "version" — reuse iff mapper.map_version is unchanged (exact).
        # Panoramas start at the CURRENT camera yaw; the 360deg score sum is
        # yaw-invariant up to pixel rasterization, so position-keyed reuse
        # across ticks is sound.
        assert pano_cache in ("off", "version"), pano_cache
        self.pano_cache_mode = pano_cache
        # bounded: entries past capacity evict oldest-version first
        self.pano_cache_capacity = int(pano_cache_capacity)
        self._pano_cache: Dict[tuple, dict] = {}
        self.pano_cache_hits = 0
        self.pano_cache_misses = 0
        # miss taxonomy: `stale` = key existed but invalidation rejected it;
        # misses - stale = first-ever lookups of that quantized position
        # (key churn — Voronoi nodes moving between SELECT_TARGET ticks)
        self.pano_cache_stale = 0
        self.last_frame: Optional[Dict[str, np.ndarray]] = frame0
        self._finished = False
        self.live_view = None  # the dashboard is not ported yet

        bus.register_service("get_dataset_config", lambda: cfg_ds)
        bus.register_service("get_topdown_config", self._get_topdown_config)
        bus.register_service("get_topdown", self._get_topdown)
        bus.register_service("get_opacity", self._get_opacity)
        bus.register_service("set_mapper", self._set_mapper)
        bus.register_service("reset_env", self._reset_env)
        bus.subscribe("cmd_vel", self._on_cmd_vel)
        bus.subscribe("frames", self._on_frames)

        # map the first frame immediately (reference maps frame 0 on startup)
        self.mapper.run(frame0)
        self._publish_pose(frame0)

    # ------------------------------------------------------------------ #

    def _publish_pose(self, frame: Dict[str, np.ndarray]) -> None:
        self.bus.publish("camera_pose", np.asarray(frame["c2w"], np.float64))
        self.bus.publish("movement_fail_times", self.movement_fail_times)
        if self.mapper.high_loss_samples_pose_c2w is not None:
            self.bus.publish(
                "high_loss_samples_pose", self.mapper.high_loss_samples_pose_c2w
            )

    def _on_cmd_vel(self, twist: Dict[str, np.ndarray]) -> None:
        """Apply one movement, map the resulting frame
        (role of __cmd_vel_callback -> __apply_movement -> UpdateDataset,
        visualizer.py:2121-2150, 1717-1781)."""
        if self._finished:
            return
        if twist_to_action(twist) is None:
            return  # zero twist: no step (dataloader.py:242-263 semantics)
        with stage("simulator"):
            moved = self.dataset.apply_movement(twist)
            frame = self.dataset.get_frame()
        if not moved:
            self.movement_fail_times += 1
        else:
            self.movement_fail_times = 0
        with stage("mapper/frame"):
            self.mapper.run(frame)
        self.last_frame = frame
        self._publish_pose(frame)
        if self.dataset.is_finished():
            self.finish()

    def _on_frames(self, frame: Dict[str, np.ndarray]) -> None:
        """External-sensor mode: map a frame published on the 'frames' topic
        instead of one stepped from the owned simulator (role of
        __frame_callback, visualizer.py:2044-2115). The frame dict carries
        rgb (H,W,3 float), depth (H,W meters), c2w, and optionally
        pose_data_type for on-the-fly convention conversion."""
        if self._finished:
            return
        c2w = convert_to_c2w_opencv(
            np.asarray(frame["c2w"], np.float64),
            PoseDataType(frame.get("pose_data_type", "C2W_OPENCV")),
        )
        msg = {
            "rgb": frame["rgb"],
            "depth": frame["depth"],
            "c2w": c2w,
            "frame_id": frame.get("frame_id", self.mapper.tracking_idx),
        }
        with stage("mapper/frame"):
            self.mapper.run(msg)
        self.last_frame = msg
        self._publish_pose(msg)

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        self.global_state = GlobalState.QUIT
        self.mapper.post_processing()
        if self.bus.has_service("set_planner_state"):
            self.bus.call("set_planner_state", GlobalState.QUIT)

    # ------------------------------------------------------------------ #
    # services

    def _get_topdown_config(self) -> Dict:
        cfg = self.topdown_cfg
        return {
            "world_dim_index": cfg.world_dim_index,
            "world_2d_bbox": cfg.world_2d_bbox,
            "grid_map_shape": cfg.grid_shape,
            "meter_per_pixel": cfg.meter_per_pixel,
        }

    def _get_topdown(self, arrived_flag: bool) -> Optional[Dict]:
        if self.global_state == GlobalState.QUIT:
            return None
        # Re-render only when the map actually changed: the reference's
        # UpdateMain re-renders topdown on fresh GaussianPackets and the
        # service hands back the latest maps (visualizer.py:926-976); the
        # planner polls every navigation tick but mapping only mutates the
        # buffer on map_every frames.
        ver = self.mapper.map_version
        if self._topdown_cache is not None and self._topdown_cache[0] == ver:
            free_binary, unobserved_binary = self._topdown_cache[1:]
        else:
            with stage("queries/topdown"):
                free_binary, unobserved_binary = self._topdown_inc.refresh(self.mapper.buf)
            self._topdown_cache = (ver, free_binary, unobserved_binary)
        response = {
            "free_map": free_binary,
            "visible_map": unobserved_binary,
        }
        if arrived_flag and self.last_frame is not None:
            # horizon = AABB of the current frame's valid-depth cloud
            # (visualizer.py:1392-1399), float32 on the host
            depth = self.last_frame["depth"]
            c2w = self.last_frame["c2w"]
            s = self.dataset.sensor
            pts = backproject(
                torch.as_tensor(depth, dtype=torch.float32), s.fx, s.fy, s.cx, s.cy,
                torch.as_tensor(c2w, dtype=torch.float32),
            ).numpy()
            pts = pts[depth.reshape(-1) > 0]
            if len(pts) == 0:
                pts = c2w[None, :3, 3]
            response["horizon_bound_min"] = pts.min(0)
            response["horizon_bound_max"] = pts.max(0)
        return response

    def _get_opacity(self, arrived_flag: bool, nodes=None, nodes_id=None):
        """Global (per-node panorama scores) or local (reorientation) query
        (visualizer.py:2180-2221 + splatam/__init__.py:697-838)."""
        if self.global_state == GlobalState.QUIT or self.last_frame is None:
            return None
        view_c2w = np.asarray(self.last_frame["c2w"], np.float64)
        if arrived_flag:
            positions = np.asarray(nodes, np.float64).reshape(-1, 3)
            scores = self._global_scores_cached(view_c2w, positions)
            return {
                "targets_frustums_invisibility": [s[0] for s in scores],
                "targets_frustums_volume": [s[1] for s in scores],
                "nodes_id": list(nodes_id) if nodes_id is not None else [],
            }
        with stage("queries/panorama_local"):
            total, best_pose, _invis = self.mapper.get_local_invisibility(view_c2w)
        # High-loss reorientation proposal, computed lazily at its single
        # consumption point (here) from the current frame and map; the
        # reference recomputes it at the top of every __mapping
        # (splatam/__init__.py:256-258). Same data, same consumer, fresher
        # map state, one render per local query instead of one per step.
        with stage("mapper/high_loss"):
            self.mapper.high_loss_samples_pose_c2w = (
                self.mapper.get_high_loss_samples(
                    self.last_frame["rgb"], self.last_frame["depth"],
                    view_c2w,
                )
                if self.mapper.num_gaussians() > 0
                else None
            )
        frustums = [best_pose]  # None means no proposal (reference Pose() zero)
        if self.mapper.high_loss_samples_pose_c2w is not None:
            frustums.append(self.mapper.high_loss_samples_pose_c2w)
        return {
            "targets_frustums": frustums,
            "targets_frustums_invisibility": [total],
            "targets_frustums_volume": [0.0],
        }

    def _global_scores_cached(self, view_c2w, positions):
        """Per-node (invisibility, volume) with the position-keyed score
        cache; only stale nodes are re-rendered (one batched device call).
        Reuse requires an unchanged mapper.map_version ("version" mode) —
        exact by construction."""
        n = len(positions)
        ver = self.mapper.map_version
        results: list = [None] * n
        need: list = []
        for i, pos in enumerate(positions):
            if np.all(pos == 0):  # reference skip semantics (zero node)
                results[i] = (0.0, 0.0)
                continue
            # node pano height is the agent camera height, x/z from the node
            p3d = np.array([pos[0], view_c2w[1, 3], pos[2]])
            key = tuple(np.round(p3d / 0.05).astype(int))
            e = self._pano_cache.get(key)
            if (
                e is not None
                and self.pano_cache_mode != "off"
                and e["version"] == ver
            ):
                results[i] = (e["inv"], e["vol"])
                self.pano_cache_hits += 1
            else:
                need.append((i, key))
                self.pano_cache_misses += 1
                if e is not None:
                    self.pano_cache_stale += 1
        if need:
            with stage("queries/panorama_global"):
                scores = self.mapper.get_global_invisibility(
                    view_c2w, positions[[i for i, _ in need]]
                )
            for (i, key), (inv, vol, _reach) in zip(need, scores):
                results[i] = (inv, vol)
                self._pano_cache[key] = {"version": ver, "inv": inv, "vol": vol}
            if len(self._pano_cache) > self.pano_cache_capacity:
                drop = len(self._pano_cache) - self.pano_cache_capacity
                for key, _ in sorted(
                    self._pano_cache.items(), key=lambda kv: kv[1]["version"]
                )[:drop]:
                    del self._pano_cache[key]
        return results

    def _set_mapper(self, kf_every: int = 0, map_every: int = 0) -> Dict[str, int]:
        old = {
            "kf_every_old": self.mapper.get_kf_every(),
            "map_every_old": self.mapper.get_map_every(),
        }
        if map_every:
            self.mapper.set_map_every(map_every)
        if kf_every:
            self.mapper.set_kf_every(kf_every)
        return old

    def _reset_env(self):
        self.dataset.reset()
        self.movement_fail_times = 0
        return True
