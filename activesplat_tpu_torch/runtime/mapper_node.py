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
host. With `save_runtime_data` the runtime recorder (io/recorder.py) writes
the top-down maps, the local panoramas and, every `record_view_every` steps,
the current view and its 2x3 panel; with `live_view_port` the live view
(runtime/liveview.py) serves the same and an orbit render of the map. One
exact render and one host read of the current view feed both; the orbit
render runs once a map version, only with the live view.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from activesplat_tpu_torch.device import DeviceLike
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.mapper.geometry import backproject
from activesplat_tpu_torch.mapper.splatam import SplaTAMMapper
from activesplat_tpu_torch.planner import draw
from activesplat_tpu_torch.queries.panorama import PANO_VIEWS
from activesplat_tpu_torch.queries.topdown import (
    IncrementalTopdown,
    TopdownConfig,
    topdown_config_from_bbox,
)
from activesplat_tpu_torch.runtime.bus import Bus
from activesplat_tpu_torch.runtime.dataloader import SyntheticDataset, twist_to_action
from activesplat_tpu_torch.utils import GlobalState, PoseDataType, convert_to_c2w_opencv
from activesplat_tpu_torch.utils.tracing import attach, set_action, stage


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
        save_runtime_data: bool = False,
        save_dataset: bool = True,
        pano_scale: float = 1.0,
        record_view_every: int = 100,
        live_view_port: Optional[int] = None,
        pano_cache: str = "version",  # off | version
        pano_cache_capacity: int = 1024,
        device: DeviceLike = None,
    ) -> None:
        self.bus = bus
        self.dataset = dataset
        self.results_dir = results_dir
        self.save_runtime_data = save_runtime_data
        self.record_view_every = max(int(record_view_every), 1)
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
        # /map3d.png state: orbit render of the live Gaussian map, refreshed
        # on map_version change at the topdown polling cadence (headless
        # counterpart of the reference GUI's 3D widget + trajectory,
        # visualizer.py:1515-1664). The azimuth advances per refresh so the
        # dashboard view orbits as the map evolves.
        self._map3d_version = -1
        self._map3d_azimuth = 0.0
        self._trajectory: list = []
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
        self.recorder = None
        if save_runtime_data:
            from activesplat_tpu_torch.io.recorder import RuntimeRecorder

            self.recorder = RuntimeRecorder(results_dir)
        self.live_view = None
        if live_view_port is not None:
            from activesplat_tpu_torch.runtime.liveview import LiveView

            self.live_view = LiveView(live_view_port)
            print(f"live view: http://127.0.0.1:{self.live_view.port}/")

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
        self._trajectory.append(np.asarray(frame["c2w"], np.float64)[:3, 3].copy())
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
            set_action(self.dataset.get_step_info()[0])
            frame = self.dataset.get_frame()
        if not moved:
            self.movement_fail_times += 1
        else:
            self.movement_fail_times = 0
        with stage("mapper/frame"):
            self.mapper.run(frame)
        self.last_frame = frame
        if self.live_view is not None or self.recorder is not None:
            with stage("runtime/view"):
                self._record_view(frame)
        self._publish_pose(frame)
        if self.dataset.is_finished():
            self.finish()

    def _record_view(self, frame: Dict[str, np.ndarray]) -> None:
        """The live view's metrics every step; every record_view_every steps
        one exact render of the current view (one host read) feeds both the
        live view and the recorder's view and 2x3 panel."""
        step, budget = self.dataset.get_step_info()
        if self.live_view is not None:
            self.live_view.update_metrics({
                "step": step,
                "step_budget": budget,
                "num_gaussians": self.mapper.num_gaussians(),
                **self.mapper.last_metrics,
            })
        if step % self.record_view_every:
            return
        view = self.mapper.render_view(self.mapper._camera(np.linalg.inv(frame["c2w"])))
        if self.live_view is not None:
            self.live_view.update_view(view["rgb"], view["depth"])
        if self.recorder is not None:
            gt_d = np.asarray(frame["depth"], np.float64)
            mask = gt_d > 0
            diff = np.abs(gt_d - view["depth"])[mask]
            depth_l1 = float(diff.mean()) if mask.any() else 0.0
            err = np.mean((np.asarray(frame["rgb"], np.float64) - view["rgb"]) ** 2)
            psnr = float(-10.0 * np.log10(max(err, 1e-12)))
            self.recorder.save_rgbd_silhouette(
                step, frame["rgb"], gt_d, view["rgb"], view["depth"], view["opacity"], psnr,
                depth_l1,
            )
            rgb8 = (np.clip(view["rgb"], 0, 1) * 255).astype(np.uint8)
            self.recorder.save_view(step, rgb8, view["depth"])

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
        # gt_mesh.json: GT-mesh pointer for offline judges, written when the
        # dataset is backed by a scene mesh (visualizer.py:1185-1190)
        cfg_ds = self.dataset.dataset_config(self.results_dir)
        mesh_url = cfg_ds.get("scene_mesh_url")
        if mesh_url and os.path.exists(mesh_url):
            tf = np.asarray(cfg_ds.get("scene_mesh_transform", np.eye(4))).tolist()
            with open(os.path.join(self.results_dir, "gt_mesh.json"), "w") as fh:
                json.dump({"mesh_url": mesh_url, "mesh_transform": tf}, fh, indent=4)
        if self.live_view is not None:
            self.live_view.close()
        if self.bus.has_service("set_planner_state"):
            self.bus.call("set_planner_state", GlobalState.QUIT)

    # ------------------------------------------------------------------ #
    # services

    def _orbit_c2w(self, azimuth_rad: float) -> np.ndarray:
        """OpenCV c2w orbiting the scene center at ~50 deg elevation, framed
        from the topdown grid's bbox (so the whole explored slab is visible)."""
        cfg = self.topdown_cfg
        du, dv = cfg.world_dim_index
        (u0, u1), (v0, v1) = cfg.world_2d_bbox
        center = np.zeros(3)
        center[du], center[dv] = cfg.world_center
        center[cfg.height_axis] = 0.5 * (cfg.agent_foot + cfg.agent_head)
        extent = max(u1 - u0, v1 - v0)
        eye = center.copy()
        eye[du] += 0.8 * extent * np.cos(azimuth_rad)
        eye[dv] += 0.8 * extent * np.sin(azimuth_rad)
        eye[cfg.height_axis] += 0.95 * extent
        up = np.zeros(3)
        up[cfg.height_axis] = 1.0
        fwd = center - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
        return c2w

    def _update_map3d(self, map_version: int) -> None:
        """Refresh /map3d.png: one exact render of the full map from the
        orbit camera, with the agent trajectory projected on top (drawn with
        planner/draw.py's OpenCV rules). Costs one render per map change and
        only runs when the live view is enabled."""
        if self.live_view is None or map_version == self._map3d_version:
            return
        self._map3d_version = map_version
        self._map3d_azimuth += np.deg2rad(15.0)
        c2w = self._orbit_c2w(self._map3d_azimuth)
        w2c = np.linalg.inv(c2w)
        view = self.mapper.render_view(self.mapper._camera(w2c))
        img = (np.clip(view["rgb"], 0, 1) * 255).astype(np.uint8).copy()
        if self._trajectory:
            pts = np.asarray(self._trajectory, np.float64)
            pc = (w2c[:3, :3] @ pts.T).T + w2c[:3, 3]
            K = self.mapper.intrinsics
            z = pc[:, 2]
            uv = np.stack(
                [
                    K[0, 0] * pc[:, 0] / np.maximum(z, 1e-6) + K[0, 2],
                    K[1, 1] * pc[:, 1] / np.maximum(z, 1e-6) + K[1, 2],
                ],
                axis=1,
            )
            ok = z > 1e-3
            # draw visible polyline segments (both endpoints in front)
            ij = uv.astype(np.int32)
            for a in range(len(ij) - 1):
                if ok[a] and ok[a + 1]:
                    draw.line(img, tuple(ij[a]), tuple(ij[a + 1]), (64, 200, 255), 1)
            if ok[-1]:
                draw.circle(img, tuple(ij[-1]), 3, (255, 80, 80), -1)
        self.live_view.update_map3d(img)

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
            if self.recorder is not None:
                self.recorder.save_topdown(free_binary, unobserved_binary)
            if self.live_view is not None:
                self.live_view.update_topdown(free_binary, unobserved_binary)
                with stage("runtime/map3d"):
                    self._update_map3d(ver)
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
            total, best_pose, invis = self.mapper.get_local_invisibility(view_c2w)
            attach(views=PANO_VIEWS)
        if self.live_view is not None:
            self.live_view.update_panorama(invis)
        if self.recorder is not None:
            step, _ = self.dataset.get_step_info()
            self.recorder.save_panorama(step, "local", invis)
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
                attach(views=PANO_VIEWS * len(need))
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
