"""Exploration planner: an explicit synchronous state machine (counterpart
of activesplat_tpu/runtime/planner_fsm.py, drawing and testing pixels with
the port's numpy rules in planner/draw.py in place of OpenCV).

Re-design of the reference's 1694-line planner node
(scripts/nodes/planner_node.py) with the same behaviors — bootstrap spin with
tilt interleaving, Voronoi-node scoring (UNARRIVED/IN_HORIZON/
OPACITY_INVISIBILITY/HOLE_INVISIBILITY/FAIL weights), hierarchical subregion
planning, safe-path following with whole-path line tests, local-view
refinement at arrivals, high-connectivity stopovers, and escape recovery with
an inaccessible-direction database — but as an explicit five-state FSM driven
synchronously over the in-process bus (no ROS, no Condition rendezvous).

States: BOOTSTRAP -> SELECT_TARGET -> NAVIGATE -> LOCAL_REFINE (-> NAVIGATE
continuation at junction stopovers) and ESCAPE (entered from NAVIGATE on
movement failure).
"""

from __future__ import annotations

import os
from enum import Enum
from typing import Dict, List, Optional, Tuple

import numpy as np

from activesplat_tpu_torch.planner import draw
from activesplat_tpu_torch.planner.navigation import get_escape_plan, safe_dijkstra_path
from activesplat_tpu_torch.planner.occupancy import build_obstacle_map
from activesplat_tpu_torch.planner.viz import (
    draw_subregions,
    draw_voronoi_graph,
    imwrite,
    visualize_agent,
)
from activesplat_tpu_torch.planner.voronoi import (
    VoronoiGraph,
    build_voronoi_graph,
    closest_node,
    closest_reachable_vertex,
    compute_subregions,
)
from activesplat_tpu_torch.queries.topdown import (
    TopdownConfig,
    heading_to_topdown,
    horizon_bbox_topdown,
    topdown_to_world,
    world_to_topdown,
)
from activesplat_tpu_torch.runtime.bus import Bus
from activesplat_tpu_torch.utils import GlobalState
from activesplat_tpu_torch.utils.tracing import attach, count, stage

# constants-as-flags (reference: scripts/nodes/__init__.py:13-18)
USE_RANDOM_SELECTION = False
USE_ROTATION_SELECTION = True
USE_HIGH_CONNECTIVITY = True
USE_HIERARCHICAL_PLAN = True

# node scoring weights (planner_node.py:54-61)
WEIGHTS_INIT = {
    "UNARRIVED": 20,
    "IN_HORIZON": 10,
    "OPACITY_INVISIBILITY": 2,
    "HOLE_INVISIBILITY": 1,
    "REAL_OPACITY_INVISIBILITY": 1,
    "FAIL": -60,
}
SUBREGION_MAX_SCORE_THRESHOLD = 250  # planner_node.py:281

# the knobs of a scene config's `planner` block, with the FSM's defaults
# (the Gibson configs' values); PlannerFSM reads the block in its
# get_dataset_config payload (planner_knobs)
PLANNER_DEFAULTS = {
    "step_num_as_visited": 10.0,
    "step_num_as_arrived": 1.5,
    "local_view_limit": 5,
    "radius_num_as_rotated": 3.0,
    "max_pitch_angle": 45.0,
}
# `obstacle_approx_precision` is 7.5 in every upstream config, in a unit
# this package does not establish; the contour approximation's 0.225 m
# stands for it, and another value is refused rather than converted
UPSTREAM_APPROX_PRECISION = 7.5
APPROX_PRECISION_M = 0.225


def planner_knobs(block: Optional[Dict], **passed) -> Dict:
    """The FSM's knobs: each one `passed` as other than None, else the
    scene config's planner block's, else PLANNER_DEFAULTS' (and
    `obstacle_approx_precision_m`, 0.225 m). Raises ValueError naming the
    key when the block's obstacle_approx_precision is read and is not
    7.5."""
    block = block or {}
    if passed.get("obstacle_approx_precision_m") is None:
        precision = block.get("obstacle_approx_precision", UPSTREAM_APPROX_PRECISION)
        if float(precision) != UPSTREAM_APPROX_PRECISION:
            raise ValueError(
                f"planner block: obstacle_approx_precision {precision!r} has no known "
                f"meaning here; only {UPSTREAM_APPROX_PRECISION} (read as "
                f"{APPROX_PRECISION_M} m) is taken")
    knobs = {key: type(default)(block.get(key, default))
             for key, default in PLANNER_DEFAULTS.items()}
    knobs["obstacle_approx_precision_m"] = APPROX_PRECISION_M
    knobs.update({key: value for key, value in passed.items() if value is not None})
    return knobs


class PlannerState(Enum):
    BOOTSTRAP = "BOOTSTRAP"
    SELECT_TARGET = "SELECT_TARGET"
    NAVIGATE = "NAVIGATE"
    LOCAL_REFINE = "LOCAL_REFINE"
    ESCAPE = "ESCAPE"
    DONE = "DONE"


def _twist(vx=0.0, wy=0.0, wz=0.0):
    return {"linear": np.array([vx, 0.0, 0.0]), "angular": np.array([0.0, wy, wz])}


TURN_LEFT = _twist(wz=0.2)
TURN_RIGHT = _twist(wz=-0.2)
LOOK_UP = _twist(wy=-1.0)
LOOK_DOWN = _twist(wy=1.0)
FORWARD = _twist(vx=0.2)


class PlannerFSM:
    def __init__(
        self,
        bus: Bus,
        step_num_as_visited: Optional[float] = None,
        step_num_as_arrived: Optional[float] = None,
        step_num_as_too_far: float = 200,
        obstacle_approx_precision_m: Optional[float] = None,
        local_view_limit: Optional[int] = None,
        radius_num_as_rotated: Optional[float] = None,
        max_pitch_angle: Optional[float] = None,
        seed: int = 1,
        save_runtime_data: bool = False,
        manual_target_provider=None,
        live_view=None,
    ) -> None:
        self.bus = bus
        self.rng = np.random.default_rng(seed)
        self.save_runtime_data = save_runtime_data
        self.live_view = live_view  # dashboard overlays (runtime/liveview.py)

        ds = bus.call("get_dataset_config")
        td = bus.call("get_topdown_config")
        knobs = planner_knobs(
            ds.get("planner"),
            step_num_as_visited=step_num_as_visited,
            step_num_as_arrived=step_num_as_arrived,
            obstacle_approx_precision_m=obstacle_approx_precision_m,
            local_view_limit=local_view_limit,
            radius_num_as_rotated=radius_num_as_rotated,
            max_pitch_angle=max_pitch_angle,
        )
        self.results_dir = ds["results_dir"]
        self.turn_angle = float(ds["agent_turn_angle"])
        self.tilt_angle = float(ds["agent_tilt_angle"])
        self.topdown_cfg = TopdownConfig(
            height_axis=1,
            world_dim_index=tuple(td["world_dim_index"]),
            world_2d_bbox=tuple(td["world_2d_bbox"]),
            grid_shape=tuple(td["grid_map_shape"]),
            meter_per_pixel=float(td["meter_per_pixel"]),
            world_center=(0.0, 0.0),
            agent_foot=0.0,
            agent_head=0.0,
        )
        mpp = self.topdown_cfg.meter_per_pixel
        self.agent_radius_px = float(ds["agent_radius"]) / mpp
        self.step_px = float(ds["agent_forward_step_size"]) / mpp
        self.px_as_visited = self.step_px * knobs["step_num_as_visited"]
        self.px_as_arrived = self.step_px * knobs["step_num_as_arrived"]
        self.max_steps_to_target = step_num_as_too_far
        self.approx_precision_px = knobs["obstacle_approx_precision_m"] / mpp
        self.local_view_limit = knobs["local_view_limit"]
        self.radius_num_as_rotated = knobs["radius_num_as_rotated"]
        self.max_pitch_angle = knobs["max_pitch_angle"]
        self.camera_height = float(np.asarray(ds["rgbd_position"])[1])

        self.weights = dict(WEIGHTS_INIT) if not USE_RANDOM_SELECTION else None

        # pose + event state fed by topics
        self.pose: Dict[str, np.ndarray] = {}
        self.movement_fail_times = 0
        self.escape_requested = False
        self.high_loss_pose_c2w: Optional[np.ndarray] = None
        self.state = PlannerState.BOOTSTRAP
        self.global_state = GlobalState.AUTO_PLANNING
        # MANUAL_PLANNING: targets come from this callback instead of node
        # scoring — the headless stand-in for the reference's double-click
        # handler (planner_node.py:1296-1334). Called with (voronoi_graph,
        # agent_px); returns a topdown (x, y) click or None to keep waiting.
        self.manual_target_provider = manual_target_provider

        # exploration memory
        self.visited_px = np.zeros((0, 2))
        self.fail_vertices = np.zeros((0, 2))
        self.fail_nodes_index: List[int] = []
        self.rotation_observed_px = np.zeros((0, 2))
        self.position_selected_px = np.zeros((0, 2))
        self.inaccessible_db: Dict[Tuple[float, float], np.ndarray] = {}
        self.horizon_bbox_px: Optional[np.ndarray] = None
        self.horizon_bbox_px_translation: Optional[np.ndarray] = None

        # working maps / graph
        self.free_map: Optional[np.ndarray] = None
        self.vg: Optional[VoronoiGraph] = None
        self.subregions: Dict[int, int] = {}
        self.nodes_score: Optional[np.ndarray] = None
        self.nodes_invis_score: Optional[np.ndarray] = None
        self.navigation_path: Optional[np.ndarray] = None
        self.navigation_target_index: Optional[int] = None
        self.whole_navigation_path_3d: Optional[np.ndarray] = None

        # local-refine state
        self.local_targets: List[Optional[np.ndarray]] = []
        self.local_view_count = 1
        self.continue_global_navigation = False
        self.high_connectivity_view_count = 0
        self.saved_mapper_schedule: Optional[Dict[str, int]] = None
        self._last_twist = _twist()
        # planning-livelock breaker: consecutive SELECT<->NAVIGATE bounces
        # with no physical movement (reference escalation only covers
        # dijkstra and movement failures; the navigate-tick whole-path line
        # test can reject every fresh plan forever when the agent sits in a
        # free-map pocket)
        self._no_move_bounces = 0
        # decision ledger: one dict per planner decision (state transitions,
        # target picks with their scores, refine begin/end, bounces, score
        # rounds), written to planner_log.jsonl by save_results: the record
        # behind diagnosing an exploration stall.
        self.decision_log: List[Dict] = []
        self._tick_count = 0
        # scan-churn breaker (sibling of the livelock breaker above). Fresh
        # Voronoi nodes can keep appearing ~0.5 m ahead as the free map grows
        # toward an unexplored room, every one scoring top invisibility (they
        # all see the same unmapped void through the doorway); nearest-among-
        # ties selection hops to each, and every arrival pays a full
        # LOCAL_REFINE scan (~40 actions) while use_local never releases.
        # When the last 3 refines began within 2 px_as_visited of each
        # other, one selection round (a) ignores the local-subregion gate and
        # (b) breaks score ties by FARTHEST reachable node instead of
        # nearest, which moves the agent out of the saturated pocket.
        # Reference semantics resume next tick.
        self._refine_px_history: List[np.ndarray] = []
        self.scan_churn_breaks = 0

        bus.subscribe("camera_pose", self._on_pose)
        bus.subscribe("movement_fail_times", self._on_movement_fail)
        bus.subscribe("high_loss_samples_pose", self._on_high_loss_pose)
        bus.register_service("set_planner_state", self._set_state)
        bus.register_service("get_voronoi_graph", self._get_voronoi_graph)
        bus.register_service("get_navigation_path", self._get_navigation_path)
        # seed pose from the mapper's last publication, if any
        last = bus.last_message("camera_pose")
        if last is not None:
            self._on_pose(last)

    # ------------------------------------------------------------------ #
    # topic callbacks

    def _on_pose(self, c2w: np.ndarray) -> None:
        c2w = np.asarray(c2w, np.float64)
        uv = world_to_topdown(c2w[None, :3, 3], self.topdown_cfg)[0]
        forward = c2w[:3, 2]
        pitch = float(np.degrees(np.arcsin(np.clip(forward[1], -1, 1))))
        self.pose = {
            "c2w": c2w,
            "px": uv,
            "heading": heading_to_topdown(c2w, self.topdown_cfg),
            "pitch": pitch,
        }
        self.visited_px = np.vstack([self.visited_px, uv])

    def _on_movement_fail(self, count: int) -> None:
        if count > self.movement_fail_times and self.state == PlannerState.NAVIGATE:
            self.escape_requested = True
            if self.navigation_path is not None and 0 < len(self.navigation_path) < 100:
                self.fail_vertices = np.vstack(
                    [self.fail_vertices, self.navigation_path[-1]]
                )
        self.movement_fail_times = count

    def _on_high_loss_pose(self, c2w: np.ndarray) -> None:
        self.high_loss_pose_c2w = np.asarray(c2w, np.float64)

    def _set_state(self, state: GlobalState):
        self.global_state = state
        if state == GlobalState.QUIT:
            self.state = PlannerState.DONE
        return True

    def _get_voronoi_graph(self):
        if self.vg is None:
            return None
        nodes_3d = np.array(
            [
                topdown_to_world(self.vg.vertices[i], self.topdown_cfg, 0.0)
                for i in self.vg.nodes_index
            ]
        ).reshape(-1, 3)
        return {
            "vertices_px": self.vg.vertices,
            "nodes_index": self.vg.nodes_index,
            "nodes_position_3d": nodes_3d,
            "nodes_score": self.nodes_score,
            "high_connectivity_nodes_index": self.vg.high_connectivity_nodes_index,
        }

    def _get_navigation_path(self):
        return self.whole_navigation_path_3d

    # ------------------------------------------------------------------ #
    # movement helpers

    def _log(self, event: str, **fields) -> None:
        entry = {"tick": self._tick_count, "event": event}
        if self.pose:
            entry["px"] = [round(float(v), 1) for v in self.pose["px"]]
        entry.update(fields)
        self.decision_log.append(entry)

    def _move(self, twist) -> None:
        self._last_twist = twist
        self._no_move_bounces = 0
        self.bus.publish("cmd_vel", twist)

    def _bounce_to_select(self) -> None:
        """NAVIGATE -> SELECT_TARGET without having moved. Escalate like the
        reference's unreachable-target handling: after repeated bounces the
        current target joins the fail set (-60 score, planner_node.py:385-387
        semantics) so selection moves on; if bouncing persists across targets
        the FSM forces ESCAPE, whose rotate-and-probe physically breaks the
        free-map pocket causing every fresh plan to fail its line test."""
        self._no_move_bounces += 1
        self._log("bounce", n=self._no_move_bounces,
                  target=self.navigation_target_index)
        if (
            self._no_move_bounces % 3 == 0
            and self.navigation_target_index is not None
            and self.vg is not None
        ):
            self.fail_nodes_index.append(int(self.navigation_target_index))
            self.fail_vertices = np.vstack(
                [self.fail_vertices, self.vg.vertices[self.navigation_target_index]]
            )
        if self._no_move_bounces >= 24:
            self._no_move_bounces = 0
            self.state = PlannerState.ESCAPE
        else:
            self.state = PlannerState.SELECT_TARGET

    def _turn_towards(self, target_heading_rad: float) -> bool:
        """Issue one turn toward the heading; True if already aligned."""
        cur = np.arctan2(self.pose["heading"][1], self.pose["heading"][0])
        diff = (np.degrees(target_heading_rad - cur) + 180) % 360 - 180
        if diff > self.turn_angle:
            self._move(TURN_RIGHT)  # topdown v grows downward: positive diff = clockwise
            return False
        if diff < -self.turn_angle:
            self._move(TURN_LEFT)
            return False
        return True

    # ------------------------------------------------------------------ #
    # perception refresh

    def _refresh_maps(self, arrived: bool) -> bool:
        response = self.bus.call("get_topdown", arrived)
        if response is None:
            self.state = PlannerState.DONE
            return False
        free = response["free_map"].astype(np.uint8) * 255
        unobserved = response["visible_map"].astype(np.uint8) * 255
        kernel = np.ones((4, 4), np.uint8)  # MORPH_RECT (4, 4)
        with stage("planner/obstacle_map"):
            self.free_map, self._outer_contour, self._child_contours = (
                build_obstacle_map(
                    free,
                    unobserved,
                    self.pose["px"],
                    kernel,
                    self.approx_precision_px,
                )
            )
        if arrived and "horizon_bound_min" in response:
            self.horizon_bbox_px = horizon_bbox_topdown(
                response["horizon_bound_min"],
                response["horizon_bound_max"],
                self.topdown_cfg,
            )
        if self._last_twist["linear"][0] > 0 and self._last_twist["angular"][2] == 0:
            self.horizon_bbox_px_translation = (
                None if self.horizon_bbox_px is None else self.horizon_bbox_px.copy()
            )
        return True

    def _refresh_graph(self, arrived: bool) -> None:
        with stage("planner/voronoi_graph"):
            self.vg = build_voronoi_graph(
                self.free_map,
                self._outer_contour,
                self._child_contours,
                edge_sample_num=5,
                agent_radius_pixel=self.agent_radius_px,
                inaccessible_points=np.zeros((0, 2)),
            )
        if arrived:
            with stage("planner/subregions"):
                self.subregions = compute_subregions(
                    self.vg.graph,
                    self.vg.nodes_index,
                    self.vg.vertices,
                    self.topdown_cfg.meter_per_pixel,
                )
                attach(subregions=len(set(self.subregions.values())),
                       nodes=len(self.vg.nodes_index))
            with stage("planner/scores"):
                self._score_nodes()
        else:
            n = len(self.vg.nodes_index)
            self.nodes_score = np.full(n, self._score_max(), np.int64)
            self.nodes_invis_score = np.zeros(n, np.int64)

    def _score_max(self) -> int:
        if self.weights is None:
            return 1
        total = 0
        for key, value in self.weights.items():
            if value > 0 and key in ("OPACITY_INVISIBILITY", "HOLE_INVISIBILITY"):
                total += value * 10
            elif value > 0 and key != "REAL_OPACITY_INVISIBILITY":
                total += value
        return total

    def _is_close_to_obstacle(self, px: np.ndarray, threshold: float) -> bool:
        mask = draw.circle(
            np.zeros_like(self.free_map),
            np.int32(px),
            int(np.ceil(threshold)),
            255,
            -1,
        )
        return np.count_nonzero(mask & (self.free_map == 0).astype(np.uint8)) > 0

    def _is_rotation_observed(self, px: np.ndarray, radius_num: Optional[float] = None) -> bool:
        if len(self.rotation_observed_px) == 0:
            return False
        radius_num = radius_num if radius_num is not None else self.radius_num_as_rotated
        dists = np.linalg.norm(self.rotation_observed_px - px, axis=1)
        return bool(np.any(dists < self.agent_radius_px * radius_num))

    def _is_position_selected(self, px: np.ndarray) -> bool:
        if len(self.position_selected_px) == 0:
            return False
        return bool(
            np.any(np.linalg.norm(self.position_selected_px - px, axis=1) < self.px_as_visited)
        )

    def _is_arrived_position(self, px: np.ndarray) -> bool:
        if len(self.position_selected_px) == 0:
            return False
        return bool(
            np.any(np.linalg.norm(self.position_selected_px - px, axis=1) < self.px_as_arrived)
        )

    def _score_nodes(self) -> None:
        """Per-node exploration score (planner_node.py:1128-1256)."""
        vg = self.vg
        nodes_px = vg.vertices[vg.nodes_index]
        n = len(vg.nodes_index)
        if n == 0:  # a nodeless graph (e.g. straight corridor) scores nothing
            self.nodes_score = np.zeros(0, np.int64)
            self.nodes_invis_score = np.zeros(0, np.int64)
            return
        flags: Dict[str, np.ndarray] = {}

        if len(self.visited_px):
            d = np.min(
                np.linalg.norm(nodes_px[:, None] - self.visited_px[None], axis=-1), axis=1
            )
        else:
            d = np.full(n, np.inf)
        flags["UNARRIVED"] = (d > self.px_as_visited).astype(np.int64)

        if len(self.fail_vertices):
            df = np.min(
                np.linalg.norm(nodes_px[:, None] - self.fail_vertices[None], axis=-1),
                axis=1,
            )
        else:
            df = np.full(n, np.inf)
        flags["FAIL"] = (df <= self.agent_radius_px).astype(np.int64)

        # all unarrived nodes failed -> clear fails, re-tune weights
        # (planner_node.py:1150-1164)
        if self.weights is not None and np.all(
            (~flags["UNARRIVED"].astype(bool)) | flags["FAIL"].astype(bool)
        ):
            self.fail_vertices = np.zeros((0, 2))
            flags["FAIL"] = np.zeros(n, np.int64)
            self.weights["OPACITY_INVISIBILITY"] = 10
            self.weights["HOLE_INVISIBILITY"] = 10
            self.weights["IN_HORIZON"] = -1

        # global invisibility query — skip failed/obstacle-hugging/observed
        # nodes by sending a zero position (planner_node.py:1180-1215)
        node_positions = []
        for i, node_index in enumerate(vg.nodes_index):
            px = vg.vertices[node_index]
            if (
                node_index in self.fail_nodes_index
                or self._is_close_to_obstacle(px, self.agent_radius_px * 2.0)
                or self._is_rotation_observed(px, radius_num=1.0)
            ):
                if self._is_close_to_obstacle(px, self.agent_radius_px * 2.0):
                    self.fail_nodes_index.append(int(node_index))
                node_positions.append(np.zeros(3))
            else:
                node_positions.append(
                    topdown_to_world(px, self.topdown_cfg, self.camera_height)
                )
        response = self.bus.call(
            "get_opacity", True, np.asarray(node_positions), list(vg.nodes_index)
        )
        if response is None:
            self.state = PlannerState.DONE
            return
        invis = np.asarray(response["targets_frustums_invisibility"], np.float64)
        volume = np.asarray(response["targets_frustums_volume"], np.float64)
        max_invis = np.nanmax(invis) if len(invis) else 1.0
        max_volume = np.nanmax(volume) if len(volume) else 1.0
        flags["OPACITY_INVISIBILITY"] = np.ceil(
            invis / max(max_invis, 1e-9) * 10
        ).astype(np.int64)
        flags["HOLE_INVISIBILITY"] = np.ceil(volume / max(max_volume, 1e-9) * 10).astype(
            np.int64
        )
        flags["REAL_OPACITY_INVISIBILITY"] = np.ceil(invis).astype(np.int64)

        # IN_HORIZON: line-of-sight from agent + inside the last horizon bbox
        # (planner_node.py:1168-1200)
        free_pixels = np.count_nonzero(self.free_map)
        agent_mask = draw.circle(
            np.zeros_like(self.free_map),
            np.int32(self.pose["px"]),
            int(np.ceil(self.agent_radius_px)),
            255,
            -1,
        )
        los = []
        for px in nodes_px:
            test = draw.line(
                self.free_map.copy(), np.int32(self.pose["px"]), np.int32(px), 255, 1
            )
            test[agent_mask > 0] = self.free_map[agent_mask > 0]
            los.append(np.count_nonzero(test) == free_pixels)
        los = np.asarray(los, bool)  # explicit dtype: [] defaults to float64
        if self.horizon_bbox_px_translation is not None:
            bb = self.horizon_bbox_px_translation
            in_bb = (
                (nodes_px[:, 0] >= bb[0, 0])
                & (nodes_px[:, 0] <= bb[1, 0])
                & (nodes_px[:, 1] >= bb[0, 1])
                & (nodes_px[:, 1] <= bb[1, 1])
            )
            combined = in_bb & los
            if combined.any():
                los = combined
        flags["IN_HORIZON"] = los.astype(np.int64)

        self.nodes_score = np.zeros(n, np.int64)
        self.nodes_invis_score = np.zeros(n, np.int64)
        if self.weights is not None:
            for key, flag in flags.items():
                if key == "REAL_OPACITY_INVISIBILITY":
                    self.nodes_invis_score += self.weights[key] * flag
                else:
                    self.nodes_score += self.weights[key] * flag
        self._log(
            "scores", n_nodes=n, n_fail=len(self.fail_nodes_index),
            max_invis=int(self.nodes_invis_score.max()) if n else 0,
            max_score=int(self.nodes_score.max()) if n else 0,
            n_unarrived=int(flags["UNARRIVED"].sum()),
        )

    # ------------------------------------------------------------------ #
    # state handlers

    # states in which the FSM acts; in PAUSE / MANUAL_CONTROL / REPLAY the
    # planner idles and movement comes from elsewhere (reference
    # __ENABLE_STATES, planner_node.py:65)
    ENABLE_STATES = (GlobalState.AUTO_PLANNING, GlobalState.MANUAL_PLANNING)

    def tick(self) -> None:
        if self.global_state == GlobalState.QUIT:
            self.state = PlannerState.DONE
            return
        if self.global_state not in self.ENABLE_STATES:
            import time as _time

            _time.sleep(0.02)  # idle; movement comes from elsewhere
            return
        was_select = self.state == PlannerState.SELECT_TARGET
        prev_state = self.state
        handler = {
            PlannerState.BOOTSTRAP: self._tick_bootstrap,
            PlannerState.SELECT_TARGET: self._tick_select_target,
            PlannerState.NAVIGATE: self._tick_navigate,
            PlannerState.LOCAL_REFINE: self._tick_local_refine,
            PlannerState.ESCAPE: self._tick_escape,
        }[self.state]
        with stage("planner/tick"):  # includes the actions the tick issues
            if was_select:
                with stage("planner/select_target"):
                    handler()
            else:
                handler()
        self._tick_count += 1
        if self.state is not prev_state:
            self._log(
                "state", frm=prev_state.value, to=self.state.value,
                visited=len(self.visited_px),
            )
        if was_select:
            self._push_live_overlay()

    def run(self, max_ticks: int = 100000, verbose: bool = False) -> None:
        import os as _os
        import time as _time

        verbose = verbose or bool(_os.environ.get("ACTIVESPLAT_VERBOSE"))
        ticks = 0
        t0 = _time.time()
        while self.state != PlannerState.DONE and ticks < max_ticks:
            if verbose:
                print(
                    f"[planner {_time.time() - t0:7.1f}s] tick {ticks} "
                    f"state={self.state.value} visited={len(self.visited_px)}",
                    flush=True,
                )
            self.tick()
            ticks += 1
        self.save_results()

    # -- bootstrap: full spin with tilt interleaving (planner_node.py:164-242)

    def _tick_bootstrap(self) -> None:
        old = self.bus.call("set_mapper", kf_every=1, map_every=2)
        turns = int(np.ceil(360.0 / self.turn_angle))
        updown_times = 3
        for turn_index in range(turns):
            if self.global_state == GlobalState.QUIT:
                return
            self._move(TURN_LEFT)
            # tilt pattern: 3 down, 3 up, repeating (planner_node.py:198-200)
            down = (2 * updown_times - 1 - (turn_index % (2 * updown_times)) * 2) >= 0
            self._move(LOOK_DOWN if down else LOOK_UP)
        if turns % 2 == 1:
            self._move(LOOK_UP)
        self.bus.call(
            "set_mapper",
            kf_every=old["kf_every_old"],
            map_every=old["map_every_old"],
        )
        self.high_connectivity_view_count = 0
        self.state = PlannerState.SELECT_TARGET

    # -- target selection (planner_node.py:243-482)

    def _candidate_path(self, start_vertex: int, node_index: int):
        if np.linalg.norm(self.pose["px"] - self.vg.vertices[node_index]) < self.px_as_arrived:
            return None, None
        with stage("planner/dijkstra"):
            path_idx, path, connected = safe_dijkstra_path(
                self.vg.graph,
                start_vertex,
                int(node_index),
                self.vg.vertices,
                self.free_map,
                self.pose["px"],
                self.agent_radius_px,
            )
        if not connected:
            self.fail_nodes_index.append(int(node_index))
            self.fail_vertices = np.vstack(
                [self.fail_vertices, self.vg.vertices[node_index]]
            )
        if path is None:
            return None, None
        whole = np.vstack([self.pose["px"], path])
        length = float(np.sum(np.linalg.norm(np.diff(whole, axis=0), axis=1)))
        return path, length

    def _select_manual_target(self, start_vertex: int) -> None:
        """MANUAL_PLANNING target selection: a user-supplied topdown click
        replaces node scoring. Click resolution mirrors the reference's
        mouse_callback (planner_node.py:1296-1334): the nearest Voronoi node
        within 20 px wins, farther clicks are ignored; unreachable picks are
        recorded in the fail set exactly like scored targets."""
        click = (
            self.manual_target_provider(self.vg, self.pose["px"])
            if self.manual_target_provider is not None
            else None
        )
        if click is None:
            return  # keep waiting for a selection; maps stay fresh each tick
        click = np.asarray(click, np.float64).reshape(2)
        nodes_px = self.vg.vertices[self.vg.nodes_index]
        dist = np.linalg.norm(nodes_px - click, axis=1)
        if len(dist) == 0 or float(dist.min()) > 20.0:
            return
        node_index = int(np.asarray(self.vg.nodes_index)[int(np.argmin(dist))])
        path, _length = self._candidate_path(start_vertex, node_index)
        if path is None:
            return
        self.navigation_path = path
        self.navigation_target_index = node_index
        self.whole_navigation_path_3d = np.array(
            [
                topdown_to_world(p, self.topdown_cfg, 0.0)
                for p in np.vstack([self.pose["px"], path])
            ]
        )
        self.state = PlannerState.NAVIGATE

    def _tick_select_target(self) -> None:
        if not self._refresh_maps(arrived=True):
            return
        self._refresh_graph(arrived=True)
        if self.state == PlannerState.DONE or self.vg is None:
            return
        if len(self.vg.nodes_index) == 0:
            self.state = PlannerState.BOOTSTRAP
            return

        start_vertex = closest_reachable_vertex(
            self.vg.vertices, self.free_map, self.pose["px"], self.agent_radius_px
        )
        if self.global_state == GlobalState.MANUAL_PLANNING:
            self._select_manual_target(start_vertex)
            return
        closest = closest_node(self.vg.vertices, self.vg.nodes_index, self.pose["px"])

        # hierarchical subregion plan (planner_node.py:267-344)
        nodes_index = np.asarray(self.vg.nodes_index)
        nodes_score = np.asarray(self.nodes_score)
        churn = self._scan_churn()  # scan-churn breaker (see __init__ note)
        if USE_HIERARCHICAL_PLAN and closest in self.subregions:
            current_subregion = self.subregions[closest]
            in_cur = np.array(
                [self.subregions.get(int(i)) == current_subregion for i in nodes_index]
            )
            cur_scores = nodes_score.copy()
            cur_invis = np.asarray(self.nodes_invis_score).copy()
            arrived_count = 0
            for pos, node_index in enumerate(nodes_index):
                if not in_cur[pos]:
                    continue
                if self._is_position_selected(self.vg.vertices[node_index]):
                    cur_scores[pos] = 0
                    arrived_count += 1
                if cur_scores[pos] <= 0:
                    cur_invis[pos] = 0
            cur_invis_in = cur_invis[in_cur] if in_cur.any() else np.zeros(1)
            all_visited = arrived_count == int(in_cur.sum())
            use_local = (
                not all_visited
                and np.nanmax(cur_invis_in) >= SUBREGION_MAX_SCORE_THRESHOLD
                and not churn
            )
            self._log(
                "subregion", use_local=bool(use_local),
                all_visited=bool(all_visited), churn=bool(churn),
                max_invis_in=int(np.nanmax(cur_invis_in)),
                arrived=int(arrived_count), members=int(in_cur.sum()),
            )
            if churn:
                self.scan_churn_breaks += 1
            switch = False
            if use_local:
                sel_index = nodes_index[in_cur]
                sel_score = cur_scores[in_cur]
            else:
                # global: pick the best-scoring *other* subregion
                # (planner_node.py:296-341)
                best_subregion, best_subregion_score = None, -np.inf
                for subregion in set(self.subregions.values()):
                    if subregion == current_subregion:
                        continue
                    member = np.array(
                        [self.subregions.get(int(i)) == subregion for i in nodes_index]
                    )
                    if not member.any():
                        continue
                    usable = member & ~np.array(
                        [self._is_arrived_position(self.vg.vertices[i]) for i in nodes_index]
                    )
                    score = nodes_score[usable].max() if usable.any() else 0
                    if score > best_subregion_score:
                        best_subregion_score, best_subregion = score, subregion
                if best_subregion is None:
                    sel_index, sel_score = nodes_index, nodes_score
                else:
                    switch = True
                    member = np.array(
                        [self.subregions.get(int(i)) == best_subregion for i in nodes_index]
                    )
                    sel_index = nodes_index[member]
                    sel_score = nodes_score[member]
            # the plan keeps the current subregion, or leaves it for the
            # best-scoring other one (neither when there is no other)
            count("stay", int(use_local))
            count("switch", int(switch))
        else:
            sel_index, sel_score = nodes_index, nodes_score

        # score-descending selection, nearest-first among ties, too-far
        # deferral (planner_node.py:345-473)
        self.navigation_path = None
        deferred = None
        if len(sel_index):
            for score in range(int(sel_score.max()), int(sel_score.min()) - 1, -1):
                tied = sel_index[sel_score == score]
                if len(tied) == 0:
                    continue
                paths, lengths = [], []
                for node_index in tied:
                    path, length = self._candidate_path(start_vertex, node_index)
                    paths.append(path)
                    lengths.append(np.nan if length is None else length)
                lengths = np.asarray(lengths, np.float64)
                if np.all(np.isnan(lengths)):
                    continue
                if self.weights is None:
                    choice = int(self.rng.choice(np.where(~np.isnan(lengths))[0]))
                elif churn:
                    # scan-churn breaker: leave the saturated pocket — pick
                    # the FARTHEST reachable node of this score tier instead
                    # of the nearest (one selection round only)
                    choice = int(np.nanargmax(lengths))
                else:
                    choice = int(np.nanargmin(lengths))
                if lengths[choice] > self.max_steps_to_target * self.step_px:
                    if deferred is None:
                        deferred = (tied[choice], paths[choice])
                    continue
                self.navigation_path = paths[choice]
                self.navigation_target_index = int(tied[choice])
                break
        if self.navigation_path is None and deferred is not None:
            self.navigation_target_index, self.navigation_path = (
                int(deferred[0]),
                deferred[1],
            )
        if self.navigation_path is None:
            # nothing reachable: re-bootstrap with a forced global plan
            # (planner_node.py:474-479)
            self._log("no_target", n_nodes=len(nodes_index),
                      n_fail=len(self.fail_nodes_index))
            self.state = PlannerState.BOOTSTRAP
            return
        self.whole_navigation_path_3d = np.array(
            [
                topdown_to_world(p, self.topdown_cfg, 0.0)
                for p in np.vstack([self.pose["px"], self.navigation_path])
            ]
        )
        tgt = int(self.navigation_target_index)
        pos = np.where(nodes_index == tgt)[0]
        self._log(
            "target",
            node=tgt,
            node_px=[round(float(v), 1) for v in self.vg.vertices[tgt]],
            score=int(nodes_score[pos[0]]) if len(pos) else None,
            invis=int(np.asarray(self.nodes_invis_score)[pos[0]])
            if len(pos) else None,
            path_px=round(
                float(np.sum(np.linalg.norm(
                    np.diff(np.vstack([self.pose["px"], self.navigation_path]),
                            axis=0), axis=1))), 1),
            n_nodes=len(nodes_index), n_fail=len(self.fail_nodes_index),
        )
        self.state = PlannerState.NAVIGATE

    # -- path following (planner_node.py:674-774)

    def _tick_navigate(self) -> None:
        if self.escape_requested:
            self.escape_requested = False
            self.state = PlannerState.ESCAPE
            return
        if not self._refresh_maps(arrived=False):
            return
        if self.navigation_path is None or len(self.navigation_path) == 0:
            self._bounce_to_select()
            return
        px = self.pose["px"]
        self.whole_navigation_path_3d = np.array(
            [
                topdown_to_world(p, self.topdown_cfg, 0.0)
                for p in np.vstack([px, self.navigation_path])
            ]
        )

        # arrival
        if np.linalg.norm(px - self.navigation_path[-1]) < self.px_as_arrived:
            count("arrived")
            if USE_ROTATION_SELECTION and not self._is_rotation_observed(px):
                self.continue_global_navigation = False
                self._begin_local_refine()
            else:
                self._bounce_to_select()
            return

        # drop passed waypoints
        start = 0
        for i, waypoint in enumerate(self.navigation_path):
            if np.linalg.norm(px - waypoint) <= self.step_px:
                start = i + 1
        self.navigation_path = self.navigation_path[start:]
        if len(self.navigation_path) == 0:
            self._bounce_to_select()
            return

        # high-connectivity stopover (planner_node.py:711-725)
        if (
            USE_HIGH_CONNECTIVITY
            and len(self.vg.high_connectivity_nodes_index) > 0
            and self.high_connectivity_view_count < 3
            and not self._is_rotation_observed(px)
        ):
            hc = self.vg.vertices[self.vg.high_connectivity_nodes_index]
            if np.any(np.linalg.norm(hc - px, axis=1) < 1.5):
                self.continue_global_navigation = True
                self._begin_local_refine()
                return

        # whole-path safety line test (planner_node.py:735-756)
        whole = np.vstack([px, self.navigation_path])
        if len(whole) >= 2:
            if len(whole) < 20 and self._is_close_to_obstacle(
                self.navigation_path[-1], self.agent_radius_px
            ):
                if USE_ROTATION_SELECTION:
                    self.continue_global_navigation = False
                    self._begin_local_refine()
                else:
                    self.state = PlannerState.SELECT_TARGET
                return
            seg_len = np.linalg.norm(np.diff(whole, axis=0), axis=1)
            acc = np.cumsum(seg_len)
            within = acc <= self.px_as_visited
            if not within.any():
                whole = whole[:2]
            elif not within.all():
                whole = whole[: int(np.argmin(within))]
            free_pixels = np.count_nonzero(self.free_map)
            test = draw.polylines(
                self.free_map.copy(), [np.int32(whole)], False, 255, 1
            )
            agent_mask = draw.circle(
                np.zeros_like(self.free_map),
                np.int32(px),
                int(np.ceil(self.agent_radius_px)),
                255,
                -1,
            )
            test[agent_mask > 0] = self.free_map[agent_mask > 0]
            if np.count_nonzero(test) != free_pixels:
                self._bounce_to_select()
                return

        # heading / step control
        diff = self.navigation_path[0] - px
        target_heading = np.arctan2(diff[1], diff[0])
        if self._turn_towards(target_heading):
            if np.linalg.norm(diff) > self.step_px:
                self._move(FORWARD)
            else:
                self.navigation_path = self.navigation_path[1:]

    # -- local refinement at arrivals (planner_node.py:483-673)

    def _scan_churn(self) -> bool:
        """True when the last 3 LOCAL_REFINE scans all began within
        px_as_visited of the most recent one — the agent is farming scans
        inside one pocket (see the breaker note in __init__)."""
        if len(self._refine_px_history) < 3:
            return False
        last = np.asarray(self._refine_px_history[-3:])
        # 2x the visited radius: scans that close together cannot see
        # meaningfully different panoramas
        return bool(
            np.all(
                np.linalg.norm(last - last[-1], axis=1)
                < 2.0 * self.px_as_visited
            )
        )

    def _begin_local_refine(self) -> None:
        self._log("refine_begin",
                  continue_global=bool(self.continue_global_navigation))
        self._refine_px_history.append(np.asarray(self.pose["px"], np.float64))
        del self._refine_px_history[:-4]
        self.state = PlannerState.LOCAL_REFINE
        self.local_view_count = 1
        self.local_targets = []
        self._local_query_pending = True
        self.saved_mapper_schedule = self.bus.call("set_mapper", kf_every=2, map_every=2)

    def _end_local_refine(self) -> None:
        # the views this refine consumed: at most local_view_limit, or 4
        # while a global navigation continues
        attach(views=self.local_view_count - 1)
        if self.saved_mapper_schedule is not None:
            self.bus.call(
                "set_mapper",
                kf_every=self.saved_mapper_schedule["kf_every_old"],
                map_every=self.saved_mapper_schedule["map_every_old"],
            )
            self.saved_mapper_schedule = None
        self.rotation_observed_px = np.vstack([self.rotation_observed_px, self.pose["px"]])
        self.position_selected_px = np.vstack([self.position_selected_px, self.pose["px"]])
        if self.continue_global_navigation:
            self.continue_global_navigation = False
            self.high_connectivity_view_count += 1
            self.state = PlannerState.NAVIGATE
        else:
            self.high_connectivity_view_count = 0
            self.state = PlannerState.SELECT_TARGET

    def _tick_local_refine(self) -> None:
        if not self._refresh_maps(arrived=False):
            return
        px = self.pose["px"]
        if self._is_close_to_obstacle(px, self.agent_radius_px):
            self._end_local_refine()
            return
        if self._local_query_pending:
            response = self.bus.call("get_opacity", False)
            if response is None:
                self.state = PlannerState.DONE
                return
            self.local_targets = list(response["targets_frustums"])
            self._local_query_pending = False

        target = None
        for candidate in self.local_targets:
            if candidate is not None:
                target = np.asarray(candidate, np.float64)
                break

        if target is not None and self.local_view_count <= (
            self.local_view_limit if not self.continue_global_navigation else 4
        ):
            heading = heading_to_topdown(target, self.topdown_cfg)
            target_pitch = float(
                np.degrees(np.arcsin(np.clip(target[1, 2], -1, 1)))
            )
            target_pitch = float(np.clip(target_pitch, -self.max_pitch_angle, self.max_pitch_angle))
            diff_pitch = target_pitch - self.pose["pitch"]
            if abs(diff_pitch) > self.tilt_angle:
                pitch_before = self.pose["pitch"]
                self._move(LOOK_UP if diff_pitch > 0 else LOOK_DOWN)
                if abs(self.pose["pitch"] - pitch_before) > 1e-6:
                    return
                # tilt clamped by the simulator: fall through to yaw control
            if not self._turn_towards(np.arctan2(heading[1], heading[0])):
                return
            # aligned: this view is consumed; query again for the next one
            self.local_view_count += 1
            self._local_query_pending = True
            return

        # level the camera back to horizontal, then finish
        if abs(self.pose["pitch"]) >= self.tilt_angle - 1e-5:
            pitch_before = self.pose["pitch"]
            self._move(LOOK_DOWN if self.pose["pitch"] > 0 else LOOK_UP)
            if abs(self.pose["pitch"] - pitch_before) > 1e-6:
                return
        self._end_local_refine()

    # -- escape recovery (planner_node.py:775-867)

    def _tick_escape(self) -> None:
        if not self._refresh_maps(arrived=False):
            return
        px = self.pose["px"].copy()
        key = None
        if self.inaccessible_db:
            existing = np.array(list(self.inaccessible_db.keys())).reshape(-1, 2)
            dists = np.linalg.norm(existing - px, axis=1)
            if np.any(dists < self.step_px * 0.1):
                key = tuple(existing[int(np.argmin(dists))].tolist())
        if key is None:
            key = tuple(px.tolist())
            self.inaccessible_db.setdefault(key, np.zeros((0, 2)))

        direction, try_mask = get_escape_plan(
            self.free_map,
            np.asarray(key),
            self.pose["heading"],
            self.turn_angle,
            self.step_px,
            self.inaccessible_db[key],
            rng=self.rng,
        )
        turn_twist = TURN_RIGHT if direction > 0 else TURN_LEFT
        for try_translation in try_mask:
            if self.global_state == GlobalState.QUIT:
                return
            self._move(turn_twist)
            if not try_translation:
                continue
            fails_before = self.movement_fail_times
            self._move(FORWARD)
            if self.movement_fail_times == 0 or self.movement_fail_times < fails_before:
                # moved: escape done, replan
                if USE_ROTATION_SELECTION and not self._is_rotation_observed(self.pose["px"]):
                    self.continue_global_navigation = True
                    self._begin_local_refine()
                else:
                    self.state = PlannerState.SELECT_TARGET
                return
            # blocked: remember this direction as inaccessible
            self.inaccessible_db[key] = np.vstack(
                [self.inaccessible_db[key], self.pose["heading"]]
            )
        self.state = PlannerState.SELECT_TARGET

    # ------------------------------------------------------------------ #

    def _push_live_overlay(self) -> None:
        """Voronoi graph + scores + planned path + agent (+ subregion map)
        onto the live-view dashboard after every SELECT_TARGET tick — the
        live counterpart of the reference planner's CV2 windows
        (planner_node.py:1294-1495); the same drawings previously existed
        only as end-of-run PNGs (save_results)."""
        if self.live_view is None or self.vg is None or self.free_map is None:
            return
        img = draw_voronoi_graph(
            self.free_map,
            self.vg.vertices,
            self.vg.graph,
            self.vg.nodes_index,
            self.nodes_score,
            self.vg.pruned_chains,
        )
        path = self.navigation_path
        if path is not None and len(path):
            pts = np.vstack([self.pose["px"], path]) if self.pose else path
            draw.polylines(img, [np.int32(pts)], False, (0, 215, 255), 1)
        if self.pose:
            img = visualize_agent(
                img,
                self.topdown_cfg.meter_per_pixel,
                self.pose["px"],
                self.pose["heading"],
            )
        self.live_view.update_planner(img)
        if self.subregions:
            self.live_view.update_subregions(
                draw_subregions(self.free_map, self.vg.vertices, self.subregions)
            )

    def save_results(self) -> None:
        """visited_map.png + topdown_free_map.png (planner_node.py:1652-1656)
        plus the decision ledger (planner_log.jsonl, see decision_log)."""
        if self.decision_log and self.results_dir:
            os.makedirs(self.results_dir, exist_ok=True)
            import json as _json

            with open(
                os.path.join(self.results_dir, "planner_log.jsonl"), "w"
            ) as fh:
                for entry in self.decision_log:
                    fh.write(_json.dumps(entry) + "\n")
        if self.free_map is None:
            return
        os.makedirs(self.results_dir, exist_ok=True)
        free_bgr = draw.gray2bgr(self.free_map)
        imwrite(os.path.join(self.results_dir, "topdown_free_map.png"), free_bgr)
        visited = free_bgr.copy()
        if len(self.visited_px) >= 2:
            draw.polylines(
                visited, [np.int32(self.visited_px)], False, (0, 0, 255), 1
            )
        if self.pose:
            visited = visualize_agent(
                visited,
                self.topdown_cfg.meter_per_pixel,
                self.pose["px"],
                self.pose["heading"],
            )
        imwrite(os.path.join(self.results_dir, "visited_map.png"), visited)
        if self.vg is not None:
            graph_img = draw_voronoi_graph(
                self.free_map,
                self.vg.vertices,
                self.vg.graph,
                self.vg.nodes_index,
                self.nodes_score,
                self.vg.pruned_chains,
            )
            imwrite(os.path.join(self.results_dir, "voronoi_graph.png"), graph_img)
            if self.subregions:
                imwrite(
                    os.path.join(self.results_dir, "subregion_map.png"),
                    draw_subregions(self.free_map, self.vg.vertices, self.subregions),
                )
