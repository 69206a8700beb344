"""The port's planner FSM: the 11 tests of tests/test_planner_fsm.py on its
scripted world (forced ESCAPE, its success and exhaustion, the too-far
deferral, the weight retune, manual targets, idling, the livelock and
scan-churn breakers, a nodeless graph, the decision log), and the JAX
package's PlannerFSM and the port's side by side on worlds that move the
agent: the same twists, states and targets on every tick.

Tolerance: none. Twists, states, target indices, paths and logs are
compared for equality."""

import json
import os

import numpy as np
import pytest

from activesplat_tpu.runtime.bus import Bus as JaxBus
from activesplat_tpu.runtime.planner_fsm import PlannerFSM as JaxPlannerFSM
from activesplat_tpu_torch.queries.topdown import topdown_config_from_bbox, topdown_to_world
from activesplat_tpu_torch.runtime.bus import Bus
from activesplat_tpu_torch.runtime.dataloader import SyntheticDataset, RGBDSensor, twist_to_action
from activesplat_tpu_torch.runtime.planner_fsm import (
    FORWARD,
    WEIGHTS_INIT,
    PlannerFSM,
    PlannerState,
)
from activesplat_tpu_torch.runtime.synthetic import BoxWorld
from activesplat_tpu_torch.utils import GlobalState
from activesplat_tpu_torch.utils.transforms import rot_axis
from tests.test_planner_fsm import GRID, ScriptedWorld, plus_corridor_map, pose_c2w

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def make_fsm(tmp_path, free_map=None, **kwargs):
    bus = Bus()
    world = ScriptedWorld(bus, plus_corridor_map() if free_map is None else free_map, tmp_path)
    bus.publish("camera_pose", pose_c2w(10, 50))
    fsm = PlannerFSM(bus, seed=1, **kwargs)
    return bus, world, fsm


def test_movement_failure_forces_escape(tmp_path):
    bus, world, fsm = make_fsm(tmp_path)
    fsm.state = PlannerState.NAVIGATE
    fsm.navigation_path = np.array([[80.0, 50.0]])
    bus.publish("movement_fail_times", 1)
    assert fsm.escape_requested
    assert len(fsm.fail_vertices) == 1
    np.testing.assert_allclose(fsm.fail_vertices[-1], [80.0, 50.0])
    fsm.tick()
    assert fsm.state == PlannerState.ESCAPE


def test_escape_success_replans(tmp_path):
    bus, world, fsm = make_fsm(tmp_path)
    fsm.state = PlannerState.NAVIGATE
    fsm.navigation_path = np.array([[80.0, 50.0]])
    bus.publish("movement_fail_times", 1)
    fsm.tick()
    assert fsm.state == PlannerState.ESCAPE
    world.block_forward = False
    fsm.rotation_observed_px = fsm.pose["px"][None].copy()
    fsm.tick()
    assert fsm.state == PlannerState.SELECT_TARGET
    assert world.forward_count >= 1
    assert fsm.movement_fail_times == 0


def test_escape_exhaustion_records_inaccessible(tmp_path):
    bus, world, fsm = make_fsm(tmp_path)
    fsm.state = PlannerState.NAVIGATE
    fsm.navigation_path = np.array([[80.0, 50.0]])
    bus.publish("movement_fail_times", 1)
    fsm.tick()
    assert fsm.state == PlannerState.ESCAPE
    world.block_forward = True
    fsm.tick()
    assert fsm.state == PlannerState.SELECT_TARGET
    assert len(fsm.inaccessible_db) == 1
    blocked = next(iter(fsm.inaccessible_db.values()))
    assert len(blocked) >= 1 and world.forward_count >= 1


def test_too_far_target_deferred_but_still_taken(tmp_path):
    bus, world, fsm = make_fsm(tmp_path, step_num_as_too_far=2)
    fsm.state = PlannerState.SELECT_TARGET
    fsm.tick()
    assert fsm.state == PlannerState.NAVIGATE, fsm.state
    assert fsm.navigation_path is not None
    limit_px = fsm.max_steps_to_target * fsm.step_px
    path = np.vstack([fsm.pose["px"], fsm.navigation_path])
    length = float(np.sum(np.linalg.norm(np.diff(path, axis=0), axis=1)))
    assert length > limit_px


def test_all_unarrived_failed_retunes_weights(tmp_path):
    bus, world, fsm = make_fsm(tmp_path)
    assert fsm.weights == WEIGHTS_INIT
    assert fsm._refresh_maps(arrived=True)
    fsm._refresh_graph(arrived=False)
    assert fsm.vg is not None and len(fsm.vg.nodes_index) >= 1
    fsm.fail_vertices = fsm.vg.vertices[np.asarray(fsm.vg.nodes_index)].copy()
    fsm.visited_px = np.array([[2.0, 2.0]])
    fsm._score_nodes()
    assert fsm.weights["OPACITY_INVISIBILITY"] == 10
    assert fsm.weights["HOLE_INVISIBILITY"] == 10
    assert fsm.weights["IN_HORIZON"] == -1
    assert len(fsm.fail_vertices) == 0
    assert np.all(fsm.nodes_score > -60)


def test_manual_planning_click_targets(tmp_path):
    clicks = [None, np.array([2.0, 2.0]), np.array([52.0, 48.0])]
    bus, world, fsm = make_fsm(tmp_path, manual_target_provider=lambda vg, px: clicks.pop(0))
    fsm.global_state = GlobalState.MANUAL_PLANNING
    fsm.state = PlannerState.SELECT_TARGET
    fsm.tick()
    assert fsm.state == PlannerState.SELECT_TARGET
    fsm.tick()
    assert fsm.state == PlannerState.SELECT_TARGET
    fsm.tick()
    assert fsm.state == PlannerState.NAVIGATE
    assert fsm.navigation_path is not None
    target = fsm.vg.vertices[fsm.navigation_target_index]
    assert np.linalg.norm(target - np.array([52.0, 48.0])) <= 20.0


def test_planner_idles_outside_enable_states(tmp_path):
    bus, world, fsm = make_fsm(tmp_path)
    fsm.state = PlannerState.NAVIGATE
    fsm.navigation_path = np.array([[80.0, 50.0]])
    for state in (GlobalState.PAUSE, GlobalState.MANUAL_CONTROL):
        fsm.global_state = state
        fsm.tick()
        assert fsm.state == PlannerState.NAVIGATE
        assert world.forward_count == 0


def test_navigate_bounce_livelock_breaker(tmp_path):
    bus, world, fsm = make_fsm(tmp_path)
    fsm._refresh_maps(arrived=True)
    fsm._refresh_graph(arrived=True)
    target = int(fsm.vg.nodes_index[0])
    unsafe_path = np.array([[50.0, 70.0], [50.0, 90.0]])  # cuts the + corner
    fails_before = len(fsm.fail_nodes_index)
    for _ in range(23):
        fsm.state = PlannerState.NAVIGATE
        fsm.navigation_path = unsafe_path.copy()
        fsm.navigation_target_index = target
        fsm._tick_navigate()
        assert fsm.state == PlannerState.SELECT_TARGET
        assert world.forward_count == 0
    assert fsm.fail_nodes_index.count(target) >= len(fsm.fail_nodes_index[:fails_before]) + 3
    fsm.state = PlannerState.NAVIGATE
    fsm.navigation_path = unsafe_path.copy()
    fsm._tick_navigate()
    assert fsm.state == PlannerState.ESCAPE
    fsm._move(FORWARD)
    assert fsm._no_move_bounces == 0


def test_nodeless_graph_scores_empty(tmp_path):
    free = np.zeros((GRID, GRID), bool)
    free[48:53, 10:90] = True  # thin corridor: its pruned graph has 0 nodes
    bus, world, fsm = make_fsm(tmp_path, free_map=free)
    fsm.horizon_bbox_px_translation = np.array([[0.0, 0.0], [99.0, 99.0]])
    fsm.state = PlannerState.SELECT_TARGET
    fsm.tick()
    assert len(fsm.nodes_score) == 0 or fsm.state in (PlannerState.BOOTSTRAP,
                                                      PlannerState.NAVIGATE)


def test_scan_churn_breaker_picks_farthest(tmp_path):
    bus, world, fsm = make_fsm(tmp_path)
    fsm._refresh_maps(arrived=True)
    fsm._refresh_graph(arrived=True)
    assert not fsm._scan_churn()
    for du in (0.0, 3.0, 6.0):
        fsm._refine_px_history.append(np.array([10.0 + du, 50.0]))
    assert fsm._scan_churn()
    fsm.bus.publish("camera_pose", pose_c2w(10, 50))
    fsm.state = PlannerState.SELECT_TARGET
    fsm.tick()
    assert fsm.state == PlannerState.NAVIGATE
    chosen_far = fsm.vg.vertices[fsm.navigation_target_index]
    _, _, fsm2 = make_fsm(tmp_path)
    fsm2._refresh_maps(arrived=True)
    fsm2._refresh_graph(arrived=True)
    fsm2.bus.publish("camera_pose", pose_c2w(10, 50))
    fsm2.state = PlannerState.SELECT_TARGET
    fsm2.tick()
    assert fsm2.state == PlannerState.NAVIGATE
    chosen_near = fsm2.vg.vertices[fsm2.navigation_target_index]
    px = fsm.pose["px"]
    assert np.linalg.norm(chosen_far - px) >= np.linalg.norm(chosen_near - px) - 1e-9
    fsm._refine_px_history.append(np.array([80.0, 50.0]))
    del fsm._refine_px_history[:-4]
    assert not fsm._scan_churn()


def test_decision_log_written(tmp_path):
    bus, world, fsm = make_fsm(tmp_path)
    fsm._refresh_maps(arrived=True)
    fsm._refresh_graph(arrived=True)
    fsm.state = PlannerState.SELECT_TARGET
    fsm.tick()
    fsm.save_results()
    events = [json.loads(line) for line in open(os.path.join(str(tmp_path), "planner_log.jsonl"))]
    kinds = {e["event"] for e in events}
    assert "scores" in kinds and ("target" in kinds or "no_target" in kinds)
    for name in ("topdown_free_map.png", "visited_map.png", "voronoi_graph.png"):
        assert os.path.exists(os.path.join(str(tmp_path), name))


class MovingWorld:
    """Bus services of a world the agent moves in: a SyntheticDataset's
    kinematics (turns, tilts, forward steps blocked by walls) on a BoxWorld,
    its occupancy on a top-down grid, the area within 2.5 m of any visited
    position observed, horizon boxes around the agent, node scores from a
    fixed field, and a local view target on every other query."""

    def __init__(self, bus, scene, results_dir):
        self.bus = bus
        world = (BoxWorld.two_room if scene == "two_room" else BoxWorld.single_room)(seed=1)
        sensor = RGBDSensor.from_fov(32, 32, 90.0, depth_min=0.0, depth_max=10.0)
        sx, _, sz = world.size
        self.ds = SyntheticDataset(world, sensor, step_num=10**6,
                                   start_position=np.array([sx / 2 + 0.3, 0.0, sz / 4]))
        self.cfg_ds = self.ds.dataset_config(str(results_dir))
        self.td = topdown_config_from_bbox(self.cfg_ds["scene_bbox"], 0.0, 1.5, pixel_max=90)
        w, h = self.td.grid_shape
        self.world_xz = np.array([[topdown_to_world((u + 0.5, v + 0.5), self.td, 0.0)[[0, 2]]
                                   for u in range(w)] for v in range(h)])
        self.free = np.array([[world.is_free(p, 0.1) for p in row] for row in self.world_xz])
        self.visited = [self.ds.position[[0, 2]].copy()]
        self.fail, self.local_calls = 0, 0
        bus.register_service("get_dataset_config", lambda: self.cfg_ds)
        bus.register_service("get_topdown_config", lambda: {
            "world_dim_index": self.td.world_dim_index, "world_2d_bbox": self.td.world_2d_bbox,
            "grid_map_shape": self.td.grid_shape, "meter_per_pixel": self.td.meter_per_pixel})
        bus.register_service("get_topdown", self.topdown)
        bus.register_service("get_opacity", self.opacity)
        bus.register_service("set_mapper", lambda kf_every=0, map_every=0: {
            "kf_every_old": 5, "map_every_old": 5})
        bus.subscribe("cmd_vel", self.on_cmd_vel)
        self.publish()

    def publish(self):
        self.bus.publish("camera_pose", self.ds.camera_c2w())
        self.bus.publish("movement_fail_times", self.fail)

    def topdown(self, arrived):
        seen = np.min(np.linalg.norm(self.world_xz[:, :, None] - np.array(self.visited)[None, None],
                                     axis=-1), axis=-1) < 2.5
        out = {"free_map": self.free & seen, "visible_map": ~seen}
        if arrived:
            c = self.ds.camera_c2w()[:3, 3]
            out["horizon_bound_min"], out["horizon_bound_max"] = c - 2.0, c + 2.0
        return out

    def opacity(self, arrived, positions=None, nodes=None):
        if arrived:
            p = np.asarray(positions, np.float64).reshape(-1, 3)
            inv = np.where(np.all(p == 0, axis=1), 0.0,
                           300.0 * np.abs(np.sin(1.3 * p[:, 0] + 0.7 * p[:, 2])))
            return {"targets_frustums_invisibility": list(inv),
                    "targets_frustums_volume": list(np.abs(np.cos(p[:, 0] - p[:, 2]))),
                    "nodes_id": list(nodes)}
        self.local_calls += 1
        target = rot_axis(self.ds.camera_c2w(), "y", 0.7) if self.local_calls % 2 else None
        return {"targets_frustums": [target], "targets_frustums_invisibility": [1.0],
                "targets_frustums_volume": [0.0]}

    def on_cmd_vel(self, twist):
        action = twist_to_action(twist)
        if action is None:
            return
        moved = self.ds.step(action)
        self.fail = 0 if moved else self.fail + 1
        self.visited.append(self.ds.position[[0, 2]].copy())
        self.publish()


@pytest.mark.parametrize("scene,ticks", [("single_room", 25), ("two_room", 40)])
def test_side_by_side_with_reference(scene, ticks, tmp_path):
    """Both FSMs on their own bus and an identical moving world, tick for
    tick: the twists each tick publishes, the state, the target and the
    path after it, and at the end the decision logs, must be equal."""
    runs = []
    for bus_cls, fsm_cls, sub in ((JaxBus, JaxPlannerFSM, "jax"), (Bus, PlannerFSM, "port")):
        np.random.seed(0)  # the Voronoi sampling jitter's global stream
        bus = bus_cls()
        MovingWorld(bus, scene, tmp_path / sub)
        fsm = fsm_cls(bus, seed=3)
        twists = []
        bus.subscribe("cmd_vel", lambda t, twists=twists: twists.append(
            (tuple(t["linear"]), tuple(t["angular"]))))
        trace = []
        for _ in range(ticks):
            n = len(twists)
            fsm.tick()
            path = fsm.navigation_path
            trace.append((fsm.state.value, fsm.navigation_target_index, twists[n:],
                          None if path is None else path.tolist()))
        runs.append((trace, fsm.decision_log))
    (jtrace, jlog), (ttrace, tlog) = runs
    for tick, (a, b) in enumerate(zip(jtrace, ttrace)):
        assert a == b, f"tick {tick}: reference {a[:2]}, port {b[:2]}"
    assert tlog == jlog
    states = {s for s, *_ in ttrace}
    assert {"NAVIGATE", "SELECT_TARGET"} <= states, states
