"""The port's hermetic exploration episode (runtime/launch.run_episode on the
CPU) against the JAX package's, and the port's panorama score cache.

The parity pair, one episode each: single_room seed 2, 48x48 sensor, 45
degree turns, 18 steps, a lean mapper (k_per_tile 1,024 from the start, the
k-capped training render, no exact online metrics: each escalation or switch
costs the JAX side a compile, and a buffer that may grow to 32,768
Gaussians, above the 10,256 the run makes, so that the count is the
mapper's and not the cap's), the JAX raycaster in numpy
(ACTIVESPLAT_NATIVE=0), so that both see the same frames. It is the smallest
run that plans a target, reaches it (0.798 px from it after 17 actions,
px_as_arrived 0.827) and begins the local refinement there; both stop after
that tick.

The mapping iterations' keyframe picks are random on both sides, from
jax.random and from a torch.Generator, which draw different streams. Both
episodes run here with the pick made deterministic, the current frame every
iteration (jax.random.randint and torch.rand patched for the run), so that
only float rounding separates the two maps.

Tolerances: the first frames bitwise; the actions, and the first target's
pixel position, equal up to and including the tick the agent reaches that
target; at the end the explored free-map area and the Gaussian count within
2% (both read equal on the CPU: 29.156 m^2 and 10,256 Gaussians on each
side; the room is for float rounding, which may flip a few free-map pixels
or a densified pixel).

The second parity input: two_room seed 0 under mp3d_large's planner block
(step_num_as_visited 15, local_view_limit 4), 40 steps, pixel_max 64. The
port builds its episode from a synthetic scene config that carries the
block (launch.build_episode_from_config -> run_episode), so the knobs reach
its PlannerFSM through the dataset's get_dataset_config payload; the JAX
package's launcher drops the block, so its side is wired by hand, its
PlannerFSM built with the same knobs passed explicitly. Both stop after the
tick that picks the first target, where step_num_as_visited sets which
nodes score as unarrived: Gibson's block (10) picks another node there.
The knobs, the actions, the first target's tick, node and pixel position
and the states equal.

It also mirrors the 4 tests of tests/test_exploration.py on the port's
episode at that file's configuration (48x48, 30 degree turns, 60 steps) and
the 4 of tests/test_pano_cache.py on the port's mapper node."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activesplat_tpu.mapper.config import MapperConfig as JaxMapperConfig
from activesplat_tpu.runtime import dataloader as jdl
from activesplat_tpu.runtime import launch as jlaunch
from activesplat_tpu.runtime.bus import Bus as JaxBus
from activesplat_tpu.runtime.mapper_node import MapperNode as JaxMapperNode
from activesplat_tpu.runtime.planner_fsm import PlannerFSM as JaxPlannerFSM
from activesplat_tpu.runtime.synthetic import BoxWorld as JaxBoxWorld
from activesplat_tpu_torch.configs import load_scene_config
from activesplat_tpu_torch.io.actions import read_actions
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.runtime import dataloader as tdl
from activesplat_tpu_torch.runtime.bus import Bus
from activesplat_tpu_torch.runtime.dataloader import (
    RGBDSensor,
    SimAction,
    SyntheticDataset,
    action_to_twist,
)
from activesplat_tpu_torch.runtime.launch import build_episode_from_config, run_episode
from activesplat_tpu_torch.runtime.mapper_node import MapperNode
from activesplat_tpu_torch.runtime.planner_fsm import PlannerFSM
from activesplat_tpu_torch.runtime.synthetic import BoxWorld

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

RES, STEPS, TURN = 48, 18, 45.0
START = np.array([3.0, 0.0, 3.0])
CFG = dict(initial_capacity=1 << 12, max_capacity=1 << 15, keyframe_capacity=64,
           mapping_iters=2, map_every=5, kf_every=5, mapping_window_size=5, chunk=128,
           kf_select_pixels=128, k_per_tile=1024, exact_training="off",
           exact_online_metrics=False)
EPISODE = dict(pixel_max=56, max_ticks=300, pano_scale=0.4)
# the parity pair stops after tick 3, where the agent reaches the first
# target and the FSM begins the local refinement (17 of the 18 steps)
PARITY_TICKS = 4
AREA_RTOL = 0.02
GAUSSIAN_RTOL = 0.02
# the second parity input: mp3d_large's planner block on two_room seed 0
MP3D_STEPS, MP3D_TICKS, MP3D_PIXEL_MAX = 40, 2, 64
MP3D_SCENE = {"dataset": {"format": "synthetic", "scene_id": "two_room", "seed": 0,
                          "step_num": MP3D_STEPS, "far": 10},
              "env": {"width": RES, "height": RES, "hfov": 90, "turn_angle": TURN,
                      "tilt_angle": 15},
              "planner": load_scene_config("mp3d_large")["planner"]}
# mp3d_large's knobs as the JAX package's PlannerFSM takes them
MP3D_JAX_KNOBS = dict(step_num_as_visited=15, step_num_as_arrived=1.5, local_view_limit=4,
                      radius_num_as_rotated=3.0, max_pitch_angle=45.0,
                      obstacle_approx_precision_m=0.225)


def dataset(mod, world_cls, results_dir):
    sensor = mod.RGBDSensor.from_fov(RES, RES, 90.0, depth_min=0.0, depth_max=10.0)
    return mod.SyntheticDataset(world_cls.single_room(seed=2), sensor, step_num=STEPS,
                                start_position=START, turn_angle_deg=TURN, tilt_angle_deg=15.0,
                                results_dir=results_dir, scene_id="test-room")


def current_frame_picks(mp):
    """Make each mapping iteration pick the current frame (the last valid
    entry of the window) on both sides."""
    mp.setattr(jax.random, "randint",
               lambda key, shape, minval, maxval, dtype=None: jnp.full(shape, maxval - 1, jnp.int32))
    rand = torch.rand
    mp.setattr(torch, "rand", lambda *a, **k: torch.full_like(rand(*a, **k), 1 - 2.0**-24))


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("ACTIVESPLAT_NATIVE", "0")
    current_frame_picks(mp)
    targets = []  # the port's planned targets, exact (the log rounds to 0.1 px)
    real_log = PlannerFSM._log

    def log(self, event, **fields):
        real_log(self, event, **fields)
        if event == "target":
            targets.append(self.vg.vertices[fields["node"]].copy())

    mp.setattr(PlannerFSM, "_log", log)
    jax.clear_caches()  # mapping_phase traced before the patch would keep its draw
    try:
        out = {"port_targets": targets}
        for side in ("jax", "port"):
            results_dir = str(tmp_path_factory.mktemp(f"parity_{side}"))
            np.random.seed(0)  # the Voronoi sampling jitter's global stream
            if side == "jax":
                ds = dataset(jdl, JaxBoxWorld, results_dir)
                node, planner = jlaunch.run_episode(ds, results_dir,
                                                    mapper_cfg=JaxMapperConfig(**CFG),
                                                    **{**EPISODE, "max_ticks": PARITY_TICKS})
            else:
                ds = dataset(tdl, BoxWorld, results_dir)
                node, planner = run_episode(ds, results_dir, mapper_cfg=MapperConfig(**CFG),
                                            device="cpu", **{**EPISODE, "max_ticks": PARITY_TICKS})
            out[side] = (results_dir, node, planner, ds)
        out["mp3d_large"] = mp3d_large_pair(tmp_path_factory)
    finally:
        mp.undo()
        jax.clear_caches()
    return out


def mp3d_large_pair(tmp_path_factory):
    """The second parity input, on each side: (results dir, planner)."""
    episode = dict(pixel_max=MP3D_PIXEL_MAX, pano_scale=EPISODE["pano_scale"])
    out = {}
    np.random.seed(0)
    jdir = str(tmp_path_factory.mktemp("mp3d_large_jax"))
    ds = jlaunch.make_synthetic_dataset("two_room", 0, MP3D_STEPS, RES, RES, turn_angle_deg=TURN,
                                        results_dir=jdir)
    bus = JaxBus()
    node = JaxMapperNode(bus, ds, JaxMapperConfig(**CFG), jdir, **episode)
    planner = JaxPlannerFSM(bus, **MP3D_JAX_KNOBS)
    planner.run(max_ticks=MP3D_TICKS)
    node.finish()
    ds.close()
    out["jax"] = (jdir, planner)

    np.random.seed(0)
    tdir = str(tmp_path_factory.mktemp("mp3d_large_port"))
    ep = build_episode_from_config(MP3D_SCENE, tdir)
    _, planner = run_episode(ep["dataset"], tdir, mapper_cfg=MapperConfig(**CFG),
                             max_ticks=MP3D_TICKS, device="cpu", **episode)
    out["port"] = (tdir, planner)
    return out


@pytest.fixture(scope="module")
def episode(tmp_path_factory):
    """The port's episode at tests/test_exploration.py's configuration."""
    results_dir = str(tmp_path_factory.mktemp("episode"))
    ds = SyntheticDataset(BoxWorld.single_room(seed=2),
                          RGBDSensor.from_fov(48, 48, 90.0, depth_min=0.0, depth_max=10.0),
                          step_num=60, start_position=START, turn_angle_deg=30.0,
                          tilt_angle_deg=15.0, results_dir=results_dir, scene_id="test-room")
    cfg = MapperConfig(initial_capacity=1 << 12, max_capacity=1 << 13, keyframe_capacity=64,
                       mapping_iters=2, map_every=5, kf_every=5, mapping_window_size=5,
                       chunk=128, kf_select_pixels=128)
    node, planner = run_episode(ds, results_dir, mapper_cfg=cfg, device="cpu", **EPISODE)
    return results_dir, node, planner, ds


def free_area_m2(planner):
    return int(np.count_nonzero(planner.free_map)) * planner.topdown_cfg.meter_per_pixel ** 2


def test_first_frames_equal(monkeypatch, tmp_path):
    monkeypatch.setenv("ACTIVESPLAT_NATIVE", "0")
    a = dataset(jdl, JaxBoxWorld, None).get_frame()
    b = dataset(tdl, BoxWorld, None).get_frame()
    for key in ("rgb", "depth", "c2w"):
        np.testing.assert_array_equal(b[key], a[key])


def test_actions_match_reference_to_first_target(parity):
    (jdir, _, jplan, _), (tdir, _, tplan, _) = parity["jax"], parity["port"]
    ja = read_actions(os.path.join(jdir, "actions.txt"))
    ta = read_actions(os.path.join(tdir, "actions.txt"))
    assert len(ta) == len(ja) == STEPS - 1
    jlog, tlog = jplan.decision_log, tplan.decision_log
    jt = next(e for e in jlog if e["event"] == "target")
    tt = next(e for e in tlog if e["event"] == "target")
    assert (tt["tick"], tt["node_px"]) == (jt["tick"], jt["node_px"])
    # the FSM ends the navigation at the target: LOCAL_REFINE there, not a stopover
    arrived = next(e["tick"] for e in jlog if e["event"] == "refine_begin"
                   and e["tick"] > jt["tick"] and not e["continue_global"])
    assert arrived == next(e["tick"] for e in tlog if e["event"] == "refine_begin"
                           and e["tick"] > tt["tick"] and not e["continue_global"])
    k = actions_through_tick(jlog, arrived, STEPS)
    assert ta[:k] == ja[:k], (ta, ja)
    # and the agent came within px_as_arrived of the target
    closest = np.min(np.linalg.norm(tplan.visited_px - parity["port_targets"][0], axis=1))
    assert closest < tplan.px_as_arrived, (closest, tplan.px_as_arrived)


def actions_through_tick(log, tick, steps):
    """The number of actions issued up to the end of `tick`: the visited
    count logged with the first state change after it, less the first
    frame's pose."""
    for e in log:
        if e["event"] == "state" and e["tick"] > tick:
            return min(e["visited"] - 1, steps)
    return steps


def test_episode_end_within_tolerance(parity):
    (_, jnode, jplan, jds), (_, tnode, tplan, tds) = parity["jax"], parity["port"]
    assert tds.get_step_info() == jds.get_step_info()
    ja, ta = free_area_m2(jplan), free_area_m2(tplan)
    assert abs(ta - ja) <= AREA_RTOL * ja, (ta, ja)
    jg, tg = jnode.mapper.num_gaussians(), tnode.mapper.num_gaussians()
    assert abs(tg - jg) <= GAUSSIAN_RTOL * jg, (tg, jg)


def test_mp3d_large_knobs_reach_both_planners(parity):
    (_, jplan), (_, tplan) = parity["mp3d_large"]["jax"], parity["mp3d_large"]["port"]
    assert tplan.px_as_visited == pytest.approx(15 * tplan.step_px)
    assert tplan.local_view_limit == 4
    for name in ("px_as_visited", "px_as_arrived", "local_view_limit", "radius_num_as_rotated",
                 "max_pitch_angle", "approx_precision_px"):
        assert getattr(tplan, name) == getattr(jplan, name), name


def test_mp3d_large_knobs_match_reference_to_first_target(parity):
    (jdir, jplan), (tdir, tplan) = parity["mp3d_large"]["jax"], parity["mp3d_large"]["port"]
    ja = read_actions(os.path.join(jdir, "actions.txt"))
    ta = read_actions(os.path.join(tdir, "actions.txt"))
    assert ta == ja and len(ta) >= 16
    jt = next(e for e in jplan.decision_log if e["event"] == "target")
    tt = next(e for e in tplan.decision_log if e["event"] == "target")
    assert (tt["tick"], tt["node"], tt["node_px"]) == (jt["tick"], jt["node"], jt["node_px"])
    states = [(e["tick"], e["frm"], e["to"]) for e in tplan.decision_log if e["event"] == "state"]
    assert states == [(e["tick"], e["frm"], e["to"]) for e in jplan.decision_log
                      if e["event"] == "state"]
    assert "NAVIGATE" in {to for _, _, to in states}


def test_episode_consumes_budget(episode):
    results_dir, node, planner, ds = episode
    steps, budget = ds.get_step_info()
    assert steps == budget, f"budget not consumed: {steps}/{budget}"
    assert node.mapper.num_gaussians() > 500


def test_episode_outputs(episode):
    results_dir, node, planner, ds = episode
    for rel in ("actions.txt", "gaussians_data/params.npz", "gaussians_data/transforms.json",
                "visited_map.png", "topdown_free_map.png", "voronoi_graph.png",
                "planner_log.jsonl"):
        assert os.path.exists(os.path.join(results_dir, rel)), rel
    actions = read_actions(os.path.join(results_dir, "actions.txt"))
    assert len(actions) == ds.step_num
    assert all(0 <= a <= 5 for a in actions)
    with open(os.path.join(results_dir, "planner_log.jsonl")) as fh:
        assert [json.loads(line) for line in fh] == planner.decision_log


def test_episode_explored(episode):
    results_dir, node, planner, ds = episode
    visited = planner.visited_px
    assert len(visited) > 10
    spread = np.ptp(visited, axis=0)
    assert spread.max() > 2.0, f"agent never translated: spread {spread}"


def test_planner_services(episode):
    results_dir, node, planner, ds = episode
    vg = planner._get_voronoi_graph()
    assert vg is not None and len(vg["vertices_px"]) > 0
    assert vg["nodes_position_3d"].shape == (len(vg["nodes_index"]), 3)


# ---- the panorama score cache (tests/test_pano_cache.py on the port) ---- #

NODES = np.array([[2.5, 0.0, 2.5], [3.5, 0.0, 3.0], [0.0, 0.0, 0.0]])


def make_node(tmp_path, pano_cache="version", **kw):
    world = BoxWorld.single_room(seed=3)
    sensor = RGBDSensor.from_fov(48, 48, 90.0, depth_min=0.0, depth_max=10.0)
    ds = SyntheticDataset(world, sensor, step_num=40, start_position=np.array([3.0, 0.0, 3.0]),
                          results_dir=str(tmp_path), scene_id="pano-cache")
    cfg = MapperConfig(initial_capacity=1 << 12, max_capacity=1 << 13, keyframe_capacity=16,
                       mapping_iters=2, map_every=2, kf_every=2, mapping_window_size=4,
                       chunk=128, kf_select_pixels=128)
    return MapperNode(Bus(), ds, cfg, str(tmp_path), pixel_max=56, pano_scale=0.4,
                      save_dataset=False, pano_cache=pano_cache, device="cpu", **kw)


def count_rendered(node, monkeypatch):
    calls = []
    orig = node.mapper.get_global_invisibility

    def wrapped(view_c2w, positions):
        calls.append(len(positions))
        return orig(view_c2w, positions)

    monkeypatch.setattr(node.mapper, "get_global_invisibility", wrapped)
    return calls


def test_cached_equals_fresh_when_unchanged(tmp_path, monkeypatch):
    node = make_node(tmp_path)
    calls = count_rendered(node, monkeypatch)
    r1 = node._get_opacity(True, NODES, nodes_id=[0, 1, 2])
    assert calls == [2]  # zero node skipped, 2 rendered
    r2 = node._get_opacity(True, NODES, nodes_id=[0, 1, 2])
    assert calls == [2]  # all hits: nothing re-rendered
    np.testing.assert_array_equal(r1["targets_frustums_invisibility"],
                                  r2["targets_frustums_invisibility"])
    np.testing.assert_array_equal(r1["targets_frustums_volume"], r2["targets_frustums_volume"])
    assert node.pano_cache_hits == 2 and node.pano_cache_misses == 2


def test_cache_off_rerenders(tmp_path, monkeypatch):
    node = make_node(tmp_path, pano_cache="off")
    calls = count_rendered(node, monkeypatch)
    node._get_opacity(True, NODES)
    node._get_opacity(True, NODES)
    assert calls == [2, 2]


def test_version_mode_invalidates_on_map_change(tmp_path, monkeypatch):
    node = make_node(tmp_path)
    calls = count_rendered(node, monkeypatch)
    node._get_opacity(True, NODES)
    ver0 = node.mapper.map_version
    node._on_cmd_vel(action_to_twist(SimAction.MOVE_FORWARD))
    assert node.mapper.map_version > ver0
    node._get_opacity(True, NODES)
    assert calls == [2, 2]  # map changed -> full re-render
    assert node.pano_cache_stale == 2  # keys existed, version rejected them


def test_cache_capacity_evicts_oldest_version(tmp_path):
    node = make_node(tmp_path, pano_cache_capacity=3)
    h = node.last_frame["c2w"][1, 3]
    for i in range(5):
        key = tuple(np.round(np.array([float(i), h, 0.0]) / 0.05).astype(int))
        node._pano_cache[key] = {"version": i, "inv": 1.0, "vol": 0.0}
    node._get_opacity(True, np.array([[2.5, 0.0, 2.5]]))
    assert len(node._pano_cache) <= 3
    assert min(e["version"] for e in node._pano_cache.values()) >= 2
