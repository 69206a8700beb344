"""The full hermetic episode through the port's Habitat adapter: scene config
JSON -> env yaml -> HabitatDataset(sim_factory=the BoxWorld mock) ->
MapperNode + PlannerFSM -> the reference's result layout -> the coverage
judge (tests/test_habitat_episode.py's 6 tests on the port, on the CPU), and
the port against the JAX package through both adapters.

The parity pair: the same scene config (the gibson config pointed at a 48x48
env yaml with 45 degree turns, scene id Elmira, whose mock room is the
two-room world, 18 steps: the bootstrap spin, one target and its first
forward step), the lean mapper of tests/test_torch_episode.py, the numpy
raycaster on both sides (ACTIVESPLAT_NATIVE=0) and the mapping picks made
deterministic on both sides. Tolerances: every action equal; the Gaussian
count and the explored free area within tests/test_torch_episode.py's 2%
(10,682 and 10,683 Gaussians on this CPU: float rounding may flip a
densified pixel). The coverage judge over the port's actions.txt through
both packages' adapters (fresh Eval datasets on their mocks): every number
of as_row within 1e-12 relative."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from activesplat_tpu.eval import replay as jreplay
from activesplat_tpu.mapper.config import MapperConfig as JaxMapperConfig
from activesplat_tpu.runtime import habitat_backend as jhb
from activesplat_tpu.runtime import launch as jlaunch
from activesplat_tpu.runtime import mock_habitat as jmock
from activesplat_tpu_torch.configs import load_scene_config, mapper_config_from_scene
from activesplat_tpu_torch.eval import replay as treplay
from activesplat_tpu_torch.io.actions import read_actions
from activesplat_tpu_torch.io.png import read_png
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.runtime import launch
from activesplat_tpu_torch.runtime.habitat_backend import HabitatDataset, get_dataset
from activesplat_tpu_torch.runtime.launch import build_episode_from_config, run_episode
from activesplat_tpu_torch.runtime.mock_habitat import BoxWorldSim, make_mock_sim
from tests.test_torch_episode import AREA_RTOL, CFG, GAUSSIAN_RTOL, current_frame_picks
from tests.test_torch_habitat import write_env_yaml

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

PARITY_STEPS, PARITY_TURN, PARITY_SCENE = 18, 45.0, "Elmira"
COVERAGE_RTOL = 1e-12


MOCK_STEPS = 45  # tests/test_habitat_episode.py runs 60; 45 already translate the agent


def scene_config(env_yaml, step_num=MOCK_STEPS, scene_id="MockDenmark"):
    """gibson.json-shaped scene config pointing at the test env yaml."""
    cfg = json.loads(json.dumps(load_scene_config("gibson")))  # deep copy
    cfg["env"]["config"] = env_yaml
    cfg["dataset"]["step_num"] = step_num
    cfg["dataset"]["scene_id"] = scene_id
    cfg["dataset"]["far"] = 10
    cfg["painter"]["grid_map"]["pixel_max"] = 56
    return cfg


@pytest.fixture(scope="module")
def mock_episode(tmp_path_factory):
    results_dir = str(tmp_path_factory.mktemp("habitat_episode"))
    env_yaml = write_env_yaml(os.path.join(results_dir, "env.yaml"), turn=30.0)
    cfg = scene_config(env_yaml)
    episode = build_episode_from_config(cfg, results_dir, sim_factory=make_mock_sim)
    # compute shrunk to test scale; the schedule stays config-driven
    mapper_cfg = dataclasses.replace(
        episode["mapper_cfg"], initial_capacity=1 << 12, max_capacity=1 << 13,
        keyframe_capacity=64, chunk=128, kf_select_pixels=128,
    )
    mapper_node, planner = run_episode(
        episode["dataset"], results_dir, mapper_cfg=mapper_cfg, pixel_max=episode["pixel_max"],
        max_ticks=300, pano_scale=0.4, single_floor_expansion=episode["single_floor_expansion"],
        agent_foot_adjust=episode["agent_foot_adjust"], device="cpu",
    )
    return results_dir, mapper_node, planner, episode["dataset"], cfg


def test_config_drives_the_episode(mock_episode):
    results_dir, mapper_node, planner, dataset, cfg = mock_episode
    assert isinstance(dataset, HabitatDataset)
    assert isinstance(dataset._sim, BoxWorldSim)
    assert dataset.get_scene_id() == "MockDenmark"
    assert dataset.step_num == MOCK_STEPS
    assert dataset.sensor.width == 48
    assert mapper_node.mapper.cfg.map_every == cfg["mapper"]["map_every"]
    assert max(mapper_node.topdown_cfg.grid_shape) <= 56 + 1


def test_mock_episode_budget_and_outputs(mock_episode):
    results_dir, mapper_node, planner, dataset, cfg = mock_episode
    steps, budget = dataset.get_step_info()
    assert steps == budget == MOCK_STEPS, f"budget not consumed: {steps}/{budget}"
    assert mapper_node.mapper.num_gaussians() > 500
    for rel in ("actions.txt", os.path.join("gaussians_data", "params.npz"),
                os.path.join("gaussians_data", "transforms.json"), "visited_map.png",
                "topdown_free_map.png", "config.json"):
        assert os.path.exists(os.path.join(results_dir, rel)), rel
    assert not os.path.exists(os.path.join(results_dir, "gt_mesh.json"))  # no mesh file
    actions = read_actions(os.path.join(results_dir, "actions.txt"))
    assert len(actions) == MOCK_STEPS and all(0 <= a <= 5 for a in actions)


def test_mock_episode_explored(mock_episode):
    results_dir, mapper_node, planner, dataset, cfg = mock_episode
    visited = planner.visited_px
    assert len(visited) > 10
    assert np.ptp(visited, axis=0).max() > 2.0, "agent never translated"


def test_coverage_judge_replays_through_adapter(mock_episode):
    """eval_actions over a fresh 'Eval'-mode HabitatDataset on the mock, the
    GT surface sampled from the mock's world."""
    results_dir, mapper_node, planner, dataset, cfg = mock_episode
    eval_ds = get_dataset(cfg, {"datasets": {"gibson": {"root": "/nonexistent"}}},
                          scene_id="Eval", sim_factory=make_mock_sim)
    assert eval_ds.results_dir is None
    report = treplay.eval_actions(eval_ds, os.path.join(results_dir, "actions.txt"),
                                  num_gt_samples=20_000, frame_stride=2)
    assert report.completeness_ratio > 0.05
    assert np.isfinite(report.accuracy)
    assert report.path_length >= 0


def test_batch_default_habitat_factory(tmp_path):
    from activesplat_tpu_torch.eval.batch import habitat_dataset_factory, habitat_scene_specs

    factory = habitat_dataset_factory(sim_factory=make_mock_sim)
    spec = habitat_scene_specs("gibson_small")[0]
    ds = factory(spec, str(tmp_path / "run0"))
    assert isinstance(ds, HabitatDataset)
    assert ds.get_scene_id() == spec["scene_id"] == "Denmark"
    assert ds.step_num == 1000
    assert ds.results_dir == str(tmp_path / "run0")
    assert os.path.exists(tmp_path / "run0" / "config.json")
    eval_ds = factory(spec, None)
    assert eval_ds.results_dir is None
    assert eval_ds.get_scene_id() == "Denmark"


def test_cli_consumes_config(monkeypatch, tmp_path, capsys):
    """main(): --config synthetic_small shapes the dataset and the
    MapperConfig, explicit flags beat the config; a Habitat config with
    --habitat_sim mock runs the adapter with the recorder and the live view
    on (a 48x48 env yaml with 45 degree turns, 18 steps: the spin, then the
    top-down queries of a target; the config's mapper at a smaller
    capacity); --mesh 1 runs, unsharded on the CPU's one device."""
    captured = {}

    def fake_run_episode(dataset, results_dir, mapper_cfg=None, pixel_max=360, **kw):
        captured.update(dataset=dataset, mapper_cfg=mapper_cfg, pixel_max=pixel_max, **kw)

        class _M:
            class mapper:
                @staticmethod
                def num_gaussians():
                    return 0

        return _M(), type("P", (), {"free_map": None})()

    with monkeypatch.context() as m:
        m.setattr(launch, "run_episode", fake_run_episode)
        launch.main(["--config", "synthetic_small", "--results_dir", str(tmp_path / "s"),
                     "--step_num", "7", "--device", "cpu"])
    ds = captured["dataset"]
    assert ds.get_scene_id().startswith("single_room")
    assert ds.step_num == 7
    assert ds.sensor.width == 256
    assert captured["pixel_max"] == 360
    assert isinstance(captured["mapper_cfg"], MapperConfig)
    assert captured["mapper_cfg"].sil_thres == 0.98
    assert captured["save_runtime_data"] is False and captured["live_view_port"] is None
    assert mapper_config_from_scene(load_scene_config("gibson_high_resolution")).mapping_iters == 10

    out = tmp_path / "hab"
    env_yaml = write_env_yaml(tmp_path / "env.yaml", turn=45.0)
    cfg_path = tmp_path / "scene.json"
    cfg_path.write_text(json.dumps(scene_config(env_yaml, step_num=1000)))
    real = launch.run_episode

    def small_run(dataset, results_dir, mapper_cfg=None, **kw):
        mapper_cfg = dataclasses.replace(mapper_cfg, initial_capacity=1 << 12,
                                         max_capacity=1 << 12, keyframe_capacity=16,
                                         kf_select_pixels=128)
        return real(dataset, results_dir, mapper_cfg=mapper_cfg, pano_scale=0.4, **kw)

    monkeypatch.setattr(launch, "run_episode", small_run)
    launch.main(["--config", str(cfg_path), "--habitat_sim", "mock", "--step_num", "18",
                 "--save_runtime_data", "1", "--live_view_port", "0", "--device", "cpu",
                 "--results_dir", str(out)])
    text = capsys.readouterr().out
    assert "episode finished: 18 steps" in text and "live view: http://127.0.0.1:" in text
    assert len(read_actions(str(out / "actions.txt"))) == 18
    assert os.path.exists(out / "gaussians_data" / "params.npz")
    # the recorder's folders (the views are written every 100 steps and the
    # panoramas at arrivals, so none yet)
    assert os.listdir(out / "topdown_map")
    assert os.path.isdir(out / "opacity") and os.path.isdir(out / "current_vis_data")
    assert read_png(str(out / "topdown_map" / "free_00000.png")).shape[0] > 0
    # --mesh 1 on the CPU: one device, so the mapper says it renders unsharded
    launch.main(["--config", str(cfg_path), "--habitat_sim", "mock", "--step_num", "4",
                 "--mesh", "1", "--device", "cpu", "--results_dir", str(tmp_path / "m")])
    text = capsys.readouterr().out
    assert "episode finished: 4 steps" in text
    assert "mapper: use_mesh is set but fewer than two cpu devices" in text
    assert "rendering unsharded" in text


# ---------------------------------------------------------------------- #
# the port against the JAX package, through both adapters

@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    root = tmp_path_factory.mktemp("habitat_parity")
    cfg = scene_config(write_env_yaml(root / "env.yaml", turn=PARITY_TURN),
                       step_num=PARITY_STEPS, scene_id=PARITY_SCENE)
    mp = pytest.MonkeyPatch()
    mp.setenv("ACTIVESPLAT_NATIVE", "0")
    current_frame_picks(mp)
    jax.clear_caches()  # mapping_phase traced before the patch would keep its draw
    out = {"cfg": cfg}
    try:
        for side, mod, mock, mcfg, kw in (
                ("jax", jlaunch, jmock, JaxMapperConfig, {}),
                ("port", launch, None, MapperConfig, {"device": "cpu"})):
            results_dir = str(root / side)
            np.random.seed(0)  # the Voronoi sampling jitter's global stream
            episode = mod.build_episode_from_config(
                cfg, results_dir, sim_factory=make_mock_sim if mock is None else mock.make_mock_sim)
            node, planner = mod.run_episode(
                episode["dataset"], results_dir, mapper_cfg=mcfg(**CFG),
                pixel_max=episode["pixel_max"], max_ticks=300, pano_scale=0.4,
                single_floor_expansion=episode["single_floor_expansion"],
                agent_foot_adjust=episode["agent_foot_adjust"], **kw)
            out[side] = (results_dir, node, planner, episode["dataset"])
    finally:
        mp.undo()
        jax.clear_caches()
    return out


def test_episode_through_both_adapters(parity):
    (jdir, jnode, jplan, jds), (tdir, tnode, tplan, tds) = parity["jax"], parity["port"]
    assert isinstance(jds, jhb.HabitatDataset) and isinstance(tds, HabitatDataset)
    ja = read_actions(os.path.join(jdir, "actions.txt"))
    ta = read_actions(os.path.join(tdir, "actions.txt"))
    assert len(ta) == PARITY_STEPS and ta == ja
    assert 1 in ta  # the agent moved
    assert [e["event"] for e in tplan.decision_log] == [e["event"] for e in jplan.decision_log]
    jg, tg = jnode.mapper.num_gaussians(), tnode.mapper.num_gaussians()
    assert abs(tg - jg) <= GAUSSIAN_RTOL * jg, (tg, jg)
    jarea, tarea = (int(np.count_nonzero(p.free_map)) * p.topdown_cfg.meter_per_pixel ** 2
                    for p in (jplan, tplan))
    assert abs(tarea - jarea) <= AREA_RTOL * jarea, (tarea, jarea)


def test_coverage_judge_equal_through_both_adapters(parity, monkeypatch):
    monkeypatch.setenv("ACTIVESPLAT_NATIVE", "0")
    cfg, path = parity["cfg"], os.path.join(parity["port"][0], "actions.txt")
    user = {"datasets": {"gibson": {"root": "/nonexistent"}}}
    kw = dict(num_gt_samples=20_000, frame_stride=2)
    got = treplay.eval_actions(get_dataset(cfg, user, scene_id="Eval",
                                           sim_factory=make_mock_sim), path, **kw)
    want = jreplay.eval_actions(jhb.get_dataset(cfg, user, scene_id="Eval",
                                                sim_factory=jmock.make_mock_sim), path, **kw)
    assert got.num_observed_points == want.num_observed_points > 0
    for key in ("completeness", "completeness_ratio", "accuracy", "path_length"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key), rtol=COVERAGE_RTOL,
                                   err_msg=key)
    assert got.as_row() == want.as_row()
