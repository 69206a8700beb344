"""The port's Habitat adapter (runtime/habitat_backend.py) and its BoxWorld
mock (runtime/mock_habitat.py): tests/test_habitat_backend.py's 10 tests on
the port, and the port against the JAX package.

Parity: the JAX HabitatDataset on the JAX mock and the port's on the port's
mock, from the same env YAML, over 40 actions with tilts, turns and blocked
forwards: every frame's rgb, depth and c2w bitwise equal (the numpy
raycaster on both sides, ACTIVESPLAT_NATIVE=0), step()'s returns,
actions.txt and dataset_config equal. The downsample path against the JAX
adapter's cv2.resize: rgb (INTER_AREA) within 1e-6, since OpenCV averages
float32 in float32 and the port in float64; depth (INTER_NEAREST) bitwise.
The mock's scene pick equal for a set of scene ids."""

import json
import os
import types

import numpy as np
import pytest
import yaml

from activesplat_tpu.runtime import habitat_backend as jhb
from activesplat_tpu.runtime import mock_habitat as jmock
from activesplat_tpu_torch.configs import (
    CONFIG_DIR,
    load_scene_config,
    load_scene_list,
    load_user_config,
    mapper_config_from_scene,
)
from activesplat_tpu_torch.runtime import mock_habitat as tmock
from activesplat_tpu_torch.runtime.dataloader import SimAction
from activesplat_tpu_torch.runtime.habitat_backend import (
    DatasetFormat,
    HabitatDataset,
    HabitatEnvSpec,
    get_dataset,
    resize_nearest,
    scene_mesh_urls,
)

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

ENV_YAML = os.path.join(CONFIG_DIR, "env", "activesplat_pointnav.yaml")
RGB_ATOL = 1e-6


def env_dict(width=48, height=48, turn=30.0, forward=0.065):
    """A small-resolution variant of activesplat_pointnav.yaml
    (tests/test_habitat_episode.py's)."""
    def sensor(**extra):  # a list of its own each (a shared one would dump as an anchor)
        return {"width": width, "height": height, "hfov": 90, "position": [0, 1.25, 0],
                **extra}

    return {"habitat": {"simulator": {
        "turn_angle": turn, "tilt_angle": 15, "forward_step_size": forward,
        "agents": {"main_agent": {"height": 1.5, "radius": 0.1, "sim_sensors": {
            "rgb_sensor": sensor(),
            "depth_sensor": sensor(min_depth=0.0, max_depth=10.0),
        }}},
        "habitat_sim_v0": {"allow_sliding": False},
    }}}


def write_env_yaml(path, **kw):
    with open(path, "w") as fh:
        yaml.safe_dump(env_dict(**kw), fh)
    return str(path)


class _Quat:
    def __init__(self, w, x, y, z):
        self.w, self.x, self.y, self.z = w, x, y, z


class FakeSim:
    """tests/test_habitat_backend.py's habitat-sim stand-in: y-up world, yaw
    about +y, blocked beyond x > 0.3 (no sliding)."""

    class _Pathfinder:
        def get_bounds(self):
            return (np.array([-1.0, 0.0, -2.0]), np.array([9.0, 3.0, 6.0]))

    def __init__(self, spec):
        self.spec = spec
        self.actions = []
        self.closed = False
        self._seed = None
        self.pathfinder = self._Pathfinder()
        self.reset()

    def seed(self, value):
        self._seed = value

    def reset(self):
        self.position = np.zeros(3)
        self.yaw = 0.0

    def close(self):
        self.closed = True

    def step(self, action):
        self.actions.append(action)
        if action == int(SimAction.TURN_LEFT):
            self.yaw += np.deg2rad(self.spec.turn_angle)
        elif action == int(SimAction.TURN_RIGHT):
            self.yaw -= np.deg2rad(self.spec.turn_angle)
        elif action == int(SimAction.MOVE_FORWARD):
            fwd = np.array([np.sin(self.yaw), 0.0, -np.cos(self.yaw)])
            target = self.position + fwd * self.spec.forward_step_size
            if target[0] <= 0.3:
                self.position = target

    def get_sensor_observations(self):
        h, w = self.spec.height, self.spec.width
        rgb = np.full((h, w, 4), 128, np.uint8)
        depth = np.full((h, w, 1), 3.0, np.float32)
        depth[0, 0] = -0.5
        depth[0, 1] = 99.0
        return {"rgb": rgb[..., :3], "depth": depth}

    def get_agent_state(self):
        half = self.yaw / 2.0
        q = _Quat(np.cos(half), 0.0, np.sin(half), 0.0)
        sensor_pos = self.position + np.asarray(self.spec.position)
        return types.SimpleNamespace(
            position=self.position.copy(),
            rotation=q,
            sensor_states={
                "rgb": types.SimpleNamespace(position=sensor_pos, rotation=q),
                "depth": types.SimpleNamespace(position=sensor_pos, rotation=q),
            },
        )


@pytest.fixture
def dataset(tmp_path):
    ds = HabitatDataset(
        env_config_path=ENV_YAML,
        scene_id="Denmark",
        dataset_format="gibson",
        dataset_root="/data/gibson",
        step_num=20,
        results_dir=str(tmp_path),
        sim_factory=lambda cfg: FakeSim(cfg["spec"]),
    )
    ds.setup()
    return ds


def test_env_spec_parsing():
    spec = HabitatEnvSpec.from_yaml(ENV_YAML)
    assert (spec.width, spec.height) == (256, 256)
    assert spec.hfov_deg == 90.0
    assert spec.position == (0.0, 1.25, 0.0)
    assert (spec.depth_min, spec.depth_max) == (0.0, 10.0)
    assert (spec.turn_angle, spec.tilt_angle) == (10.0, 15.0)
    assert spec.forward_step_size == 0.065
    assert not spec.allow_sliding
    assert vars(spec) == vars(jhb.HabitatEnvSpec.from_yaml(ENV_YAML))
    hr = HabitatEnvSpec.from_yaml(os.path.join(CONFIG_DIR, "env",
                                               "activesplat_high_resolution_pointnav.yaml"))
    assert vars(hr) == vars(jhb.HabitatEnvSpec.from_yaml(os.path.join(
        CONFIG_DIR, "env", "activesplat_high_resolution_pointnav.yaml")))
    assert (hr.width, hr.height) == (512, 512)


def test_intrinsics_quirk():
    """Habitat principal point: cx = W/2 - 1, cy = H/2 - 1, fy = fx
    (src/dataloader/__init__.py:275-284)."""
    spec = HabitatEnvSpec.from_yaml(ENV_YAML)
    s = spec.sensor(depth_scale=1.0)
    assert s.cx == 256 / 2 - 1 and s.cy == 256 / 2 - 1
    np.testing.assert_allclose(s.fx, 0.5 * 256 / np.tan(np.deg2rad(45.0)))
    assert s.fx == s.fy
    s2 = spec.sensor(depth_scale=1.0, downsample=2.0)
    assert (s2.width, s2.height) == (128, 128)
    np.testing.assert_allclose(s2.fx, s.fx / 2)
    np.testing.assert_allclose(s2.cx, s.cx / 2)
    with pytest.raises(ValueError):
        spec.sensor(depth_scale=1.0, downsample=0.5)


def test_get_frame_contract(dataset):
    frame = dataset.get_frame()
    assert frame["frame_id"] == 0
    assert frame["rgb"].shape == (256, 256, 3)
    assert frame["rgb"].dtype == np.float32
    np.testing.assert_allclose(frame["rgb"][5, 5], 128 / 255.0)
    assert frame["depth"].shape == (256, 256)
    assert frame["depth"][0, 0] == 0.0 and frame["depth"][0, 1] == 0.0
    np.testing.assert_allclose(frame["depth"][5, 5], 3.0)
    np.testing.assert_allclose(frame["c2w"][:3, 3], [0.0, 1.25, 0.0])
    np.testing.assert_allclose(frame["c2w"][:3, :3], np.eye(3), atol=1e-6)
    assert dataset.get_frame()["frame_id"] == 1


def test_apply_movement_contract(dataset, tmp_path):
    assert dataset.apply_movement({"linear": np.zeros(3), "angular": np.array([0, 0, 0.2])})
    assert dataset.apply_movement({"linear": np.array([0.2, 0, 0]), "angular": np.zeros(3)})
    assert not dataset.apply_movement({"linear": np.zeros(3), "angular": np.zeros(3)})
    sim = dataset._sim
    assert sim.actions == [int(SimAction.TURN_LEFT), int(SimAction.MOVE_FORWARD)]
    with open(os.path.join(str(tmp_path), "actions.txt")) as fh:
        assert [int(x) for x in fh.read().split()] == sim.actions
    assert dataset.get_step_info() == (2, 20)
    frame = dataset.get_frame()
    assert abs(frame["c2w"][0, 2]) > 0.1
    for _ in range(8):  # turn to face +x
        dataset.apply_movement({"linear": np.zeros(3), "angular": np.array([0, 0, 0.2])})
    moved = True
    for _ in range(8):
        moved = dataset.apply_movement({"linear": np.array([0.2, 0, 0]), "angular": np.zeros(3)})
        if not moved:
            break
    assert not moved  # eventually blocked at the wall
    while not dataset.is_finished():
        dataset.apply_movement({"linear": np.zeros(3), "angular": np.array([0, 0, 0.2])})
    steps, budget = dataset.get_step_info()
    assert steps == budget == 20
    assert not dataset.step(SimAction.TURN_LEFT)


def test_dataset_config_payload(dataset):
    cfg = dataset.dataset_config("/results")
    assert cfg["pose_data_type"] == "C2W_OPENCV"
    assert cfg["agent_turn_angle"] == 10.0
    assert cfg["agent_forward_step_size"] == 0.065
    assert cfg["width"] == cfg["height"] == 256
    np.testing.assert_allclose(cfg["rgbd_position"], [0, 1.25, 0])
    assert cfg["scene_mesh_url"].endswith("Denmark.glb")


def test_scene_mesh_layouts():
    for fmt, root, sid in ((DatasetFormat.GIBSON, "/g", "Denmark"),
                           (DatasetFormat.MP3D, "/m", "gZ6f7yhEvPG"),
                           (DatasetFormat.REPLICA, "/r", "room0")):
        assert scene_mesh_urls(fmt, root, sid) == jhb.scene_mesh_urls(
            jhb.DatasetFormat(fmt.value), root, sid)
    hab, mesh = scene_mesh_urls(DatasetFormat.GIBSON, "/g", "Denmark")
    assert hab == mesh == "/g/Denmark.glb"
    hab, mesh = scene_mesh_urls(DatasetFormat.MP3D, "/m", "gZ6f7yhEvPG")
    assert hab == "/m/v1/tasks/gZ6f7yhEvPG/gZ6f7yhEvPG.glb"
    assert mesh.endswith("gZ6f7yhEvPG_semantic.ply")


def test_get_dataset_factory(tmp_path):
    cfg = load_scene_config("gibson")
    ds = get_dataset(cfg, load_user_config(), scene_id="Elmira", results_root=str(tmp_path),
                     sim_factory=lambda c: FakeSim(c["spec"]))
    ds.setup()
    assert ds.get_scene_id() == "Elmira"
    assert ds.step_num == 1000
    assert ds.env_config_path == os.path.join(CONFIG_DIR, "env", "activesplat_pointnav.yaml")
    runs = os.listdir(os.path.join(str(tmp_path), "results"))
    assert len(runs) == 1 and "gibson_Elmira" in runs[0]
    with open(os.path.join(str(tmp_path), "results", runs[0], "config.json")) as fh:
        assert json.load(fh)["dataset"]["format"] == "gibson"


def test_benchmark_config_surface():
    for name in ("gibson", "mp3d", "gibson_large", "mp3d_large", "gibson_high_resolution"):
        mc = mapper_config_from_scene(load_scene_config(name))
        assert mc.map_every == 5 and mc.mapping_window_size == 12
        assert mc.mapping_iters == (10 if name == "gibson_high_resolution" else 2)
    assert load_scene_config("gibson_large")["dataset"]["step_num"] == 2000
    assert load_scene_config("mp3d")["dataset"]["format"] == "mp3d"
    scenes = sum((load_scene_list(n) for n in
                  ("gibson_small", "gibson_big", "mp3d_small", "mp3d_big")), [])
    assert len(scenes) == 13 and "Denmark" in scenes and "GdvgFV5R1Z5" in scenes


def test_habitat_batch_specs(tmp_path):
    from activesplat_tpu.eval.batch import habitat_scene_specs as jspecs
    from activesplat_tpu_torch.eval.batch import habitat_scene_specs, run_batch

    specs = habitat_scene_specs("gibson_big")
    assert [s["scene_id"] for s in specs] == ["Cantwell", "Eastville", "Swormville"]
    assert all(s["step_num"] == 2000 for s in specs)
    for name in ("gibson_small", "gibson_big", "mp3d_small", "mp3d_big"):
        assert habitat_scene_specs(name) == jspecs(name)
    # the default habitat factory is wired in: without the wheels the run
    # fails at simulator setup, naming the hermetic mock
    with pytest.raises(ImportError, match="--habitat_sim mock"):
        run_batch("mp3d_small", str(tmp_path), device="cpu")


def test_bbox_derived_from_navmesh(dataset):
    assert np.isfinite(dataset.scene_bbox).all()
    np.testing.assert_allclose(dataset.scene_bbox[:, 0], [-1.0, 0.0, -2.0])
    np.testing.assert_allclose(dataset.scene_bbox[:, 1], [9.0, 3.0, 6.0])
    cfg = dataset.dataset_config("/tmp/x")
    assert np.isfinite(np.asarray(cfg["scene_bbox"], np.float64)).all()


# ---------------------------------------------------------------------- #
# the port against the JAX package

PARITY_ACTIONS = (
    [SimAction.LOOK_DOWN, SimAction.LOOK_DOWN, SimAction.LOOK_DOWN, SimAction.LOOK_UP,
     SimAction.TURN_LEFT, SimAction.TURN_RIGHT, SimAction.TURN_RIGHT]
    + [SimAction.MOVE_FORWARD] * 12  # the wall stops the last of them
    + [SimAction.TURN_LEFT] * 3 + [SimAction.MOVE_FORWARD] * 6 + [SimAction.LOOK_UP] * 3
    + [SimAction.TURN_RIGHT] * 2 + [SimAction.MOVE_FORWARD] * 6 + [SimAction.STOP]
)


def both_datasets(tmp_path, env_yaml, scene_id="MockDenmark", downsample=1.0, step_num=60):
    out = {}
    for side, hb, mock in (("jax", jhb, jmock), ("port", None, tmock)):
        kw = dict(env_config_path=env_yaml, scene_id=scene_id, dataset_format="gibson",
                  dataset_root="/nonexistent", step_num=step_num, downsample=downsample,
                  results_dir=str(tmp_path / side), sim_factory=mock.make_mock_sim)
        ds = (jhb.HabitatDataset if side == "jax" else HabitatDataset)(**kw)
        out[side] = (ds, ds.setup())
    return out


def test_adapter_frames_bitwise_on_both_mocks(tmp_path, monkeypatch):
    monkeypatch.setenv("ACTIVESPLAT_NATIVE", "0")
    env_yaml = write_env_yaml(tmp_path / "env.yaml", forward=0.25)
    assert len(PARITY_ACTIONS) == 40
    both = both_datasets(tmp_path, env_yaml)
    (jds, jcfg), (tds, tcfg) = both["jax"], both["port"]
    # the port's payload also carries the scene config's planner block (none here)
    assert tcfg.keys() == jcfg.keys() | {"planner"} and tcfg["planner"] == {}
    for key in jcfg:  # each side writes into its own results_dir
        if key != "results_dir":
            np.testing.assert_array_equal(np.asarray(tcfg[key]), np.asarray(jcfg[key]),
                                          err_msg=key)
    returns = {"jax": [], "port": []}
    for i in range(len(PARITY_ACTIONS) + 1):
        fj, ft = jds.get_frame(), tds.get_frame()
        assert fj.keys() == ft.keys()
        for key in ("rgb", "depth", "c2w"):
            assert ft[key].dtype == fj[key].dtype, key
            np.testing.assert_array_equal(ft[key], fj[key], err_msg=f"frame {i} {key}")
        assert ft["frame_id"] == fj["frame_id"] == i
        if i < len(PARITY_ACTIONS):
            a = PARITY_ACTIONS[i]
            returns["jax"].append(jds.step(jhb.SimAction(int(a))))
            returns["port"].append(tds.step(a))
    assert returns["port"] == returns["jax"]
    assert not all(returns["port"]), "no forward was blocked"
    assert tds.get_step_info() == jds.get_step_info()
    tds.close(), jds.close()
    acts = [open(tmp_path / side / "actions.txt").read() for side in ("jax", "port")]
    assert acts[0] == acts[1] and len(acts[1].split()) == len(PARITY_ACTIONS)


@pytest.mark.parametrize("downsample", [2.0, 1.5])
def test_downsample_path_against_cv2(tmp_path, monkeypatch, downsample):
    monkeypatch.setenv("ACTIVESPLAT_NATIVE", "0")
    env_yaml = write_env_yaml(tmp_path / "env.yaml")
    both = both_datasets(tmp_path, env_yaml, downsample=downsample)
    jds, tds = both["jax"][0], both["port"][0]
    assert (tds.sensor.width, tds.sensor.height) == (jds.sensor.width, jds.sensor.height)
    assert tds.sensor.width == int(np.ceil(48 / downsample))
    for a in (SimAction.TURN_LEFT, SimAction.LOOK_DOWN, SimAction.MOVE_FORWARD):
        fj, ft = jds.get_frame(), tds.get_frame()
        assert ft["rgb"].shape == fj["rgb"].shape and ft["rgb"].dtype == np.float32
        np.testing.assert_allclose(ft["rgb"], fj["rgb"], rtol=0, atol=RGB_ATOL)
        np.testing.assert_array_equal(ft["depth"], fj["depth"])
        jds.step(jhb.SimAction(int(a)))
        tds.step(a)


def test_resize_nearest_against_cv2():
    import cv2

    img = np.random.default_rng(0).random((37, 53)).astype(np.float32)
    for w, h in ((26, 18), (53, 37), (17, 12), (40, 29)):
        np.testing.assert_array_equal(resize_nearest(img, w, h),
                                      cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST))


def test_mock_scene_pick_equal():
    spec = HabitatEnvSpec.from_yaml(ENV_YAML)
    jspec = jhb.HabitatEnvSpec.from_yaml(ENV_YAML)
    kinds = set()
    for sid in ("Denmark", "Elmira", "Eudora", "Greigsville", "Pablo", "Ribera", "Cantwell",
                "Eastville", "Swormville", "gZ6f7yhEvPG", "MockDenmark", "Eval"):
        url = f"/data/{sid}.glb"
        t = tmock.make_mock_sim({"scene": url, "spec": spec})
        j = jmock.make_mock_sim({"scene": url, "spec": jspec})
        assert t.world.size == j.world.size, sid
        np.testing.assert_array_equal(t.world.obstacles, j.world.obstacles, err_msg=sid)
        np.testing.assert_array_equal(t._start, j._start, err_msg=sid)
        kinds.add(t.world.size)
    assert len(kinds) == 2  # both rooms are picked


def test_real_simulator_gated(tmp_path):
    """Without a sim_factory setup() imports the habitat wheels; absent
    here, it raises and names the hermetic mock."""
    ds = HabitatDataset(env_config_path=ENV_YAML, scene_id="Denmark", dataset_root="/g")
    with pytest.raises(ImportError, match="--habitat_sim mock"):
        ds.setup()
