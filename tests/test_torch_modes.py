"""The port's REPLAY and MANUAL_CONTROL modes, the node's external-frames
topic, the offline-fit entry point and NVS from a dump, on the CPU
(tests/test_modes.py's replay, external-frames, offline-fit, NVS-from-dump
and manual-control tests on activesplat_tpu_torch), plus fit_offline
against the JAX package's fit_offline on the same dump.

The parity fit makes the mapping iterations' keyframe pick deterministic on
both sides (the current frame every iteration, as
tests/test_torch_episode.py does), so that only float rounding separates
the two maps. Tolerance: each averaged metric within rtol 1e-5 (the two
read within 2e-7 of each other on a CPU) and the Gaussian count within
0.2% (densification thresholds a silhouette and a depth error per pixel,
so a pixel within rounding of a threshold may add a Gaussian on one side
only; at 9 frames the two counts read 4,551 and 4,550)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activesplat_tpu.mapper.config import MapperConfig as JaxMapperConfig
from activesplat_tpu.runtime.offline_fit import fit_offline as jax_fit_offline
from activesplat_tpu_torch.eval.nvs import eval_nvs_from_dump
from activesplat_tpu_torch.io.actions import read_actions
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.runtime.bus import Bus
from activesplat_tpu_torch.runtime.dataloader import (
    RGBDSensor,
    SimAction,
    SyntheticDataset,
    action_to_twist,
)
from activesplat_tpu_torch.runtime import launch
from activesplat_tpu_torch.runtime.launch import run_manual, run_replay
from activesplat_tpu_torch.runtime.mapper_node import MapperNode
from activesplat_tpu_torch.runtime.offline_fit import fit_offline
from activesplat_tpu_torch.runtime.synthetic import BoxWorld
from activesplat_tpu_torch.utils import OPENCV_TO_OPENGL, GlobalState

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(initial_capacity=1 << 11, max_capacity=1 << 11, keyframe_capacity=16,
             mapping_iters=2, map_every=2, kf_every=2, mapping_window_size=4, chunk=128,
             k_per_tile=0, kf_select_pixels=64)
SMALL_CFG = MapperConfig(**SMALL)
FIT = dict(SMALL, initial_capacity=1 << 13, max_capacity=1 << 13, map_every=1, mapping_iters=4)
FIT_STRIDE = 4
FIT_RTOL = 1e-5
GAUSSIAN_RTOL = 2e-3
SCRIPT = [SimAction.TURN_LEFT] * 6 + [SimAction.MOVE_FORWARD] * 2


def make_dataset(results_dir, step_num=8):
    sensor = RGBDSensor.from_fov(32, 32, 90.0, depth_min=0.0, depth_max=10.0)
    return SyntheticDataset(BoxWorld.single_room(seed=7), sensor, step_num=step_num,
                            start_position=np.array([3.0, 0.0, 3.0]), turn_angle_deg=45.0,
                            results_dir=results_dir)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A tiny recorded episode of the port on the CPU: actions.txt and the
    gaussians_data dump."""
    results_dir = str(tmp_path_factory.mktemp("rec"))
    dataset = make_dataset(results_dir)
    bus = Bus()
    node = MapperNode(bus, dataset, SMALL_CFG, results_dir, pixel_max=40, device="cpu")
    for action in SCRIPT:
        bus.publish("cmd_vel", action_to_twist(action))
    node.finish()
    dataset.close()
    return results_dir, node


def test_replay_mode(recorded, tmp_path):
    results_dir, node = recorded
    replay_dir = str(tmp_path / "replay")
    replay_node = run_replay(make_dataset(None), os.path.join(results_dir, "actions.txt"),
                             replay_dir, mapper_cfg=SMALL_CFG, pixel_max=40, save_dataset=False,
                             device="cpu")
    assert replay_node.global_state == GlobalState.QUIT  # REPLAY until the budget ran out
    # same actions -> same trajectory -> same frame count and a live map
    assert replay_node.mapper.mapping_frame_time_count == len(SCRIPT) + 1
    assert replay_node.mapper.num_gaussians() > 100
    assert os.path.exists(os.path.join(replay_dir, "gaussians_data", "params.npz"))
    # deterministic sim + same actions: identical final pose
    np.testing.assert_allclose(replay_node.mapper.est_c2w[-1], node.mapper.est_c2w[-1],
                               atol=1e-12)


def test_replay_stops_at_the_budget(recorded, tmp_path):
    """A replay in a dataset with a smaller step budget maps that many
    actions and stops (the node finishes, the state turns QUIT)."""
    results_dir, _ = recorded
    states = []
    real = MapperNode._on_cmd_vel

    def spy(self, twist):
        states.append(self.global_state)
        real(self, twist)

    MapperNode._on_cmd_vel = spy
    try:
        node = run_replay(make_dataset(None, step_num=3), os.path.join(results_dir, "actions.txt"),
                          str(tmp_path), mapper_cfg=SMALL_CFG, pixel_max=40, save_dataset=False,
                          device="cpu")
    finally:
        MapperNode._on_cmd_vel = real
    assert states == [GlobalState.REPLAY] * 3
    assert node.mapper.mapping_frame_time_count == 4


def test_external_frames_topic(tmp_path):
    """Frames published on the 'frames' topic drive the mapper without the
    owned simulator stepping; tagged OpenGL poses are converted."""
    dataset = make_dataset(None, step_num=4)
    bus = Bus()
    node = MapperNode(bus, dataset, SMALL_CFG, str(tmp_path), pixel_max=40, save_dataset=False,
                      device="cpu")
    frames_before = node.mapper.mapping_frame_time_count
    poses = []
    bus.subscribe("camera_pose", poses.append)
    ext = make_dataset(None, step_num=4)
    ext.step(SimAction.TURN_LEFT)
    frame = ext.get_frame()
    bus.publish("frames", {"rgb": frame["rgb"], "depth": frame["depth"], "c2w": frame["c2w"]})
    assert node.mapper.mapping_frame_time_count == frames_before + 1
    assert dataset.get_step_info()[0] == 0  # the owned simulator did not step
    gl_pose = OPENCV_TO_OPENGL @ np.asarray(frame["c2w"], np.float64) @ OPENCV_TO_OPENGL
    bus.publish("frames", {"rgb": frame["rgb"], "depth": frame["depth"], "c2w": gl_pose,
                           "pose_data_type": "C2W_OPENGL"})
    np.testing.assert_allclose(node.mapper.est_c2w[-1], node.mapper.est_c2w[-2], atol=1e-9)
    np.testing.assert_allclose(poses[-1], frame["c2w"], atol=1e-12)
    node.finish()
    bus.publish("frames", {"rgb": frame["rgb"], "depth": frame["depth"], "c2w": frame["c2w"]})
    assert node.mapper.mapping_frame_time_count == frames_before + 2  # finished: ignored


@pytest.fixture(scope="module")
def fits(recorded, tmp_path_factory):
    """fit_offline of the port (writing its outputs) and of the JAX package
    on every FIT_STRIDE-th frame of the recorded dump, the keyframe pick
    made deterministic on both sides."""
    results_dir, _ = recorded
    gdir = os.path.join(results_dir, "gaussians_data")
    out = str(tmp_path_factory.mktemp("fit"))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "randint", lambda key, shape, minval, maxval, dtype=None:
               jnp.full(shape, maxval - 1, jnp.int32))
    rand = torch.rand
    mp.setattr(torch, "rand", lambda *a, **k: torch.full_like(rand(*a, **k), 1 - 2.0**-24))
    jax.clear_caches()  # a mapping phase traced before the patch would keep its draw
    try:
        want = jax_fit_offline(gdir, JaxMapperConfig(**FIT), frame_stride=FIT_STRIDE)
        got = fit_offline(gdir, MapperConfig(**FIT), out_dir=out, frame_stride=FIT_STRIDE,
                          device="cpu")
    finally:
        mp.undo()
        jax.clear_caches()
    return got, want, out


def test_offline_fit_entry(fits):
    metrics, _, out = fits
    assert metrics["num_frames"] == 3
    assert metrics["psnr"] > 15, metrics
    assert metrics["depth_l1"] < 0.5, metrics
    assert os.path.exists(os.path.join(out, "offline_fit_metrics.json"))
    assert os.path.exists(os.path.join(out, "gaussians_data", "params.npz"))


def test_offline_fit_matches_jax(fits):
    """The port's fit_offline against the JAX package's on the same dump."""
    got, want, _ = fits
    assert got["num_frames"] == want["num_frames"] == 3
    np.testing.assert_allclose(got["num_gaussians"], want["num_gaussians"], rtol=GAUSSIAN_RTOL)
    for key in ("psnr", "ssim", "ms_ssim", "depth_l1", "depth_rmse"):
        np.testing.assert_allclose(got[key], want[key], rtol=FIT_RTOL, err_msg=key)


def test_eval_nvs_from_dump(recorded):
    """NVS split eval (eval_nvs parity, eval_helpers.py:627-806): held-out
    frames score the saved map with hole-validity gating."""
    results_dir, _ = recorded
    gdir = os.path.join(results_dir, "gaussians_data")
    metrics = eval_nvs_from_dump(os.path.join(gdir, "params.npz"), gdir, holdout_every=5,
                                 chunk=128, device="cpu")
    assert metrics["num_eval_frames"] == 2
    assert 0.0 <= metrics["valid_frame_ratio"] <= 1.0
    if metrics["valid_frame_ratio"] > 0:
        assert metrics["psnr"] > 10
        assert metrics["depth_l1"] < 1.0


def test_manual_control_mode(tmp_path):
    """MANUAL_CONTROL teleop: scripted keys drive cmd_vel while the mapper
    maps every frame (reference keyboard teleop, visualizer.py:1934-1965)."""
    keys = list("wwaadx")  # x is unknown -> ignored
    node = run_manual(make_dataset(str(tmp_path), step_num=8), str(tmp_path),
                      mapper_cfg=SMALL_CFG, pixel_max=40, save_dataset=False,
                      action_source=iter(keys), device="cpu")
    # 5 valid keys + the initial frame
    assert node.mapper.mapping_frame_time_count == 6
    assert node.mapper.num_gaussians() > 100
    actions = read_actions(os.path.join(str(tmp_path), "actions.txt"))
    assert actions == [1, 1, 2, 2, 3]  # logged like any other mode
    stopped = run_manual(make_dataset(str(tmp_path / "q"), step_num=8), str(tmp_path / "q"),
                         mapper_cfg=SMALL_CFG, pixel_max=40, save_dataset=False,
                         action_source=iter("wqw"), device="cpu")
    assert stopped.mapper.mapping_frame_time_count == 2  # q quits


def test_launch_cli_replay_and_refusals(recorded, tmp_path, monkeypatch, capsys):
    """The launcher's CLI (runtime/launch.py main) with --mode replay
    replays a recorded actions.txt on the CPU, its mapper config made small
    for the test; replay without its actions is refused, and --mesh 1 is
    taken (the mapper renders unsharded on the CPU's one device)."""
    results_dir, _ = recorded
    monkeypatch.setattr(launch, "MapperConfig", lambda: SMALL_CFG)
    out = str(tmp_path / "cli")
    base = ["--results_dir", out, "--device", "cpu"]
    launch.main(base + ["--mode", "replay", "--actions", os.path.join(results_dir, "actions.txt"),
                        "--scene_id", "single_room", "--step_num", "4", "--width", "32",
                        "--height", "32", "--pixel_max", "40"])
    assert "replay finished: 4 steps" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "gaussians_data", "params.npz"))
    assert not os.path.exists(os.path.join(out, "actions.txt"))  # read, not written
    # the option still refused: replay without its actions
    with pytest.raises(SystemExit) as exc:
        launch.main(base + ["--mode", "replay"])
    assert exc.value.code == 2
    assert "--mode replay requires --actions" in capsys.readouterr().err
    # the multi-device mesh is taken
    launch.main(["--results_dir", str(tmp_path / "mesh"), "--device", "cpu", "--mesh", "1",
                 "--mode", "replay", "--actions", os.path.join(results_dir, "actions.txt"),
                 "--scene_id", "single_room", "--step_num", "4", "--width", "32", "--height",
                 "32", "--pixel_max", "40"])
    text = capsys.readouterr().out
    assert "rendering unsharded" in text and "replay finished: 4 steps" in text
