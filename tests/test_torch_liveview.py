"""The port's live view (runtime/liveview.py), runtime recorder
(io/recorder.py), colour tables (io/colormaps.py) and the node's orbit
overlay: tests/test_liveview.py's 2 tests and tests/test_modes.py's
test_rgbd_silhouette_panel and test_live_view_server on the port, and the
port's pixels against the JAX package's (OpenCV's) on the same inputs.

Tolerances: every compared pixel equal. Two exceptions, both on purpose:
the recorder's 2x3 panel has no text labels, so its pixels are compared
outside the label band (the top LABEL_ROWS rows of each cell row, where
cv2.putText draws at baseline 14 with scale 0.38); the orbit overlay is
compared on the same map render (a fixed image in place of the mapper's
render on both sides), so that only the overlay's polyline and dot, drawn by
planner/draw.py against cv2.line and cv2.circle, are held."""

import glob
import json
import os
import types
import urllib.request

import cv2
import numpy as np
import pytest

from activesplat_tpu.io.recorder import RuntimeRecorder as JaxRecorder
from activesplat_tpu.queries.topdown import topdown_config_from_bbox as jtopdown_cfg
from activesplat_tpu.runtime.liveview import LiveView as JaxLiveView
from activesplat_tpu.runtime.mapper_node import MapperNode as JaxMapperNode
from activesplat_tpu_torch.io.colormaps import JET_RGB, VIRIDIS_RGB
from activesplat_tpu_torch.io.png import decode_png, read_png
from activesplat_tpu_torch.io.recorder import RuntimeRecorder
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.queries.topdown import topdown_config_from_bbox
from activesplat_tpu_torch.runtime.bus import Bus
from activesplat_tpu_torch.runtime.dataloader import (
    RGBDSensor,
    SimAction,
    SyntheticDataset,
    action_to_twist,
)
from activesplat_tpu_torch.runtime.launch import make_synthetic_dataset, run_episode
from activesplat_tpu_torch.runtime.liveview import LiveView
from activesplat_tpu_torch.runtime.mapper_node import MapperNode
from activesplat_tpu_torch.runtime.synthetic import BoxWorld

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

LABEL_ROWS = 20
SMALL_CFG = MapperConfig(initial_capacity=1 << 11, max_capacity=1 << 11, keyframe_capacity=16,
                         mapping_iters=2, map_every=2, kf_every=2, mapping_window_size=4,
                         chunk=128, k_per_tile=0, kf_select_pixels=64)


@pytest.fixture
def live():
    lv = LiveView(port=0)
    yield lv
    lv.close()


def fetch(lv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{lv.port}{path}", timeout=5) as r:
        return r.status, r.read()


def make_dataset(step_num=5):
    sensor = RGBDSensor.from_fov(32, 32, 90.0, depth_min=0.0, depth_max=10.0)
    return SyntheticDataset(BoxWorld.single_room(seed=7), sensor, step_num=step_num,
                            start_position=np.array([3.0, 0.0, 3.0]), turn_angle_deg=45.0,
                            results_dir=None)


def test_endpoints_serve_latest_artifacts(live):
    status, body = fetch(live, "/")
    assert status == 200 and b"planner.png" in body
    with pytest.raises(urllib.error.HTTPError):
        fetch(live, "/planner.png")  # before any update, images 404
    live.update_view(np.random.default_rng(0).uniform(0, 1, (32, 32, 3)))
    live.update_topdown(np.zeros((40, 40), np.uint8), np.ones((40, 40), np.uint8))
    live.update_planner(np.zeros((40, 40, 3), np.uint8))
    live.update_subregions(np.zeros((40, 40, 3), np.uint8))
    live.update_panorama(np.random.default_rng(0).uniform(0, 1, (30, 120)))
    live.update_map3d(np.random.default_rng(0).uniform(0, 1, (32, 32, 3)))
    live.update_metrics({"step": 3, "psnr": 21.5})
    for name in LiveView.IMAGES:
        status, body = fetch(live, f"/{name}.png")
        assert status == 200 and body[:4] == b"\x89PNG", name
    status, body = fetch(live, "/metrics.json")
    assert json.loads(body) == {"step": 3, "psnr": 21.5}
    status, _ = fetch(live, "/view.png?cachebust=1")
    assert status == 200
    with pytest.raises(urllib.error.HTTPError):
        fetch(live, "/nothing.png")


def test_planner_pushes_overlay_on_select(tmp_path):
    """A live episode updates /planner.png per SELECT_TARGET tick."""
    dataset = make_synthetic_dataset(scene_id="single_room", seed=2, step_num=45, width=48,
                                     height=48, turn_angle_deg=30.0, results_dir=str(tmp_path))
    cfg = MapperConfig(initial_capacity=1 << 12, max_capacity=1 << 13, keyframe_capacity=32,
                       mapping_iters=2, map_every=5, kf_every=5, mapping_window_size=5,
                       chunk=128, kf_select_pixels=128)
    mapper_node, planner = run_episode(dataset, str(tmp_path), mapper_cfg=cfg, pixel_max=56,
                                       max_ticks=200, pano_scale=0.4, live_view_port=0,
                                       device="cpu")
    assert planner.live_view is mapper_node.live_view
    lv = mapper_node.live_view
    assert lv._get("planner") is not None
    assert lv._get("topdown") is not None
    assert lv._get("map3d") is not None
    assert 0 <= mapper_node._map3d_version <= mapper_node.mapper.map_version
    with pytest.raises(OSError):  # finish() closed the server
        fetch(lv, "/")


def test_rgbd_silhouette_panel(tmp_path):
    """save_runtime_data writes the 2x3 rgbd/silhouette diagnostic panel."""
    bus = Bus()
    node = MapperNode(bus, make_dataset(), SMALL_CFG, str(tmp_path), pixel_max=40,
                      save_dataset=False, save_runtime_data=True, record_view_every=1,
                      device="cpu")
    bus.publish("cmd_vel", action_to_twist(SimAction.TURN_LEFT))
    node._get_topdown(False)
    node.finish()
    panels = sorted(glob.glob(str(tmp_path / "current_vis_data" / "rgbd_sil_*.png")))
    assert panels
    assert read_png(panels[0]).shape == (64, 96, 3)  # 2x3 grid of 32x32 cells
    assert glob.glob(str(tmp_path / "current_vis_data" / "rgb_*.png"))
    assert glob.glob(str(tmp_path / "current_vis_data" / "depth_*.png"))
    assert glob.glob(str(tmp_path / "topdown_map" / "free_*.png"))


def test_live_view_server(tmp_path):
    """The headless dashboard serves the latest render, topdown maps and
    metrics during an episode."""
    bus = Bus()
    node = MapperNode(bus, make_dataset(), SMALL_CFG, str(tmp_path), pixel_max=40,
                      save_dataset=False, record_view_every=1, live_view_port=0, device="cpu")
    bus.publish("cmd_vel", action_to_twist(SimAction.TURN_LEFT))
    node._get_topdown(False)
    base = f"http://127.0.0.1:{node.live_view.port}"
    page = urllib.request.urlopen(base + "/", timeout=5).read()
    assert b"live view" in page
    for endpoint in ("/view.png", "/topdown.png", "/map3d.png"):
        img = urllib.request.urlopen(base + endpoint, timeout=5).read()
        assert img[:8] == b"\x89PNG\r\n\x1a\n", endpoint
    assert decode_png(urllib.request.urlopen(base + "/view.png", timeout=5).read()).shape == (
        32, 64, 3)  # the render beside its JET depth
    metrics = json.loads(urllib.request.urlopen(base + "/metrics.json", timeout=5).read())
    assert metrics["num_gaussians"] > 0
    assert metrics["step"] == 1
    node.finish()


# ---------------------------------------------------------------------- #
# the port's pixels against the JAX package's

def test_colour_tables_equal_opencv():
    levels = np.arange(256, dtype=np.uint8)[:, None]
    np.testing.assert_array_equal(JET_RGB, cv2.applyColorMap(levels, cv2.COLORMAP_JET)[:, 0, ::-1])
    np.testing.assert_array_equal(VIRIDIS_RGB,
                                  cv2.applyColorMap(levels, cv2.COLORMAP_VIRIDIS)[:, 0, ::-1])


def panel_inputs(seed=0, h=64, w=64):
    rng = np.random.default_rng(seed)
    gt_depth = rng.uniform(0.3, 7.0, (h, w))
    gt_depth[:5, :9] = 0.0  # invalid depth: masked out of the difference
    return dict(gt_rgb=rng.uniform(0, 1, (h, w, 3)).astype(np.float32), gt_depth=gt_depth,
                rendered_rgb=rng.uniform(-0.1, 1.1, (h, w, 3)),
                rendered_depth=gt_depth + rng.normal(0, 0.3, (h, w)),
                silhouette=rng.uniform(-0.05, 1.05, (h, w)))


def test_recorder_pixels_equal_the_jax_recorder(tmp_path):
    j = JaxRecorder(str(tmp_path / "jax"))
    t = RuntimeRecorder(str(tmp_path / "port"))
    inputs = panel_inputs()
    rng = np.random.default_rng(1)
    free, unobs = rng.random((40, 56)) > 0.5, rng.random((40, 56)) > 0.3
    invis = rng.uniform(0, 0.8, (30, 90))
    for rec in (j, t):
        rec.save_rgbd_silhouette(7, *inputs.values(), 23.456, 0.123)
        rec.save_view(7, inputs["rendered_rgb"], inputs["rendered_depth"])
        rec.save_topdown(free, unobs)
        rec.save_panorama(7, "local", invis)
    files = sorted(os.path.relpath(p, tmp_path / "jax")
                   for p in glob.glob(str(tmp_path / "jax" / "**" / "*.png"), recursive=True))
    assert len(files) == 6
    assert files == sorted(os.path.relpath(p, tmp_path / "port") for p in glob.glob(
        str(tmp_path / "port" / "**" / "*.png"), recursive=True))
    for rel in files:
        want = cv2.imread(str(tmp_path / "jax" / rel), cv2.IMREAD_UNCHANGED)
        got = read_png(str(tmp_path / "port" / rel))
        if want.ndim == 3:
            want = want[..., ::-1]
        assert got.shape == want.shape, rel
        if "rgbd_sil" in rel:
            h = inputs["gt_depth"].shape[0]
            outside = np.ones(got.shape[:2], bool)
            outside[:LABEL_ROWS] = outside[h:h + LABEL_ROWS] = False
            np.testing.assert_array_equal(got[outside], want[outside], err_msg=rel)
            assert (got[~outside] != want[~outside]).any()  # the JAX labels are there
        else:
            np.testing.assert_array_equal(got, want, err_msg=rel)


def test_live_view_pixels_equal_the_jax_live_view():
    rng = np.random.default_rng(2)
    j, t = JaxLiveView(port=0), LiveView(port=0)
    try:
        bgr = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
        view = rng.uniform(-0.1, 1.1, (24, 32, 3))
        for lv in (j, t):
            lv.update_view(view, np.linspace(0, 5, 24 * 32).reshape(24, 32))
            lv.update_topdown(np.eye(40, 56, dtype=np.uint8), np.tri(40, 56, dtype=np.uint8))
            lv.update_planner(bgr)
            lv.update_subregions(bgr[::-1].copy())
            lv.update_panorama(np.linspace(0, 0.7, 30 * 90).reshape(30, 90))
            lv.update_map3d(np.linspace(0, 1, 24 * 32 * 3).reshape(24, 32, 3))
        for name in LiveView.IMAGES:
            want = cv2.imdecode(np.frombuffer(j._get(name), np.uint8), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(decode_png(t._get(name)), want[..., ::-1], err_msg=name)
    finally:
        j.close()
        t.close()


def test_orbit_overlay_equal_the_jax_node():
    """_update_map3d's image on the same trajectory and the same map render
    (a fixed image on both sides): the orbit camera, the projected polyline
    (drawn where both ends are in front) and the dot equal the JAX node's."""
    rng = np.random.default_rng(3)
    bbox = np.array([[0.0, 10.0], [0.0, 3.0], [0.0, 6.0]])
    intr = np.array([[40.0, 0, 47.5], [0, 40.0, 35.5], [0, 0, 1]])
    base = rng.uniform(0, 1, (72, 96, 3))
    trajectory = list(np.column_stack([rng.uniform(0.5, 9.5, 60), np.full(60, 1.25),
                                       rng.uniform(0.5, 5.5, 60)]))
    trajectory += [np.array([5.0, 30.0, 3.0]), np.array([-40.0, 1.25, 80.0])]  # far, off-image

    def fake(node_cls, cfg):
        out = {}
        self = types.SimpleNamespace(
            live_view=types.SimpleNamespace(update_map3d=lambda img: out.setdefault("img", img)),
            _map3d_version=-1, _map3d_azimuth=0.0, _trajectory=trajectory, topdown_cfg=cfg,
            mapper=types.SimpleNamespace(_camera=lambda w2c: w2c, intrinsics=intr,
                                         render_view=lambda cam: {"rgb": base.copy()}))
        self._orbit_c2w = lambda a: node_cls._orbit_c2w(self, a)
        for version in (3, 3, 4):  # one render a map version
            out.pop("img", None)
            node_cls._update_map3d(self, version)
        return out["img"], self._orbit_c2w(0.7)

    got, c2w_t = fake(MapperNode, topdown_config_from_bbox(bbox, 0.0, 1.5, pixel_max=56))
    want, c2w_j = fake(JaxMapperNode, jtopdown_cfg(bbox, 0.0, 1.5, pixel_max=56))
    np.testing.assert_array_equal(c2w_t, c2w_j)
    np.testing.assert_array_equal(got, want)
    assert (got != (np.clip(base, 0, 1) * 255).astype(np.uint8)).any()  # the overlay drew
