"""The port's per-frame mapper driver (SplaTAMMapper) against the JAX
package's, on the same frames of the JAX package's BoxWorld: the buffers,
keyframe stores, map versions, change-log boxes, shape history, metrics and
output files over the first frames of a stream at default scheduling; the
k escalation and the exact_training "auto" -> "hybrid" switch; checkpoints
across the two packages and a kill-and-resume; a 12-frame fit; the
reorientation query.

In the driver comparison the JAX side renders as it does on a TPU
(forward_backend patched to "pallas", its kernels in interpret mode, as
tests/test_torch_queries.py does), so both blends exit saturated tiles early,
and no random draw decides anything: frame 0's event sees only the current
frame. Tolerances: slots and counts exactly; parameters and metrics 1e-4
(the same float32 walks, sums in another order, through two mapping
iterations, a densify and the exact online render), but for the few
parameters of a segment at the early exit's threshold (assert_params_close
says why)."""

import dataclasses
import json
import os
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activesplat_tpu.io.params_io import load_params as jax_load_params
from activesplat_tpu.mapper.config import MapperConfig as JaxConfig
from activesplat_tpu.mapper.splatam import SplaTAMMapper as JaxMapper
from activesplat_tpu.models.gaussians import make_camera as jax_make_camera
from activesplat_tpu.ops.render import render as jax_render
from activesplat_tpu.runtime.synthetic import BoxWorld
from activesplat_tpu_torch.convert import buffer_to_numpy
from activesplat_tpu_torch.io.params_io import load_params
from activesplat_tpu_torch.io.png import read_png
from activesplat_tpu_torch.mapper import MapperState, MapperType, get_mapper
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.mapper.splatam import JET_RGB, SplaTAMMapper
from activesplat_tpu_torch.ops.render import render
from activesplat_tpu_torch.queries.panorama import global_invisibility
from activesplat_tpu_torch.queries.clusters import resize_linear_u8
from activesplat_tpu_torch.utils import tracing
from activesplat_tpu_torch.utils.transforms import rot_axis
from tests.test_overflow import make_intrinsics as intrinsics32
from tests.test_torch_mapper import FIELDS, jax_to_numpy, numpy_to_jax

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

W = H = 64


def intrinsics(w=W, h=H):
    fx = 0.5 * w / np.tan(np.deg2rad(45.0))
    return np.array([[fx, 0, w / 2 - 1], [0, fx, h / 2 - 1], [0, 0, 1]])


def pose(x, z, yaw_deg, height=1.25):
    c2w = np.eye(4)
    c2w[:3, 3] = [x, height, z]
    c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
    return rot_axis(c2w, "y", np.deg2rad(yaw_deg))


def stream(n, w=W, h=H, world=None):
    """n frames turning 12 degrees and moving 5 cm per frame from the
    two-room world's start (runtime/launch.py:52-59)."""
    world = world or BoxWorld.two_room(seed=0)
    out = []
    for i in range(n):
        c2w = pose(5.0 + 0.05 * i, 1.5, 12.0 * i)
        rgb, depth = world.render(c2w, intrinsics(w, h), w, h)
        out.append({"frame_id": i, "rgb": rgb, "depth": depth, "c2w": c2w})
    return out


def small_cfg(**kw):
    return dict(dict(initial_capacity=1 << 13, keyframe_capacity=16), **kw)


def assert_params_close(got, ref, adam_steps):
    """Parameters within 1e-4, but for at most 0.1% of the elements, each
    within 2 learning rates per Adam step: both blends exit a saturated tile
    early, and a segment whose entry transmittance lies at the exit
    threshold may be walked on one side only. Its Gaussians then get a zero
    gradient on one side and a tiny one on the other, which Adam (eps 1e-15)
    turns into a whole learning-rate step."""
    lrs = dataclasses.asdict(MapperConfig().lrs)
    for f in FIELDS:
        err = np.abs(got[f] - ref[f])
        off = err > 1e-4 + 1e-4 * np.abs(ref[f])
        assert off.mean() <= 1e-3, (f, int(off.sum()), float(err.max()))
        assert (err[off] <= 2 * adam_steps * lrs[f]).all(), (f, float(err.max()))


@pytest.fixture(scope="module")
def jax_pallas():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys.modules["activesplat_tpu.ops.render"], "forward_backend", lambda: "pallas")
        yield


@pytest.fixture(scope="module")
def driven(jax_pallas, tmp_path_factory):
    """Frames 0-4 of a 64x64 stream through both drivers with MapperConfig
    defaults (capacities cut), checkpoints every two frames, then
    post_processing."""
    frames = stream(5)
    out = {}
    for name, cls, cfg in (("jax", JaxMapper, JaxConfig(**small_cfg())),
                           ("port", SplaTAMMapper, MapperConfig(**small_cfg()))):
        results = str(tmp_path_factory.mktemp(name))
        kw = {"device": "cpu"} if name == "port" else {}
        mapper = cls(cfg, W, H, intrinsics(), step_num=40, results_dir=results,
                     save_checkpoints=True, checkpoint_interval=2, **kw)
        states, versions = [], []
        for batch in frames:
            states.append(mapper.run(batch))
            versions.append(mapper.map_version)
        mapper.post_processing()
        out[name] = (mapper, states, versions, results)
    return frames, out


def test_driver_matches_jax(driven):
    _, out = driven
    jm, j_states, j_versions, _ = out["jax"]
    tm, t_states, t_versions, _ = out["port"]
    assert t_states == [MapperState.BOOTSTRAP] + [MapperState.MAPPING] * 4
    assert [s.name for s in j_states] == [s.name for s in t_states]
    assert t_versions == j_versions == [1, 1, 1, 1, 2]  # first frame; the frame-4 densify
    got, ref = buffer_to_numpy(tm.buf), jax_to_numpy(jm.buf)
    for f in ("active", "timestep"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    assert_params_close(got, ref, adam_steps=2)  # frame 0's event
    assert tm.num_gaussians() == jm.num_gaussians() > W * H
    assert tm.store.count == int(jm.store.count) == 2
    assert tm.keyframe_time_indices == jm.keyframe_time_indices == [0, 4]
    for f in ("rgb", "depth", "w2c", "frame_id"):
        np.testing.assert_array_equal(getattr(tm.store, f).numpy()[:2],
                                      np.asarray(getattr(jm.store, f))[:2], err_msg=f)
    np.testing.assert_allclose(tm.boxes_since(0), jm.boxes_since(0), rtol=1e-12)
    np.testing.assert_array_equal(tm.aabb_since(2), jm.aabb_since(2))
    assert tm.shape_history == jm.shape_history
    assert tm.last_metrics.keys() == jm.last_metrics.keys()
    for k, v in jm.last_metrics.items():
        np.testing.assert_allclose(tm.last_metrics[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    assert tm.last_metrics["psnr"] > tm.last_metrics["psnr_train"]  # the cap bites at frame 0
    for a, b in zip((tm.cam_quats, tm.cam_trans, tm.gt_w2c_rel), (jm.cam_quats, jm.cam_trans, jm.gt_w2c_rel)):
        np.testing.assert_allclose(np.array(a), np.array(b), atol=1e-12)
    assert tm.scene_radius == pytest.approx(jm.scene_radius, rel=1e-6)


def test_stage_report_counts_host_syncs(driven):
    """The driver's stages and their host reads: first frame (dropped,
    scene radius), mapping (the packed metrics), the exact online scores,
    densify (dropped); and the host reads inside the renders."""
    report = tracing.stage_report_io()
    for name in ("mapper/first_frame", "mapper/mapping_iters", "mapper/exact_online",
                 "mapper/densify"):
        assert report[name]["sync"] >= 1, name
    full = tracing.stage_report_full()
    assert all(mx <= tot for tot, _, mx in full.values())


def test_output_files_match_jax(driven):
    """transforms.json equal; every RGB, depth and keyframe PNG the port
    writes decodes (with OpenCV) to the JAX package's pixels, and the
    port's reader decodes the JAX package's files to them too; params.npz
    and the checkpoints carry the same keys, shapes and dtypes."""
    _, out = driven
    jdir = os.path.join(out["jax"][3], "gaussians_data")
    tdir = os.path.join(out["port"][3], "gaussians_data")
    with open(os.path.join(jdir, "transforms.json")) as a, open(os.path.join(tdir, "transforms.json")) as b:
        assert json.load(a) == json.load(b)
    pngs = [os.path.join(sub, f) for sub in ("rgb", "depth", "keyframes")
            for f in sorted(os.listdir(os.path.join(jdir, sub)))]
    assert len(pngs) == 5 + 5 + 2
    for rel in pngs:
        ref = cv2.imread(os.path.join(jdir, rel), cv2.IMREAD_UNCHANGED)
        got = cv2.imread(os.path.join(tdir, rel), cv2.IMREAD_UNCHANGED)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), rel
        # the port's reader decodes OpenCV's files (libpng's filters) alike
        ours = read_png(os.path.join(jdir, rel))
        assert np.array_equal(ours, ref if ref.ndim == 2 else ref[..., ::-1]), rel
    for rel in ["params.npz"] + [f"checkpoints/params{i}.npz" for i in (0, 2, 4)]:
        ref, got = jax_load_params(os.path.join(jdir, rel)), load_params(os.path.join(tdir, rel))
        assert got.keys() == ref.keys(), rel
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, (rel, k)
    for i in (0, 2, 4):
        with np.load(os.path.join(jdir, f"checkpoints/mapper_state{i}.npz")) as ref, \
                np.load(os.path.join(tdir, f"checkpoints/mapper_state{i}.npz")) as got:
            assert set(ref.files) | {"torch_generator_state"} == set(got.files)
            for k in ref.files:
                if k != "rng_key":
                    np.testing.assert_allclose(got[k], ref[k], atol=1e-12, err_msg=k)


def test_view_renders_match_jax(driven):
    """render_rgbd and render_view of the port's driven map against the JAX
    package's render of the same map with the drivers' settings (white
    background, the exact render through its interpret-mode CSR kernel):
    uint8 colours within one level, floats within 1e-5. The invisibility
    wrappers give the port's queries' results."""
    frames, out = driven
    tm = out["port"][0]
    c2w = frames[2]["c2w"]
    w2c = np.linalg.inv(c2w)
    ref = jax_render(numpy_to_jax(buffer_to_numpy(tm.buf)), jax_make_camera(W, H, intrinsics(), w2c),
                     bg=jnp.ones(3), chunk=tm.cfg.chunk, k_per_tile=tm.cfg.k_per_tile,
                     backend="pallas", exact=True)
    view = tm.render_view(tm._camera(w2c))
    for got, want in ((view["rgb"], ref.rgb), (view["depth"], ref.depth), (view["opacity"], ref.alpha)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    rgb_u8, depth = tm.render_rgbd(c2w)
    want_u8 = (np.clip(np.asarray(ref.rgb), 0.0, 1.0) * 255).astype(np.uint8)
    assert rgb_u8.dtype == np.uint8 and np.abs(rgb_u8.astype(int) - want_u8).max() <= 1
    np.testing.assert_allclose(depth, np.asarray(ref.depth), atol=1e-5)
    nodes = np.array([[5.2, 1.25, 1.5], [0.0, 0.0, 0.0]])
    got = tm.get_global_invisibility(c2w, nodes)
    assert got == global_invisibility(tm.buf, c2w, nodes, chunk=tm.cfg.chunk, scale=tm.pano_scale)
    total, _, invis = tm.get_local_invisibility(c2w)
    assert np.isfinite(total) and invis.ndim == 2


def test_params_files_load_in_either_package(driven):
    """Each package's params.npz loads bitwise in the other's reader, and
    the port's buffer_from_params renders it as the mapper's own buffer."""
    from activesplat_tpu.io.params_io import buffer_from_params as jax_buffer_from_params
    from activesplat_tpu_torch.io.params_io import buffer_from_params

    _, out = driven
    for name in ("jax", "port"):
        path = os.path.join(out[name][3], "gaussians_data", "params.npz")
        a, b = jax_load_params(path), load_params(path)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        jbuf = jax_buffer_from_params(a, capacity=1 << 13)
        tbuf = buffer_from_params(b, capacity=1 << 13, device="cpu")
        got, ref = buffer_to_numpy(tbuf), jax_to_numpy(jbuf)
        for f in ("active", "timestep", *FIELDS):
            np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    tm = out["port"][0]
    cam_args = (tm.width, tm.height, tm.intrinsics, np.linalg.inv(stream(1)[0]["c2w"]))
    from activesplat_tpu_torch.models.gaussians import make_camera

    cam = make_camera(*cam_args, device="cpu")
    a = render(tbuf, cam, k_per_tile=256, exact=True).rgb
    b = render(tm.buf, cam, k_per_tile=256, exact=True).rgb
    assert torch.equal(a, b)


def test_port_resumes_from_a_jax_checkpoint(driven):
    """A port mapper loaded from the JAX package's frame-2 checkpoint runs
    frames 3-4 to the uninterrupted port's state (1e-4: the JAX and port
    buffers agree to that at frame 2)."""
    frames, out = driven
    tm = out["port"][0]
    ckpt = os.path.join(out["jax"][3], "gaussians_data", "checkpoints", "params2.npz")
    resumed = SplaTAMMapper(MapperConfig(**small_cfg()), W, H, intrinsics(), step_num=40,
                            device="cpu")
    resumed.load_map(ckpt)
    assert resumed.tracking_idx == 3 and resumed.store.count == 1
    for batch in frames[3:]:
        resumed.run(batch)
    got, ref = buffer_to_numpy(resumed.buf), buffer_to_numpy(tm.buf)
    np.testing.assert_array_equal(got["active"], ref["active"])
    assert_params_close(got, ref, adam_steps=2)
    assert resumed.keyframe_time_indices == tm.keyframe_time_indices


def test_kill_and_resume_equals_an_uninterrupted_run(tmp_path):
    """Mapping every frame with keyframe draws from the generator: a run
    killed after its frame-2 checkpoint and resumed from it (generator
    state included) ends bitwise where the uninterrupted run does."""
    frames = stream(6, 32, 32)
    cfg = MapperConfig(**small_cfg(map_every=2, kf_every=2, mapping_iters=2, k_per_tile=128,
                                   mapping_window_size=4, kf_select_pixels=64))

    def mapper(results):
        return SplaTAMMapper(cfg, 32, 32, intrinsics(32, 32), step_num=40, results_dir=results,
                             save_checkpoints=True, checkpoint_interval=2, device="cpu")

    full = mapper(str(tmp_path / "full"))
    for batch in frames:
        full.run(batch)
    killed = mapper(str(tmp_path / "killed"))
    for batch in frames[:4]:
        killed.run(batch)
    resumed = mapper(str(tmp_path / "resumed"))
    resumed.load_map(str(tmp_path / "killed" / "gaussians_data" / "checkpoints" / "params2.npz"))
    for batch in frames[3:]:
        resumed.run(batch)
    got, ref = buffer_to_numpy(resumed.buf), buffer_to_numpy(full.buf)
    for f in ("active", "timestep", *FIELDS):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    assert resumed.last_metrics == full.last_metrics
    assert resumed.keyframe_time_indices == full.keyframe_time_indices == [0, 1, 3, 5]


def port_dim_map(mapper):
    p = mapper.buf.params
    mapper.buf = mapper.buf.replace(
        params=p.replace(logit_opacities=torch.full_like(p.logit_opacities, -4.0))
    )


# tests/test_overflow.py:126-222 and tests/test_exact_grad.py:170: (config,
# frames, the states (k_per_tile, exact_training, harmful drops) after each
# frame, the message printed)
ESCALATION = {
    "escalates": (dict(k_per_tile=16, k_per_tile_max=64, k_overflow_patience=2,
                       k_overflow_min_active=0), 3,
                  [(16, "auto", True), (32, "auto", True), (32, "auto", True)],
                  "escalating k_per_tile 16 -> 32"),
    "warns_at_ceiling": (dict(k_per_tile=16, k_per_tile_max=16, k_overflow_patience=1,
                              k_overflow_min_active=0, exact_training="off"), 2,
                         [(16, "off", True), (16, "off", True)],
                         "WARNING: tile lists overflowing"),
    "tiny_scene": (dict(k_per_tile=16, k_per_tile_max=64, k_overflow_patience=2), 3,
                   [(16, "auto", True)] * 3, None),
    "no_overflow": (dict(k_per_tile=1024, k_overflow_patience=1), 1, [(1024, "auto", False)],
                    None),
    "auto_to_hybrid": (dict(k_per_tile=16, k_per_tile_max=16, k_overflow_patience=1,
                            k_overflow_min_active=0), 3, [(16, "hybrid", True)] * 3,
                       "switching the training render to hybrid exact"),
}


@pytest.mark.parametrize("case", sorted(ESCALATION))
def test_escalation_transitions_match_jax(case, capsys):
    """On the reference tests' scenarios (one 32x32 view, the map dimmed
    after frame 0 so that the cap drops harmful memberships), the port's
    driver walks through the reference tests' (k_per_tile, exact_training)
    states; the JAX mapper's policy, handed the port's map and harmful-drop
    count after each event, takes the same transitions and prints the same
    message; shape_history records each transition."""
    cfg_kw, n_frames, states, message = ESCALATION[case]
    base = dict(initial_capacity=1 << 11, max_capacity=1 << 12, keyframe_capacity=8, map_every=1,
                kf_every=1, mapping_iters=1, mapping_window_size=4, chunk=64,
                kf_select_pixels=64, **cfg_kw)
    world = BoxWorld.single_room(seed=0)
    c2w = pose(3.0, 3.0, 0.0)
    rgb, depth = world.render(c2w, intrinsics32(), 32, 32)
    port = SplaTAMMapper(MapperConfig(**base), 32, 32, intrinsics32(), step_num=8, device="cpu")
    ref = JaxMapper(JaxConfig(**base), 32, 32, intrinsics32(), step_num=8)
    t_walk, j_walk, t_out, j_out = [], [], "", ""
    for i in range(n_frames):
        port.run({"frame_id": i, "rgb": rgb, "depth": depth, "c2w": c2w})
        if i == 0:
            port_dim_map(port)
        dropped = port.last_metrics["dropped"]
        t_walk.append((port.cfg.k_per_tile, port.cfg.exact_training, dropped > 0))
        t_out += capsys.readouterr().out
        ref.buf = numpy_to_jax(buffer_to_numpy(port.buf))  # its min-active gate reads the map
        ref._check_tile_overflow(dropped, i)
        j_walk.append((ref.cfg.k_per_tile, ref.cfg.exact_training, dropped > 0))
        j_out += capsys.readouterr().out
    assert t_walk == j_walk == states
    def changes(shapes):  # the distinct (k, exact_training) runs, in order
        out = []
        for shape in shapes:
            if not out or out[-1] != shape:
                out.append(shape)
        return out

    assert changes((h["k_per_tile"], h["exact_training"]) for h in port.shape_history) == changes(
        (k, mode if mode in ("on", "hybrid") else False) for k, mode, _ in states
    )
    if message is None:
        assert "escalating" not in t_out + j_out and "WARNING" not in t_out + j_out
        assert "switching" not in t_out + j_out
    else:
        assert message in t_out and message in j_out


def test_get_mapper_and_knobs():
    assert get_mapper(MapperType.SplaTAM) is SplaTAMMapper
    with pytest.raises(ValueError):
        get_mapper("other")
    m = SplaTAMMapper(MapperConfig(**small_cfg()), W, H, intrinsics(), step_num=7, device="cpu")
    m.set_kf_every(3)
    m.set_map_every(4)
    assert (m.get_kf_every(), m.get_map_every(), m.get_mapping_iters(), m.get_step_num()) == (3, 4, 2, 7)
    assert m.get_mapper_type() is MapperType.SplaTAM and m.truncation_bias() is None
    assert m.run(None) is MapperState.MAPPING
    with pytest.raises(ValueError, match="consecutive"):
        m.run({"frame_id": 3})


def test_twelve_frame_fit(tmp_path):
    """tests/test_mapper.py's fit: a 12-frame spin at a single room's
    centre, map_every = kf_every = 2 and 16 iterations per event; the
    train view's PSNR and depth L1 (dense render) reach the reference
    test's thresholds, and the outputs load back."""
    from activesplat_tpu_torch.io.manifest import load_frame, load_manifest
    from activesplat_tpu_torch.models.gaussians import make_camera

    world = BoxWorld.single_room(seed=3)
    intr = intrinsics()
    cfg = MapperConfig(initial_capacity=1 << 14, max_capacity=1 << 18, keyframe_capacity=32,
                       map_every=2, kf_every=2, mapping_iters=16, mapping_window_size=6,
                       chunk=128, kf_select_pixels=256)
    mapper = SplaTAMMapper(cfg, W, H, intr, step_num=12, results_dir=str(tmp_path), device="cpu")
    frames = []
    for i in range(12):
        c2w = pose(3.0, 3.0, 30.0 * i)
        rgb, depth = world.render(c2w, intr, W, H)
        frames.append((rgb, depth, c2w))
        mapper.run({"rgb": rgb, "depth": depth, "c2w": c2w, "frame_id": i})
    mapper.post_processing()
    rgb, depth, c2w = frames[0]
    with torch.no_grad():
        out = render(mapper.buf, make_camera(W, H, intr, np.linalg.inv(c2w), device="cpu"), chunk=128)
    psnr = -10 * np.log10(float(np.mean((out.rgb.numpy() - rgb) ** 2)) + 1e-12)
    depth_l1 = float(np.abs(out.depth.numpy() - depth)[depth > 0].mean())
    assert psnr > 19.0 and depth_l1 < 0.12 and mapper.num_gaussians() > 1000, (psnr, depth_l1)
    gdir = tmp_path / "gaussians_data"
    manifest = load_manifest(str(gdir))
    back_rgb, back_depth, w2c = load_frame(str(gdir), manifest["frames"][3])
    assert np.abs(back_rgb - frames[3][0]).max() < 0.01 and np.abs(back_depth - frames[3][1]).max() < 0.002
    np.testing.assert_allclose(w2c, np.linalg.inv(frames[3][2]), atol=1e-6)
    # a keyframe every second frame and at step_num - 2; metrics every frame
    assert mapper.keyframe_time_indices == [0, 1, 3, 5, 7, 9, 10, 11]
    assert mapper.truncation_bias()["frames"] == 12


def test_high_loss_samples_match_jax(driven):
    """The reorientation query on the driven map against the JAX package's
    (OpenCV resize, scikit-learn DBSCAN): the same pose, or None on both,
    for a view whose ground truth lies behind the map and for the mapped
    view itself."""
    frames, out = driven
    jm, tm = out["jax"][0], out["port"][0]
    batch = frames[4]
    far = batch["depth"] + np.where(np.arange(W)[None, :] < W // 3, 0.5, 0.0).astype(np.float32)
    for depth in (far, batch["depth"]):
        ref = jm.get_high_loss_samples(batch["rgb"], depth, batch["c2w"])
        got = tm.get_high_loss_samples(batch["rgb"], depth, batch["c2w"])
        assert (got is None) == (ref is None)
        if ref is not None:
            np.testing.assert_allclose(got, ref, atol=1e-9)


def test_jet_table_and_linear_resize_match_opencv():
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[None], cv2.COLORMAP_JET)[0]
    np.testing.assert_array_equal(JET_RGB, lut[:, ::-1])
    rng = np.random.default_rng(0)
    for (h, w, dh, dw) in [(256, 256, 90, 90), (64, 64, 90, 90), (48, 64, 90, 90),
                           (100, 37, 13, 77), (17, 300, 90, 90)]:
        for img in ((rng.uniform(size=(h, w)) < 0.4).astype(np.uint8),
                    rng.integers(0, 256, (h, w)).astype(np.uint8)):
            np.testing.assert_array_equal(
                resize_linear_u8(img, dw, dh), cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
            )


def test_trace_capture_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("ACTIVESPLAT_TRACE_DIR", str(tmp_path))
    with tracing.trace_capture():
        torch.ones(8).sum()
    assert any(p.suffix == ".json" for p in tmp_path.iterdir())
    monkeypatch.delenv("ACTIVESPLAT_TRACE_DIR")
    with tracing.trace_capture():
        pass
    assert len(list(tmp_path.iterdir())) == 1
