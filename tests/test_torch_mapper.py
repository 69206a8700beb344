"""The port's mapper modules and the mapping slice against the JAX package on
the same numpy inputs: SSIM/PSNR, Adam, the Gaussian buffer, RGB-D
initialization, the mapping loss and its gradients, chained mapping
iterations, first_frame_phase, mapping_phase and pruning.

On the CPU the JAX mapping loss blends through its XLA tile blend, which has
no early exit (ops/render.py:42-45, mapper/step.py:68), while the port's twin
exits a saturated tile early. Adam with eps 1e-15 would turn a zero-versus-
tiny gradient difference into a full learning-rate step, so the slice-level
scenes hold no tile whose transmittance falls below exp(LOG_EPS); the tests
assert it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from activesplat_tpu.mapper import adam as jadam
from activesplat_tpu.mapper import keyframes as jkeyframes
from activesplat_tpu.mapper import step as jstep
from activesplat_tpu.mapper.config import MapperConfig as JaxConfig
from activesplat_tpu.mapper.geometry import gaussians_from_rgbd as jax_from_rgbd
from activesplat_tpu.mapper.keyframes import KeyframeStore as JaxStore
from activesplat_tpu.models import gaussians as jg
from activesplat_tpu.ops import ssim as jssim
from activesplat_tpu.runtime.synthetic import BoxWorld as JaxWorld
from activesplat_tpu_torch.convert import (
    buffer_from_numpy,
    buffer_to_numpy,
    camera_from_numpy,
    keyframes_from_numpy,
)
from activesplat_tpu_torch.mapper import adam as tadam
from activesplat_tpu_torch.mapper import step as tstep
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.mapper.geometry import gaussians_from_rgbd
from activesplat_tpu_torch.mapper.keyframes import KeyframeStore
from activesplat_tpu_torch.models import gaussians as tg
from activesplat_tpu_torch.ops import ssim as tssim
from activesplat_tpu_torch.ops.raster_cuda import LOG_EPS, blend_tiles_fwd
from activesplat_tpu_torch.ops.raster_tiled import tile_rows
from activesplat_tpu_torch.ops.render import render
from activesplat_tpu_torch.runtime.bench_scene import build_map
from activesplat_tpu_torch.runtime.synthetic import BoxWorld
from activesplat_tpu_torch.utils.transforms import rot_axis

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

W, H = 64, 48
FIELDS = ("means3d", "rgb", "quats", "logit_opacities", "log_scales")


def t(x):
    return torch.from_numpy(np.array(x))


def jax_to_numpy(buf):
    out = {f: np.array(getattr(buf.params, f)) for f in FIELDS}
    for f in ("active", "timestep", "max_radius", "grad_accum", "denom"):
        out[f] = np.array(getattr(buf, f))
    return out


def numpy_to_jax(d):
    return jg.GaussianBuffer(
        params=jg.GaussianParams(*(jnp.asarray(d[f]) for f in FIELDS)),
        active=jnp.asarray(d["active"]),
        **{f: jnp.asarray(d[f]) for f in ("timestep", "max_radius", "grad_accum", "denom")},
    )


def assert_buffers_close(got, ref, rtol=1e-5, atol=1e-6):
    for k, r in ref.items():
        if r.dtype == bool:
            np.testing.assert_array_equal(got[k], r, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], r, rtol=rtol, atol=atol, err_msg=k)


# --------------------------------------------------------------------------- #
# SSIM, PSNR, Adam, buffer, geometry
# --------------------------------------------------------------------------- #


def test_ssim_psnr_match_jax():
    """Same banded-Toeplitz blurs as float32 matmuls: 1e-5."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(
        float(tssim.ssim(t(a), t(b))), float(jssim.ssim(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5,
    )
    np.testing.assert_allclose(
        float(tssim.psnr(t(a), t(b))), float(jssim.psnr(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6,
    )
    for got, ref in zip(tssim.ssim_cs(t(a), t(b)), jssim.ssim_cs(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_adam_update_matches_jax():
    """Three bias-corrected steps with per-group rates: float32 (1e-6)."""
    rng = np.random.default_rng(1)
    shapes = {"means3d": (20, 3), "rgb": (20, 3), "quats": (20, 4),
              "logit_opacities": (20,), "log_scales": (20, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    cfg = MapperConfig()
    jp = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()})
    tp = tg.GaussianParams(**{k: t(v) for k, v in params.items()})
    js, ts = jadam.AdamState.init(jp), tadam.AdamState.init(tp)
    for _ in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        grads["rgb"][0] = 0.0  # zero gradient: no step from a fresh state
        jp, js = jadam.adam_update(
            jp, jg.GaussianParams(**{k: jnp.asarray(v) for k, v in grads.items()}), js,
            jadam.lr_pytree(JaxConfig()),
        )
        tp, ts = tadam.adam_update(
            tp, tg.GaussianParams(**{k: t(v) for k, v in grads.items()}), ts,
            tadam.lr_params(cfg),
        )
    for k in shapes:
        np.testing.assert_allclose(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert ts.count == int(js.count) == 3


def test_insert_gaussians_slot_order_matches_jax():
    """Free slots first, ascending, stable; overflow dropped and counted."""
    rng = np.random.default_rng(2)
    cap, n = 32, 40
    d = jax_to_numpy(jg.GaussianBuffer.empty(cap))
    d["active"] = rng.uniform(size=cap) < 0.4
    d["means3d"] = rng.normal(size=(cap, 3)).astype(np.float32)
    d["max_radius"] = rng.uniform(0, 5, cap).astype(np.float32)
    cand = {
        "means3d": rng.normal(size=(n, 3)), "rgb": rng.uniform(size=(n, 3)),
        "quats": rng.normal(size=(n, 4)), "logit_opacities": rng.normal(size=n),
        "log_scales": rng.normal(size=(n, 3)),
    }
    cand = {k: v.astype(np.float32) for k, v in cand.items()}
    valid = rng.uniform(size=n) < 0.7
    ref, ref_drop = jg.insert_gaussians(
        numpy_to_jax(d), jg.GaussianParams(**{k: jnp.asarray(v) for k, v in cand.items()}),
        jnp.asarray(valid), jnp.float32(7.0),
    )
    got, got_drop = tg.insert_gaussians(
        buffer_from_numpy(d, device="cpu"),
        tg.GaussianParams(**{k: t(v) for k, v in cand.items()}), t(valid), 7.0,
    )
    assert int(got_drop) == int(ref_drop) > 0
    assert_buffers_close(buffer_to_numpy(got), jax_to_numpy(ref), rtol=0, atol=0)
    pruned = tg.prune_mask(got, t(rng.uniform(size=cap) < 0.5))
    assert int(pruned.num_active()) <= int(got.num_active())


def test_grown_matches_jax():
    rng = np.random.default_rng(3)
    d = jax_to_numpy(jg.GaussianBuffer.empty(16))
    d["active"][:5] = True
    d["rgb"] = rng.uniform(size=(16, 3)).astype(np.float32)
    ref = numpy_to_jax(d).grown(40)
    got = buffer_from_numpy(d, device="cpu").grown(40)
    assert_buffers_close(buffer_to_numpy(got), jax_to_numpy(ref), rtol=0, atol=0)


def camera_pose():
    c2w = np.eye(4)
    c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
    c2w[:3, 3] = [5.0, 1.25, 1.5]
    return c2w


def intrinsics():
    fx = 0.5 * W / np.tan(np.deg2rad(45.0))
    return np.array([[fx, 0, W / 2 - 1], [0, fx, H / 2 - 1], [0, 0, 1]])


def boxworld_frame(c2w=None):
    """A BoxWorld RGB-D frame rendered by the JAX package's scene; both
    sides get the same arrays."""
    c2w = camera_pose() if c2w is None else c2w
    return JaxWorld.two_room(seed=0).render(c2w, intrinsics(), W, H)


@pytest.mark.parametrize("isotropic", [False, True])
def test_gaussians_from_rgbd_matches_jax(isotropic):
    rgb, depth = boxworld_frame()
    depth[::7, ::5] = 0.0  # some invalid pixels
    c2w = camera_pose()
    k = intrinsics()
    ref, ref_valid = jax_from_rgbd(
        jnp.asarray(rgb), jnp.asarray(depth), k[0, 0], k[1, 1], k[0, 2], k[1, 2],
        jnp.asarray(c2w, jnp.float32), isotropic=isotropic,
    )
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    got, got_valid = gaussians_from_rgbd(
        t(rgb), t(depth), f32(k[0, 0]), f32(k[1, 1]), f32(k[0, 2]), f32(k[1, 2]),
        t(c2w.astype(np.float32)), isotropic=isotropic,
    )
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(ref_valid))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def test_boxworld_copy_matches_jax_scene():
    """The port's BoxWorld (numpy raycaster) renders the reference's scene:
    depth to 1e-4 m, colour to 1e-3 (the native raycaster, when built on
    the JAX side, rounds differently)."""
    c2w = camera_pose()
    rgb_r, depth_r = boxworld_frame()
    rgb, depth = BoxWorld.two_room(seed=0).render(c2w, intrinsics(), W, H)
    np.testing.assert_allclose(depth, depth_r, atol=1e-4)
    assert np.mean(np.abs(rgb - rgb_r) > 1e-3) < 0.01  # checker edges may flip
    np.testing.assert_allclose(
        BoxWorld.two_room(seed=0).sample_surface(100, seed=1),
        JaxWorld.two_room(seed=0).sample_surface(100, seed=1),
    )


# --------------------------------------------------------------------------- #
# The mapping slice
# --------------------------------------------------------------------------- #


def slice_scene(seed=4, n=300, capacity=512):
    """Gaussians on the surfaces a BoxWorld camera sees, translucent enough
    that no tile saturates, plus the frame itself as ground truth."""
    rng = np.random.default_rng(seed)
    rgb, depth = boxworld_frame()
    k = intrinsics()
    c2w = camera_pose()
    v, u = rng.integers(0, H, n), rng.integers(0, W, n)
    z = depth[v, u] * rng.uniform(0.97, 1.03, n)
    pts_cam = np.stack([(u - k[0, 2]) / k[0, 0] * z, (v - k[1, 2]) / k[1, 1] * z, z], -1)
    pts = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    d = jax_to_numpy(jg.GaussianBuffer.empty(capacity))
    d["means3d"][:n] = pts
    d["rgb"][:n] = rng.uniform(0, 1, (n, 3))
    d["quats"][:n] = rng.normal(size=(n, 4))
    d["logit_opacities"][:n] = rng.uniform(-2.5, 0.0, n)
    d["log_scales"][:n] = rng.uniform(np.log(0.03), np.log(0.09), (n, 3))
    d["active"][:n] = True
    return d, rgb, depth


def cameras(c2w=None):
    c2w = camera_pose() if c2w is None else c2w
    w2c = np.linalg.inv(c2w).astype(np.float32)
    k = intrinsics()
    jcam = jg.make_camera(W, H, k, w2c)
    tcam = camera_from_numpy(
        {"width": W, "height": H, "fx": np.asarray(jcam.fx), "fy": np.asarray(jcam.fy),
         "cx": np.asarray(jcam.cx), "cy": np.asarray(jcam.cy), "w2c": np.asarray(jcam.w2c)},
        device="cpu",
    )
    return jcam, tcam


def assert_no_tile_saturates(tbuf, tcam, k):
    """Every tile keeps some pixel above exp(LOG_EPS) to the end of its
    list, so the twin never exits early where the XLA blend cannot."""
    with torch.no_grad():
        p = tbuf.params
        from activesplat_tpu_torch.ops.projection import adaptive_cull_radius, project_gaussians

        proj = project_gaussians(p.means3d, p.quats, p.log_scales, tbuf.active, tcam.w2c,
                                 tcam.fx, tcam.fy, tcam.cx, tcam.cy, W, H)
        opac = torch.sigmoid(p.logit_opacities)
        radius, valid = adaptive_cull_radius(proj.radius, proj.valid, opac)
        colors = torch.cat([p.rgb, proj.depth[:, None], proj.depth[:, None] ** 2], -1)
        rows, u0, v0, _ = tile_rows(proj.mean2d, proj.conic, opac, colors, valid, radius,
                                    proj.depth, width=W, height=H, k_per_tile=k)
        _, logt = blend_tiles_fwd(rows, u0, v0, 5)
    assert float(logt.amax(dim=1).min()) > LOG_EPS + 0.5


CFG = dict(k_per_tile=64, exact_training="off", chunk=64)


def test_mapping_loss_and_grads_match_jax():
    """Value and gradients before any Adam step. Tolerance: the XLA blend
    (JAX side) and the twin sum in different orders; 1e-5 on the loss, 1e-4
    of each gradient's scale."""
    d, rgb, depth = slice_scene()
    jcam, tcam = cameras()
    jbuf, tbuf = numpy_to_jax(d), buffer_from_numpy(d, device="cpu")
    assert_no_tile_saturates(tbuf, tcam, CFG["k_per_tile"])
    loss_fn = jax.jit(
        jax.value_and_grad(jstep.mapping_loss, has_aux=True), static_argnames=("cfg",)
    )
    (loss_r, aux_r), grads_r = loss_fn(
        jbuf.params, jbuf, jcam, jnp.asarray(rgb), jnp.asarray(depth), cfg=JaxConfig(**CFG)
    )
    loss, aux, grads = tstep.loss_and_grads(tbuf, tcam, t(rgb), t(depth), MapperConfig(**CFG))
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-5)
    for name in ("rgb_l1", "depth_l1", "ssim", "psnr"):
        np.testing.assert_allclose(float(getattr(aux, name)), float(getattr(aux_r, name)),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(aux.radii.numpy(), np.asarray(aux_r.radii))
    assert int(aux.dropped) == int(aux_r.dropped)
    for f in FIELDS:
        r = np.asarray(getattr(grads_r, f))
        assert np.abs(r).max() > 0, f
        np.testing.assert_allclose(getattr(grads, f).numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=f)


def test_mapping_iterations_match_jax():
    """Five chained iterations from the same buffer: per-step loss within
    1e-5 relative, parameters within 1e-5 relative (Adam normalizes each
    step, so a gradient off by 1e-5 relative moves the parameter by about
    as much of one learning-rate step)."""
    d, rgb, depth = slice_scene(seed=5)
    jcam, tcam = cameras()
    jbuf, tbuf = numpy_to_jax(d), buffer_from_numpy(d, device="cpu")
    assert_no_tile_saturates(tbuf, tcam, CFG["k_per_tile"])
    jcfg, tcfg = JaxConfig(**CFG), MapperConfig(**CFG)
    jopt, topt = jadam.AdamState.init(jbuf.params), tadam.AdamState.init(tbuf.params)
    for _ in range(5):
        jbuf, jopt, jm = jstep.mapping_iteration(
            jbuf, jopt, jcam, jnp.asarray(rgb), jnp.asarray(depth), jcfg
        )
        tbuf, topt, tm = tstep.mapping_iteration(tbuf, topt, tcam, t(rgb), t(depth), tcfg)
        for name in ("loss", "psnr", "depth_l1"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-5, err_msg=name)
        assert int(tm["dropped"]) == int(jm["dropped"])
    assert_buffers_close(buffer_to_numpy(tbuf), jax_to_numpy(jbuf), rtol=1e-5, atol=2e-6)


def test_first_frame_phase_matches_jax():
    rgb, depth = boxworld_frame()
    jcam, tcam = cameras()
    jcfg, tcfg = JaxConfig(**CFG), MapperConfig(**CFG)
    ref, ref_drop, ref_radius = jstep.first_frame_phase(
        jg.GaussianBuffer.empty(4096), jcam, jnp.asarray(rgb), jnp.asarray(depth), jcfg
    )
    got, got_drop, got_radius = tstep.first_frame_phase(
        tg.GaussianBuffer.empty(4096, device="cpu"), tcam, t(rgb), t(depth), tcfg
    )
    assert int(got_drop) == int(ref_drop) == 0
    np.testing.assert_allclose(float(got_radius), float(ref_radius), rtol=1e-6)
    assert_buffers_close(buffer_to_numpy(got), jax_to_numpy(ref), rtol=1e-5, atol=1e-5)


def test_mapping_phase_matches_jax():
    """One mapping event on a store with no committed keyframe: the window
    is the current frame only, so no random draw decides anything. Losses
    per iteration and the final buffer, tolerances as for the iterations."""
    d, rgb, depth = slice_scene(seed=6)
    c2w = camera_pose()
    jcam, tcam = cameras()
    jbuf, tbuf = numpy_to_jax(d), buffer_from_numpy(d, device="cpu")
    assert_no_tile_saturates(tbuf, tcam, CFG["k_per_tile"])
    kw = dict(CFG, mapping_window_size=4, kf_select_pixels=64)
    jcfg, tcfg = JaxConfig(**kw), MapperConfig(**kw)
    w2c = np.linalg.inv(c2w).astype(np.float32)
    jbuf, _, jm = jstep.mapping_phase(
        jbuf, JaxStore.empty(4, H, W), jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(w2c),
        jnp.int32(0), jcam, jax.random.PRNGKey(0), jcfg, 4,
    )
    tbuf, store, tm = tstep.mapping_phase(
        tbuf, KeyframeStore.empty(4, H, W, device="cpu"), t(rgb), t(depth), t(w2c), 0, tcam,
        torch.Generator().manual_seed(0), tcfg, 4,
    )
    assert int(tm["num_window"]) == int(jm["num_window"]) == 1
    for name in ("loss", "psnr", "depth_l1", "rgb_l1", "ssim", "packed"):
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]), rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(tm["dropped"].numpy(), np.asarray(jm["dropped"]))
    assert_buffers_close(buffer_to_numpy(tbuf), jax_to_numpy(jbuf), rtol=1e-5, atol=2e-6)
    np.testing.assert_array_equal(store.rgb[store.scratch_slot].numpy(), rgb)


def test_keyframe_window_and_selection():
    """Committed keyframes that overlap the current view are eligible;
    the window lists selected ids, the last keyframe and the scratch slot,
    valid first (splatam/__init__.py:426-436)."""
    rgb, depth = boxworld_frame()
    _, tcam = cameras()
    store = KeyframeStore.empty(8, H, W, device="cpu")
    w2c = t(np.linalg.inv(camera_pose()).astype(np.float32))
    for i in range(4):
        store.committed(t(rgb), t(depth), w2c, i)
    gen = torch.Generator().manual_seed(0)
    ids, valid = tstep.select_keyframes_overlap(
        store, t(depth), w2c, tcam.fx, tcam.fy, tcam.cx, tcam.cy, gen, num_select=4, pixels=64
    )
    # slots 0-2 are eligible (the last committed keyframe joins separately)
    assert sorted(ids[valid].tolist()) == [0, 1, 2]
    window, n_valid = tstep._build_window(store, ids, valid)
    assert int(n_valid) == 5
    assert window[3:5].tolist() == [3, store.scratch_slot]


def test_bench_scene_matches_bench_build_map():
    """The port's benchmark map is bench.py's build_map at a small size: the
    same buffer exactly, the same camera and the same ground-truth frame
    (the port's BoxWorld, see test_boxworld_copy_matches_jax_scene)."""
    buf_r, cam_r, rgb_r, depth_r, cfg_r = bench.build_map(1500, 48, 48)
    scene = build_map(1500, 48, device="cpu")
    assert_buffers_close(buffer_to_numpy(scene.buf), jax_to_numpy(buf_r), rtol=0, atol=0)
    for f in ("fx", "fy", "cx", "cy", "w2c"):
        np.testing.assert_array_equal(getattr(scene.cam, f).numpy(), np.asarray(getattr(cam_r, f)))
    rgb, depth = scene.frame(scene.c2w)
    np.testing.assert_allclose(depth.numpy(), np.asarray(depth_r), atol=1e-4)
    assert np.mean(np.abs(rgb.numpy() - np.asarray(rgb_r)) > 1e-3) < 0.01
    assert (scene.cfg.chunk, scene.cfg.k_per_tile) == (cfg_r.chunk, cfg_r.k_per_tile)
    assert scene.cfg.exact_training == "off"


def test_keyframes_from_numpy_and_selection_match_jax():
    """A JAX keyframe store carried across by keyframes_from_numpy holds the
    same arrays. With num_select above the number of eligible slots every
    eligible keyframe is selected, so both sides must pick the same set
    although their random draws differ: the keyframes that face the frame
    and not the two that face away from it."""
    rgb, depth = boxworld_frame()
    c2w = camera_pose()
    shifted = c2w.copy()
    shifted[:3, 3] += [0.3, 0.0, 0.0]
    away = rot_axis(c2w, "y", np.pi)
    jstore = JaxStore.empty(8, H, W)
    for i, pose in enumerate((c2w, away, shifted, away, c2w)):
        w2c = jnp.asarray(np.linalg.inv(pose), jnp.float32)
        jstore = jstore.committed(jnp.asarray(rgb), jnp.asarray(depth), w2c, i)
    tstore = keyframes_from_numpy(
        {k: np.asarray(getattr(jstore, k)) for k in ("rgb", "depth", "w2c", "frame_id", "count")},
        device="cpu",
    )
    assert tstore.count == int(jstore.count) == 5
    for k in ("rgb", "depth", "w2c", "frame_id"):
        np.testing.assert_array_equal(getattr(tstore, k).numpy(), np.asarray(getattr(jstore, k)))

    jcam, tcam = cameras()
    w2c = np.linalg.inv(c2w).astype(np.float32)
    ref_ids, ref_valid = jkeyframes.select_keyframes_overlap(
        jstore, jnp.asarray(depth), jnp.asarray(w2c), jcam.fx, jcam.fy, jcam.cx, jcam.cy,
        jax.random.PRNGKey(0), num_select=6, pixels=256, edge=4,
    )
    got_ids, got_valid = tstep.select_keyframes_overlap(
        tstore, t(depth), t(w2c), tcam.fx, tcam.fy, tcam.cx, tcam.cy,
        torch.Generator().manual_seed(0), num_select=6, pixels=256, edge=4,
    )
    ref_set = sorted(np.asarray(ref_ids)[np.asarray(ref_valid)].tolist())
    assert sorted(got_ids[got_valid].tolist()) == ref_set == [0, 2]


@pytest.mark.parametrize("iteration", [0, 20])
def test_prune_phase_matches_jax(iteration):
    d, _, _ = slice_scene(seed=7)
    d["logit_opacities"][:50] = -9.0  # below the 0.005 removal threshold
    d["log_scales"][50:60] = 1.0  # too big against the scene radius
    cfg_kw = dict(prune=dataclasses.replace(JaxConfig().prune, reset_opacities=True,
                                            reset_opacities_every=10))
    ref, ref_n = jstep.prune_phase(numpy_to_jax(d), JaxConfig(**cfg_kw), iteration, 2.0)
    tcfg = MapperConfig(prune=dataclasses.replace(MapperConfig().prune, reset_opacities=True,
                                                  reset_opacities_every=10))
    got, got_n = tstep.prune_phase(buffer_from_numpy(d, device="cpu"), tcfg, iteration, 2.0)
    assert int(got_n) == int(ref_n) > 0
    assert_buffers_close(buffer_to_numpy(got), jax_to_numpy(ref), rtol=1e-6, atol=1e-6)


def test_entry_points_run_k_capped_only():
    """"auto" trains k-capped like "off" until the mapper driver that
    switches it is ported; "on" and "hybrid" train exactly (compared with
    the JAX package in tests/test_torch_exact.py) and give finite losses and
    gradients."""
    d, rgb, depth = slice_scene(seed=8)
    _, tcam = cameras()
    tbuf = buffer_from_numpy(d, device="cpu")
    runs = {
        mode: tstep.loss_and_grads(tbuf, tcam, t(rgb), t(depth),
                                   MapperConfig(k_per_tile=64, exact_training=mode))
        for mode in ("off", "auto", "on", "hybrid")
    }
    assert torch.equal(runs["auto"][0], runs["off"][0])
    for loss, _, grads in runs.values():
        assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.tensors())
    out = render(tbuf, tcam, k_per_tile=64)
    assert out.rgb.shape == (H, W, 3) and torch.isfinite(out.rgb).all()
