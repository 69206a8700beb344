"""The port's multi-device path (parallel/sharded.py and the callers that take
a mesh) against the JAX package's mesh code and against the port's own
unsharded path, on the same seeded numpy inputs. The JAX side runs on the
8 virtual CPU devices of tests/conftest.py (or the first d of them); the
port on a virtual mesh that names the CPU d times.

Tolerances, per test:
- renders: rgb and alpha 1e-5, depth 1e-4 absolute, as the JAX package's
  own mesh tests hold them (tests/test_parallel.py:36-38); against the
  port's unsharded render 1e-6 (the shards shift whole tile rows, so the
  bins are the same and only the pixel offsets round apart);
- losses 1e-5 relative, each gradient 1e-4 of its largest value against
  JAX (the two packages sum in other orders) and 1e-5 against the port's
  unsharded loss (the shards' gradients are summed once more);
- mapping events: losses 1e-5 relative, parameters 1e-5 relative and 2e-6
  absolute (Adam normalizes each step, tests/test_torch_mapper.py);
- panoramas: equal to the unsharded queries bitwise, and to JAX's but for
  quantized inputs that sit on a rounding boundary (counted, off by one).

The scenes that train hold no saturating tile: the JAX XLA tile blend has
no early exit, the port's does, and Adam's eps of 1e-15 would turn that
into whole learning-rate steps."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import activesplat_tpu.queries.panorama as jpano
from activesplat_tpu.mapper import step as jstep
from activesplat_tpu.mapper.config import MapperConfig as JaxConfig
from activesplat_tpu.mapper.keyframes import KeyframeStore as JaxStore
from activesplat_tpu.models import gaussians as jg
from activesplat_tpu.parallel import sharded as jsharded
from activesplat_tpu_torch.convert import buffer_from_numpy, buffer_to_numpy
from activesplat_tpu_torch.mapper import step as tstep
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.mapper.keyframes import KeyframeStore
from activesplat_tpu_torch.mapper.splatam import SplaTAMMapper
from activesplat_tpu_torch.models.gaussians import make_camera
from activesplat_tpu_torch.ops.render import render
from activesplat_tpu_torch.parallel import sharded as tsharded
from activesplat_tpu_torch.queries import panorama as tpano
from activesplat_tpu_torch.runtime.synthetic import BoxWorld
from tests.reference_impl import random_scene
from tests.test_render import buffer_from_scene
from tests.test_torch_mapper import (
    assert_buffers_close,
    assert_no_tile_saturates,
    camera_pose,
    cameras,
    jax_to_numpy,
    numpy_to_jax,
    slice_scene,
)
from tests.test_torch_queries import node_c2w, pose
from tests.test_torch_topdown import port_buffer

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

FIELDS = ("means3d", "rgb", "quats", "logit_opacities", "log_scales")


def t(x):
    return torch.from_numpy(np.array(x))


def meshes(d):
    """(JAX mesh over its first d CPU devices, the port's virtual mesh)."""
    return jsharded.make_render_mesh(jax.devices()[:d]), tsharded.make_render_mesh(["cpu"] * d)


def scene(seed, n, w, h, logit_opacity=None):
    """(JAX buffer, port buffer, JAX camera, port camera) of
    tests/test_parallel.py's random scene in front of an identity camera."""
    s = random_scene(np.random.default_rng(seed), n)
    if logit_opacity is not None:
        s["logit_opacities"][:] = logit_opacity
    jbuf = buffer_from_scene(s)
    k = np.array([[40.0, 0, w / 2 - 1], [0, 40.0, h / 2 - 1], [0, 0, 1]])
    return jbuf, port_buffer(jbuf), jg.make_camera(w, h, k, np.eye(4)), make_camera(
        w, h, k, np.eye(4), device="cpu")


def assert_images(got, ref, atol=(1e-5, 1e-4, 1e-5)):
    for name, g, r, tol in zip(("rgb", "depth", "alpha"), got, ref, atol):
        np.testing.assert_allclose(np.asarray(g.detach()) if torch.is_tensor(g) else g,
                                   np.asarray(r), atol=tol, err_msg=name)


def port_images(out):
    return out.rgb, out.depth, out.alpha


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 8])
def test_mesh_for_height_matches_jax(n_devices):
    """The same choice of d for a grid of heights; the port's mesh holds the
    first d devices, in order, and None where the JAX package's is None."""
    devs = [torch.device("cpu")] * n_devices
    for height in (16, 30, 32, 48, 64, 96, 112, 128, 144, 150, 256, 512):
        ref = jsharded.mesh_for_height(height, jax.devices()[:n_devices])
        got = tsharded.mesh_for_height(height, devs)
        if ref is None:
            assert got is None, height
        else:
            assert got.px == ref.shape["px"] and got.devices == tuple(devs[: got.px]), height
    with pytest.raises(ValueError):
        tsharded.make_render_mesh(["cpu", "meta"])


def test_render_sharded_matches_jax_and_unsharded():
    """The dense row-sharded render at 64x32 over 8 shards of 4 rows."""
    jbuf, tbuf, jcam, tcam = scene(0, 100, 64, 32)
    jmesh, tmesh = meshes(8)
    ref = jax.jit(jsharded.render_sharded, static_argnames=("mesh", "chunk"))(jbuf, jcam, jmesh)
    got = tsharded.render_sharded(tbuf, tcam, tmesh)
    assert int(got[4]) == 0
    assert_images(got[:3], ref[:3])
    single = render(tbuf, tcam)
    assert_images(got[:3], port_images(single), atol=(1e-6,) * 3)
    np.testing.assert_array_equal(got[3].numpy(), single.radii.numpy())


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_render_sharded_tiled_matches_jax_and_unsharded(n_devices):
    """The tiled row-sharded render at 64x128, k=128, against JAX's with the
    Pallas blend (interpret mode under shard_map) and against the port's
    unsharded render; `dropped` is the sum over the shards, the JAX psum."""
    jbuf, tbuf, jcam, tcam = scene(1, 150, 64, 128)
    jmesh, tmesh = meshes(n_devices)
    ref = jax.jit(jsharded.render_sharded_tiled,
                  static_argnames=("mesh", "k_per_tile", "backend"))(
        jbuf, jcam, jmesh, k_per_tile=128, backend="pallas")
    got = tsharded.render_sharded_tiled(tbuf, tcam, tmesh, k_per_tile=128)
    assert_images(got[:3], ref[:3])
    assert int(got[4]) == int(ref[4])
    single = render(tbuf, tcam, k_per_tile=128)
    assert_images(got[:3], port_images(single), atol=(1e-6,) * 3)
    assert int(got[4]) >= int(single.dropped)
    np.testing.assert_array_equal(got[3].numpy(), single.radii.numpy())
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def grads_of(fn, params):
    params = params.map(lambda p: p.detach().requires_grad_(True))
    loss, aux = fn(params)
    return loss.detach(), aux, torch.autograd.grad(loss, params.tensors())


@pytest.mark.parametrize("mode", ["off", "on", "hybrid"])
def test_sharded_mapping_loss_matches_jax_and_unsharded(mode):
    """tests/test_parallel.py:216-250 at a truncating k=16 over 8 shards of
    one tile row: value and the five gradients against JAX's
    sharded_mapping_loss and against the port's mapping_loss. "hybrid"
    trains through each shard's CSR walk on the mesh, as in the JAX
    package, so its sharded loss is the exact one, which the unsharded
    hybrid equals."""
    jbuf, tbuf, jcam, tcam = scene(2, 150, 64, 128, logit_opacity=-2.0)
    jmesh, tmesh = meshes(8)
    rng = np.random.default_rng(3)
    im = rng.uniform(0, 1, (128, 64, 3)).astype(np.float32)
    dep = rng.uniform(1.0, 3.0, (128, 64)).astype(np.float32)
    kw = dict(chunk=64, k_per_tile=16, exact_training=mode)
    jcfg, tcfg = JaxConfig(**kw), MapperConfig(**kw)

    def jax_loss(params):
        return jsharded.sharded_mapping_loss(params, jbuf, jcam, jnp.asarray(im),
                                             jnp.asarray(dep), jcfg, jmesh)[0]

    v_j, g_j = jax.jit(jax.value_and_grad(jax_loss))(jbuf.params)
    v_m, aux_m, g_m = grads_of(lambda p: tsharded.sharded_mapping_loss(
        p, tbuf, tcam, t(im), t(dep), tcfg, tmesh), tbuf.params)
    v_s, aux_s, g_s = grads_of(lambda p: tstep.mapping_loss(
        p, tbuf, tcam, t(im), t(dep), tcfg), tbuf.params)
    np.testing.assert_allclose(float(v_m), float(v_j), rtol=1e-5)
    np.testing.assert_allclose(float(v_m), float(v_s), rtol=1e-5)
    for f, gj, gm, gs in zip(FIELDS, jax.tree.leaves(g_j), g_m, g_s):
        gj = np.asarray(gj)
        scale = max(np.abs(gj).max(), 1e-6)
        np.testing.assert_allclose(gm.numpy() / scale, gj / scale, atol=1e-4, err_msg=f)
        np.testing.assert_allclose(gm.numpy() / scale, gs.numpy() / scale, atol=1e-5, err_msg=f)
    for name in ("rgb_l1", "depth_l1", "ssim", "psnr"):
        np.testing.assert_allclose(float(getattr(aux_m, name)), float(getattr(aux_s, name)),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(aux_m.radii.numpy(), aux_s.radii.numpy())
    if mode == "off":
        assert int(aux_m.dropped) > 0  # the cap bites
    else:
        assert int(aux_m.dropped) == 0


def test_sharded_mapping_step_lowers_the_loss():
    """tests/test_parallel.py:44-59: 30 steps of a photometric fit on the
    dense path (4-row shards); the first step's metrics equal the unsharded
    mapping_iteration's."""
    _, tbuf, _, tcam = scene(4, 100, 64, 32)
    _, tmesh = meshes(8)
    cfg = MapperConfig(chunk=64)
    im = torch.full((32, 64, 3), 0.25)
    dep = torch.zeros((32, 64))
    opt = tstep.AdamState.init(tbuf.params)
    _, _, single = tstep.mapping_iteration(tbuf, opt, tcam, im, dep, cfg)
    buf, losses = tbuf, []
    for i in range(30):
        buf, opt, m = tsharded.sharded_mapping_step(buf, opt, tcam, im, dep, cfg, tmesh)
        if i == 0:
            for name in ("loss", "psnr", "depth_l1"):
                np.testing.assert_allclose(float(m[name]), float(single[name]), rtol=1e-6)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, (losses[0], losses[-1])


def test_mapping_phase_on_mesh_matches_jax_and_unsharded():
    """One mapping event of 4 iterations on a store with no committed
    keyframe (the window is the current frame, so no draw decides anything)
    at 64x48 over 3 shards of one tile row: the JAX mesh event, the port's
    mesh event and the port's unsharded event. The mesh asks for no
    gradient tap: with use_gs_densification it is refused."""
    d, rgb, depth = slice_scene(seed=6)
    jcam, tcam = cameras()
    jbuf, tbuf = numpy_to_jax(d), buffer_from_numpy(d, device="cpu")
    assert_no_tile_saturates(tbuf, tcam, 64)
    jmesh, tmesh = meshes(3)
    kw = dict(k_per_tile=64, exact_training="off", chunk=64, mapping_window_size=4,
              kf_select_pixels=64)
    jcfg, tcfg = JaxConfig(**kw), MapperConfig(**kw)
    w2c = np.linalg.inv(camera_pose()).astype(np.float32)
    jbuf, _, jm = jstep.mapping_phase(
        jbuf, JaxStore.empty(4, 48, 64), jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(w2c),
        jnp.int32(0), jcam, jax.random.PRNGKey(0), jcfg, 4, mesh=jmesh,
    )
    runs = {}
    for name, mesh in (("mesh", tmesh), ("single", None)):
        runs[name] = tstep.mapping_phase(
            tbuf, KeyframeStore.empty(4, 48, 64, device="cpu"), t(rgb), t(depth), t(w2c), 0,
            tcam, torch.Generator().manual_seed(0), tcfg, 4, mesh=mesh,
        )
    (mbuf, _, mm), (sbuf, _, sm) = runs["mesh"], runs["single"]
    assert int(mm["num_window"]) == int(jm["num_window"]) == 1
    for name in ("loss", "psnr", "depth_l1", "rgb_l1", "ssim", "packed"):
        np.testing.assert_allclose(mm[name].numpy(), np.asarray(jm[name]), rtol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(mm[name].numpy(), sm[name].numpy(), rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(mm["dropped"].numpy(), np.asarray(jm["dropped"]))
    assert_buffers_close(buffer_to_numpy(mbuf), jax_to_numpy(jbuf), rtol=1e-5, atol=2e-6)
    assert_buffers_close(buffer_to_numpy(mbuf), buffer_to_numpy(sbuf), rtol=1e-5, atol=2e-6)
    with pytest.raises(ValueError, match="single-device"):
        tstep.mapping_phase(
            tbuf, KeyframeStore.empty(4, 48, 64, device="cpu"), t(rgb), t(depth), t(w2c), 0,
            tcam, torch.Generator().manual_seed(0),
            dataclasses.replace(tcfg, use_gs_densification=True), 1, mesh=tmesh,
        )


def test_densify_phase_on_mesh_matches_unsharded():
    """Densification of a frame the map partly explains, at 64x48 over 3
    shards: the silhouette's multi-pass walk on the mesh inserts the same
    Gaussians as the unsharded exact render."""
    d, rgb, depth = slice_scene(seed=7, n=150, capacity=4096)
    _, tcam = cameras()
    tbuf = buffer_from_numpy(d, device="cpu")
    cfg = MapperConfig(k_per_tile=64, chunk=64)
    _, tmesh = meshes(3)
    out = {}
    for name, mesh in (("mesh", tmesh), ("single", None)):
        out[name] = tstep.densify_phase(tbuf, tcam, t(rgb), t(depth), 1.0, cfg, mesh=mesh)
    (mbuf, mdrop, mnew), (sbuf, sdrop, snew) = out["mesh"], out["single"]
    assert int(mnew) == int(snew) > 0 and int(mdrop) == int(sdrop) == 0
    assert_buffers_close(buffer_to_numpy(mbuf), buffer_to_numpy(sbuf), rtol=1e-6, atol=1e-7)


def mapper_run(mesh=None, use_mesh=False, frames=5, res=64):
    """SplaTAMMapper over BoxWorld frames, as tests/test_parallel.py:124-168."""
    fx = 0.5 * res / np.tan(np.deg2rad(45.0))
    intr = np.array([[fx, 0, res / 2 - 1], [0, fx, res / 2 - 1], [0, 0, 1]])
    world = BoxWorld.single_room(seed=2)
    cfg = MapperConfig(
        initial_capacity=1 << 12, max_capacity=1 << 13, keyframe_capacity=16, map_every=2,
        kf_every=2, mapping_iters=4, mapping_window_size=4, chunk=128, kf_select_pixels=128,
        k_per_tile=128, use_mesh=use_mesh,
    )
    mapper = SplaTAMMapper(cfg, res, res, intr, step_num=8, device="cpu", mesh=mesh)
    for i in range(frames):
        c2w = np.eye(4)
        c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
        c2w[:3, 3] = [3.0 + 0.1 * i, 1.25, 3.0]
        rgb, depth = world.render(c2w, intr, res, res)
        mapper.run({"frame_id": i, "rgb": rgb, "depth": depth, "c2w": c2w})
    return mapper


def test_mapper_on_mesh_matches_unsharded(capsys):
    """Five frames (first-frame init, densify, keyframe commits, mapping
    events with keyframes drawn from one seed) at 64x64 on a 4-shard mesh
    against the unsharded mapper: the same Gaussians, parameters within
    1e-4, the last metrics within 1e-4 relative. use_mesh on the CPU finds
    one device and says that it renders unsharded."""
    _, tmesh = meshes(4)
    meshed = mapper_run(mesh=tmesh)
    assert "mapper: sharding renders over 4 devices (16 rows each)" in capsys.readouterr().out
    assert meshed.mesh == tmesh and meshed._densify_mesh.px == 4
    single = mapper_run()
    assert single.mesh is None
    assert meshed.num_gaussians() == single.num_gaussians()
    np.testing.assert_allclose(meshed.buf.params.means3d.numpy(),
                               single.buf.params.means3d.numpy(), atol=1e-4)
    for name in ("loss", "psnr", "depth_l1", "rgb_l1", "ssim"):
        np.testing.assert_allclose(meshed.last_metrics[name], single.last_metrics[name],
                                   rtol=1e-4, err_msg=name)
    assert meshed.last_metrics["dropped"] == single.last_metrics["dropped"]
    flagged = mapper_run(use_mesh=True, frames=1)
    assert flagged.mesh is None
    assert "rendering unsharded" in capsys.readouterr().out


@pytest.fixture(scope="module")
def jax_exact_views():
    """The JAX views through the exact CSR render (Pallas, interpret mode),
    as tests/test_torch_queries.py takes them."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys.modules["activesplat_tpu.ops.render"], "forward_backend", lambda: "pallas")
        for fn in (jpano._render_views, jpano._render_views_quantized):
            fn.clear_cache()
        yield
        for fn in (jpano._render_views, jpano._render_views_quantized):
            fn.clear_cache()


def pano_buffer():
    """A half-cylinder of splats around the camera (tests/test_queries.py's
    hole scene, thinned), the back hemisphere a hole."""
    rng = np.random.default_rng(5)
    n = 3000
    az = rng.uniform(-np.pi / 2, np.pi / 2, n)
    y = rng.uniform(-2.0, 2.0, n)
    center = np.array([3.0, 1.25, 3.0])
    pts = center + np.stack([2.0 * np.sin(az), y, -2.0 * np.cos(az)], axis=-1)
    from tests.test_queries import buffer_from_points

    return buffer_from_points(pts, scale=0.15), center


def test_panorama_queries_on_mesh(jax_exact_views, monkeypatch):
    """global_invisibility (two nodes and a skipped one, 6 views over 4
    shards: blocks of 2, 2, 1, 1) and local_invisibility (3 views over 4
    shards, one block empty) at scale 0.4: equal to the unsharded queries
    bitwise, and to the JAX mesh query (3 devices, the views padded to 12)
    but for quantized inputs on a rounding boundary. The local query's views
    are the first node's, so its panorama is held against those."""
    jbuf, center = pano_buffer()
    tbuf = port_buffer(jbuf)
    c2w = pose(center)
    nodes = np.array([center, [0.0, 0.0, 0.0], center + [0.5, 0.0, -0.3]])
    jmesh, _ = meshes(3)
    _, tmesh = meshes(4)
    seen, jseen = [], []
    real, jreal = tpano._render_views_quantized, jpano._render_views_quantized
    monkeypatch.setattr(tpano, "_render_views_quantized",
                        lambda *a: seen.append(real(*a)) or seen[-1])
    monkeypatch.setattr(jpano, "_render_views_quantized",
                        lambda *a: jseen.append(jreal(*a)) or jseen[-1])
    got = tpano.global_invisibility(tbuf, c2w, nodes, chunk=64, scale=0.4, mesh=tmesh)
    single = tpano.global_invisibility(tbuf, c2w, nodes, chunk=64, scale=0.4)
    assert got == single and got[1] == (0.0, 0.0, 0.0) and got[0][1] > 0
    for m, s_ in zip(*seen):
        np.testing.assert_array_equal(m.numpy(), s_.numpy())
    ref = jpano.global_invisibility(jbuf, c2w, nodes, chunk=64, scale=0.4, mesh=jmesh)
    keep = [0, 1, 2, 6, 7, 8]  # JAX renders the skipped node's views too
    ref_q = [np.asarray(x)[keep] for x in jseen[0]]

    # the quantized inputs, port against JAX
    poses = np.concatenate([tpano.pano_view_poses(node_c2w(c2w, nodes[i])) for i in (0, 2)])
    _, depth, alpha = tpano._render_views(tbuf, poses, 64, 0.4)
    n_edge = 0
    for g, r, f, unit in zip(seen[0], ref_q, (depth, alpha), (1000.0, 255.0)):
        g, r = g.numpy().astype(np.int64), r.astype(np.int64)
        edge = np.abs((f.numpy().astype(np.float64) * unit) % 1.0 - 0.5) < 1e-5 * unit
        assert not ((g != r) & ~edge).any() and (np.abs(g - r) <= 1).all()
        n_edge += int((g != r).sum())
    for g, r in zip(got, ref):
        assert g[2] == r[2]
        if n_edge == 0:
            np.testing.assert_allclose(g[:2], r[:2], rtol=1e-6)

    l_got = tpano.local_invisibility(tbuf, c2w, chunk=64, scale=0.4, mesh=tmesh)
    l_single = tpano.local_invisibility(tbuf, c2w, chunk=64, scale=0.4)
    assert l_got[0] == l_single[0]
    np.testing.assert_array_equal(l_got[2], l_single[2])
    assert (l_got[1] is None) == (l_single[1] is None)
    if l_got[1] is not None:
        np.testing.assert_array_equal(l_got[1], l_single[1])
    ref_invis = 1.0 - np.concatenate(ref_q[1][:3], axis=1) / 255.0
    assert np.abs(l_got[2] - ref_invis).max() <= 1.0 / 255.0 + 1e-12
    if n_edge == 0:
        np.testing.assert_array_equal(l_got[2], ref_invis)
