"""The port's raster modules against the JAX package on the same numpy
inputs: projection, the packed depth sort, tile binning, the k-capped tiled
rasterizer (JAX side through its Pallas blend in interpret mode), the dense
rasterizer and the render entry point."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activesplat_tpu.models.gaussians import GaussianBuffer as JaxBuffer
from activesplat_tpu.models.gaussians import make_camera as jax_make_camera
from activesplat_tpu.ops import projection as jproj
from activesplat_tpu.ops import raster_tiled as jtiled
from activesplat_tpu.ops.raster_xla import depth_sort as jax_depth_sort
from activesplat_tpu.ops.raster_xla import rasterize_sorted as jax_rasterize_sorted
from activesplat_tpu.ops.render import render as jax_render
from activesplat_tpu.utils import transforms as jtransforms
from activesplat_tpu_torch.convert import buffer_from_numpy
from activesplat_tpu_torch.models.gaussians import make_camera
from activesplat_tpu_torch.ops import projection as tproj
from activesplat_tpu_torch.ops import raster_tiled as ttiled
from activesplat_tpu_torch.ops.raster_cuda import LOG_EPS, blend_tiles_fwd
from activesplat_tpu_torch.ops.raster_xla import depth_sort, rasterize_sorted
from activesplat_tpu_torch.ops.render import render
from activesplat_tpu_torch.utils import transforms as ttransforms
from tests.reference_impl import random_scene

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

W, H = 64, 48
FX = FY = 40.0
CX, CY = W / 2 - 1, H / 2 - 1
INTR = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]])


def scene(seed, n=300, **kw):
    s = random_scene(np.random.default_rng(seed), n, **kw)
    # distinct depths: the reference's depth sort is not stable, so ties
    # could order differently on the two sides
    s["means3d"][:, 2] += np.arange(n, dtype=np.float32) * 1e-4
    return s


def t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def project_both(s):
    args = (s["means3d"], s["quats"], s["log_scales"], s["active"])
    ref = jax.jit(jproj.project_gaussians, static_argnames=("width", "height"))(
        *map(jnp.asarray, args), jnp.eye(4), FX, FY, CX, CY, width=W, height=H
    )
    scalar = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    got = tproj.project_gaussians(
        *map(t, args), torch.eye(4), scalar(FX), scalar(FY), scalar(CX), scalar(CY), W, H
    )
    return ref, got


def test_transforms_match_jax():
    """quat_to_rotmat on unnormalized quaternions (float32 rounding, 1e-6)
    and rot_axis, which is the same float64 numpy on both sides."""
    rng = np.random.default_rng(20)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    np.testing.assert_allclose(
        ttransforms.quat_to_rotmat(t(q)).numpy(),
        np.asarray(jtransforms.quat_to_rotmat(jnp.asarray(q))), rtol=1e-6, atol=1e-6,
    )
    pose = np.eye(4)
    pose[:3, 3] = rng.normal(size=3)
    for axis in "xyz":
        np.testing.assert_array_equal(
            ttransforms.rot_axis(pose, axis, 0.3), jtransforms.rot_axis(pose, axis, 0.3)
        )


def test_project_gaussians_matches_jax():
    """Tolerance: the same float32 expressions in the same order; 1e-5
    relative covers the libm/XLA difference in exp and sqrt."""
    ref, got = project_both(scene(0))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.radius.numpy(), np.asarray(ref.radius))
    for name in ("mean2d", "conic", "depth"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=1e-5, atol=1e-5
        )


def test_project_gaussians_gradients_match_jax():
    """Gradients of one scalar of the projection's outputs. Tolerance 1e-4
    relative to each gradient's scale: float32 chains of ~30 operations."""
    s = scene(1)
    rng = np.random.default_rng(2)
    w_mean, w_conic, w_depth = (
        rng.normal(size=shape).astype(np.float32) for shape in ((300, 2), (300, 3), (300,))
    )

    def jax_scalar(means3d, quats, log_scales):
        p = jproj.project_gaussians(
            means3d, quats, log_scales, jnp.asarray(s["active"]), jnp.eye(4),
            FX, FY, CX, CY, W, H,
        )
        v = p.valid
        return (
            jnp.sum(jnp.where(v[:, None], p.mean2d * w_mean, 0.0))
            + jnp.sum(jnp.where(v[:, None], p.conic * w_conic, 0.0))
            + jnp.sum(p.depth * w_depth)
        )

    ref = jax.jit(jax.grad(jax_scalar, argnums=(0, 1, 2)))(
        *(jnp.asarray(s[k]) for k in ("means3d", "quats", "log_scales"))
    )
    leaves = [t(s[k], grad=True) for k in ("means3d", "quats", "log_scales")]
    scalar = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    p = tproj.project_gaussians(
        *leaves, t(s["active"]), torch.eye(4), scalar(FX), scalar(FY), scalar(CX), scalar(CY), W, H
    )
    v = p.valid[:, None]
    total = (
        torch.where(v, p.mean2d * t(w_mean), 0.0).sum()
        + torch.where(v, p.conic * t(w_conic), 0.0).sum()
        + (p.depth * t(w_depth)).sum()
    )
    got = torch.autograd.grad(total, leaves)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4 * np.abs(r).max())


def test_adaptive_cull_radius_matches_jax():
    ref, got = project_both(scene(3))
    opac = 1.0 / (1.0 + np.exp(-np.linspace(-7.0, 4.0, 300, dtype=np.float32)))
    r_ref, v_ref = jproj.adaptive_cull_radius(ref.radius, ref.valid, jnp.asarray(opac))
    r_got, v_got = tproj.adaptive_cull_radius(got.radius, got.valid, t(opac))
    np.testing.assert_array_equal(v_got.numpy(), np.asarray(v_ref))
    np.testing.assert_allclose(r_got.numpy(), np.asarray(r_ref), rtol=1e-6, atol=1e-5)


def tiled_inputs(seed, n=300, wall=0, **kw):
    """Projected inputs of the tiled rasterizer, as numpy arrays. `wall`
    adds that many opaque, wide Gaussians in front of the frame's centre,
    enough to saturate the central tiles within one segment."""
    s = scene(seed, n, **kw)
    if wall:
        rng = np.random.default_rng(seed + 100)
        w = {
            "means3d": np.column_stack(
                [rng.uniform(-0.3, 0.3, wall), rng.uniform(-0.2, 0.2, wall),
                 np.linspace(1.0, 1.4, wall)]
            ),
            "rgb": rng.uniform(0, 1, (wall, 3)),
            "quats": np.tile([1.0, 0.0, 0.0, 0.0], (wall, 1)),
            "logit_opacities": np.full(wall, 4.0),
            "log_scales": np.full((wall, 3), np.log(0.25)),
            "active": np.ones(wall, bool),
        }
        s = {k: np.concatenate([w[k], s[k]]).astype(s[k].dtype) for k in s}
    ref, _ = project_both(s)
    opac = 1.0 / (1.0 + np.exp(-s["logit_opacities"]))
    z = np.asarray(ref.depth)
    colors = np.concatenate([s["rgb"], z[:, None], (z * z)[:, None]], -1)
    return {
        "mean2d": np.asarray(ref.mean2d), "conic": np.asarray(ref.conic),
        "opacity": opac.astype(np.float32), "colors": colors.astype(np.float32),
        "valid": np.asarray(ref.valid), "radius": np.asarray(ref.radius), "depth": z,
    }


def test_sort_pack_matches_jax():
    """Packed binning attributes and the order are exactly equal on depths
    without ties."""
    d = tiled_inputs(4)
    data = np.concatenate([d["mean2d"], d["conic"], d["opacity"][:, None], d["colors"]], -1)
    key = np.where(d["valid"], d["depth"], np.inf).astype(np.float32)
    p_ref, o_ref = jtiled._sort_pack(
        jnp.asarray(data), jnp.asarray(key), jnp.asarray(d["radius"]), jnp.asarray(d["valid"])
    )
    p_got, o_got = ttiled._sort_pack(t(data), t(key), t(d["radius"]), t(d["valid"]))
    np.testing.assert_array_equal(o_got.numpy(), np.asarray(o_ref))
    np.testing.assert_array_equal(p_got.numpy(), np.asarray(p_ref))


@pytest.mark.parametrize("k", [16, 64])
def test_bin_gaussians_matches_jax(k):
    """indices, count and overflow exactly equal, with tiles over the cap."""
    d = tiled_inputs(5, n=400)
    key = np.where(d["valid"], d["depth"], np.inf).astype(np.float32)
    order = np.argsort(key, kind="stable")
    mean2d, radius, valid = d["mean2d"][order], d["radius"][order], d["valid"][order]
    ref = jax.jit(jtiled.bin_gaussians, static_argnums=(3, 4, 5))(
        jnp.asarray(mean2d), jnp.asarray(radius), jnp.asarray(valid), W, H, k
    )
    got = ttiled.bin_gaussians(t(mean2d), t(radius), t(valid), W, H, k)
    assert int(np.asarray(ref.overflow).max()) > 0, "scene must overflow a tile"
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(ref.overflow))


def assert_clear_of_eps(d, k):
    """Both blends exit a tile early when its max logT at a segment start is
    below LOG_EPS; keep every segment start clear of that boundary, where
    the two may decide differently within rounding (test_pallas.py:53-55)."""
    rows, u0, v0, _ = ttiled.tile_rows(
        *(t(d[k_]) for k_ in ("mean2d", "conic", "opacity", "colors", "valid", "radius", "depth")),
        width=W, height=H, k_per_tile=k,
    )
    _, _, entry = blend_tiles_fwd(rows, u0, v0, 5, with_entry=True)
    seg_max = entry.amax(dim=2)
    if entry.shape[1] > 1:
        assert bool((seg_max < LOG_EPS).any()), "scene must skip a saturated segment"
    assert bool(((seg_max - LOG_EPS).abs() > 0.05).all())


@pytest.mark.parametrize("k", [32, 100])
def test_rasterize_tiled_matches_pallas(k):
    """Image, logT, dropped and the gradients of a scalar loss against the
    JAX tiled rasterizer with its Pallas blend (interpret mode). k=100 is
    not a SEG multiple (padded on both sides). Tolerance: float32 rounding
    of the in-segment prefix (1e-5 on the image) and of the gather's
    scatter-add in the backward (1e-4 of each gradient's scale)."""
    d = tiled_inputs(6, wall=100)
    names = ("mean2d", "conic", "opacity", "colors")
    rng = np.random.default_rng(7)
    w_img = rng.normal(size=(H * W, 5)).astype(np.float32)
    w_lt = rng.normal(size=(H * W,)).astype(np.float32)

    def jax_loss(mean2d, conic, opacity, colors):
        accum, logt, dropped = jtiled.rasterize_tiled(
            mean2d, conic, opacity, colors, jnp.asarray(d["valid"]),
            jnp.asarray(d["radius"]), jnp.asarray(d["depth"]),
            width=W, height=H, k_per_tile=k, backend="pallas",
        )
        return jnp.sum(accum * w_img) + jnp.sum(logt * w_lt), (accum, logt, dropped)

    (_, (acc_r, lt_r, drop_r)), grads_r = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True
    )(*(jnp.asarray(d[k_]) for k_ in names))

    leaves = [t(d[k_], grad=True) for k_ in names]
    acc, lt, drop = ttiled.rasterize_tiled(
        *leaves, t(d["valid"]), t(d["radius"]), t(d["depth"]),
        width=W, height=H, k_per_tile=k,
    )
    assert_clear_of_eps(d, k)
    grads = torch.autograd.grad((acc * t(w_img)).sum() + (lt * t(w_lt)).sum(), leaves)

    assert int(drop) == int(drop_r)
    if k == 32:
        assert int(drop) > 0
    np.testing.assert_allclose(acc.detach().numpy(), np.asarray(acc_r), atol=1e-5)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lt_r), rtol=1e-5, atol=1e-5)
    for g, r in zip(grads, grads_r):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4 * np.abs(r).max())


def test_rasterize_sorted_matches_jax():
    """The dense path: same chunked float32 algorithm (1e-5)."""
    d = tiled_inputs(8, n=200)
    arrays = [d[k] for k in ("mean2d", "conic", "opacity", "colors")]
    srt = jax_depth_sort(jnp.asarray(d["depth"]), jnp.asarray(d["valid"]), *map(jnp.asarray, arrays))
    acc_r, lt_r = jax_rasterize_sorted(*srt[2:], srt[1], width=W, height=H, chunk=64)
    srt_t = depth_sort(t(d["depth"]), t(d["valid"]), *map(t, arrays))
    acc, lt = rasterize_sorted(*srt_t[2:], srt_t[1], width=W, height=H, chunk=64)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_r), atol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lt_r), rtol=1e-5, atol=1e-5)


def scene_buffers(seed, n=250, capacity=512):
    s = scene(seed, n)
    d = {
        "means3d": s["means3d"], "rgb": s["rgb"], "quats": s["quats"],
        "logit_opacities": s["logit_opacities"], "log_scales": s["log_scales"],
    }
    d = {k: np.concatenate([v, np.repeat(v[:1] * 0, capacity - n, 0)], 0) for k, v in d.items()}
    d["quats"][n:, 0] = 1.0
    d["log_scales"][n:] = -10.0
    d["active"] = np.arange(capacity) < n
    for k in ("timestep", "max_radius", "grad_accum", "denom"):
        d[k] = np.zeros(capacity, np.float32)
    jbuf = JaxBuffer.empty(capacity)
    jbuf = jbuf.replace(
        params=jbuf.params.replace(**{k: jnp.asarray(d[k]) for k in (
            "means3d", "rgb", "quats", "logit_opacities", "log_scales")}),
        active=jnp.asarray(d["active"]),
    )
    return jbuf, buffer_from_numpy(d, device="cpu")


@pytest.mark.parametrize("k", [0, 64])
def test_render_matches_jax(k):
    """render(): the dense path (k=0) and the k-capped tiled path, whose
    JAX side blends with Pallas in interpret mode."""
    jbuf, tbuf = scene_buffers(9)
    ref = jax.jit(jax_render, static_argnames=("k_per_tile", "chunk", "backend"))(
        jbuf, jax_make_camera(W, H, INTR, np.eye(4)), k_per_tile=k, chunk=64, backend="pallas"
    )
    got = render(tbuf, make_camera(W, H, INTR, np.eye(4), device="cpu"), k_per_tile=k, chunk=64)
    for name in ("rgb", "depth", "depth_sq", "alpha"):
        np.testing.assert_allclose(
            getattr(got, name).detach().numpy(), np.asarray(getattr(ref, name)),
            rtol=1e-5, atol=2e-5,
        )
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(ref.radii))
    assert int(got.dropped) == int(ref.dropped)


def test_exact_renders_wait_for_a_later_slice():
    """No exact render waits for a later slice any more: the dual-
    transmittance walk (band=, kernel B5) runs, forward only, and with every
    band bit set its band output is its own log-transmittance
    (tests/test_torch_topdown.py holds it against JAX)."""
    d = tiled_inputs(10, n=100)
    args = [t(d[k]) for k in ("mean2d", "conic", "opacity", "colors", "valid", "radius", "depth")]
    band = torch.ones(100, dtype=torch.bool)
    accum, logt, logt_band, dropped = ttiled.rasterize_tiled_exact(*args, band, width=W, height=H)
    assert torch.equal(logt_band, logt) and dropped == 0
    with pytest.raises(ValueError, match="forward-only"):
        ttiled.rasterize_tiled_exact(*args, band, width=W, height=H, differentiable=True)
