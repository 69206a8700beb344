"""The port's exact renders against the JAX package on the same numpy inputs:
the CSR rasterizer (forward and differentiable), the hybrid, the multi-pass
k-window walk, the entry-budget fallbacks, render() and the mapping loss
with exact_training "on" and "hybrid". The JAX side runs its Pallas kernels
in interpret mode.

Tolerances, as for the k-capped path (test_torch_raster.py): image 1e-5
absolute, logT 1e-5 relative, each gradient 1e-4 of its scale; the two
sides sum the in-segment log prefix and the gather's backward scatter-add in
different orders."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activesplat_tpu.mapper import step as jstep
from activesplat_tpu.mapper.config import MapperConfig as JaxConfig
from activesplat_tpu.models import gaussians as jg
from activesplat_tpu.ops import raster_tiled as jtiled
from activesplat_tpu.ops.render import render as jax_render
from activesplat_tpu_torch.convert import buffer_from_numpy
from activesplat_tpu_torch.mapper import step as tstep
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.models.gaussians import make_camera
from activesplat_tpu_torch.ops import raster_cuda as rc
from activesplat_tpu_torch.ops import raster_tiled as ttiled
from activesplat_tpu_torch.ops import render as trender
from activesplat_tpu_torch.utils import tracing
from tests.test_torch_raster import INTR, H, W, scene_buffers, t, tiled_inputs

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

NAMES = ("mean2d", "conic", "opacity", "colors")
REST = ("valid", "radius", "depth")


def cluster_inputs(seed, opacity_scale=1.0):
    """300 Gaussians in a small patch in front of the camera: the central
    tiles hold more than CSEG members, so their CSR runs span two
    segments. opacity_scale < 1 keeps every tile translucent."""
    d = tiled_inputs(seed, n=300, spread=0.3, z_range=(2.0, 3.0), scale_range=(-2.6, -2.1))
    d["opacity"] = (d["opacity"] * opacity_scale).astype(np.float32)
    return d


def port_layout(d):
    data, packed, order, b = ttiled._prepare(*(t(d[k]) for k in NAMES + REST))
    return ttiled._csr_layout(packed[:b], order, data.shape[0], -(-W // 16), -(-H // 16)), data


def assert_csr_clear_of_eps(d):
    """Multi-segment runs, and every segment start's max logT clear of
    LOG_EPS, where the two sides may decide the early exit differently
    within rounding (test_pallas.py:53-55)."""
    layout, data = port_layout(d)
    assert int(torch.bincount(layout.seg_tile).max()) >= 2, "a tile must span two segments"
    rows = torch.nn.functional.pad(ttiled._pad_table(data)[layout.global_ids], (0, 16 - data.shape[1]))
    _, _, entry = rc.blend_csr_fwd(rows, layout.seg_tile, layout.seg_u0, layout.seg_v0,
                                   12, 5, with_entry=True)
    assert bool(((entry.amax(dim=1) - rc.LOG_EPS).abs() > 0.05).all())


def weights(seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(H * W, 5)).astype(np.float32), rng.normal(size=(H * W,)).astype(np.float32)


def jax_value_and_grads(fn, d, w_img, w_lt):
    """fn(mean2d, conic, opacity, colors) -> (accum, logt, ...): outputs and
    the gradients of sum(accum w_img) + sum(logt w_lt)."""

    def loss(*x):
        out = fn(*x)
        return jnp.sum(out[0] * w_img) + jnp.sum(out[1] * w_lt), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(d[k]) for k in NAMES)
    )
    return out, grads


def port_value_and_grads(fn, d, w_img, w_lt):
    leaves = [t(d[k], grad=True) for k in NAMES]
    out = fn(*leaves)
    grads = torch.autograd.grad((out[0] * t(w_img)).sum() + (out[1] * t(w_lt)).sum(), leaves)
    return out, grads


def assert_images_close(got, ref):
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(ref[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].detach().numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-5)


def assert_grads_close(got, ref):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4 * np.abs(r).max())


@pytest.mark.parametrize("case", ["translucent", "saturating"])
@pytest.mark.parametrize("differentiable", [False, True])
def test_rasterize_tiled_exact_matches_jax(case, differentiable):
    """Image, logT and dropped, and with differentiable=True the gradients
    of the four attribute groups, against the JAX CSR rasterizer. The
    saturating cluster exits its central tiles in their first segment."""
    d = cluster_inputs(30, opacity_scale=0.05 if case == "translucent" else 1.0)
    assert_csr_clear_of_eps(d)
    w_img, w_lt = weights(31)
    rest = [d[k] for k in REST]

    def jax_fn(*x):
        return jtiled.rasterize_tiled_exact(
            *x, *map(jnp.asarray, rest), width=W, height=H, interpret=True,
            differentiable=differentiable,
        )

    def port_fn(*x):
        return ttiled.rasterize_tiled_exact(
            *x, *map(t, rest), width=W, height=H, differentiable=differentiable
        )

    if differentiable:
        ref, grads_r = jax_value_and_grads(jax_fn, d, w_img, w_lt)
        got, grads = port_value_and_grads(port_fn, d, w_img, w_lt)
        assert_grads_close(grads, grads_r)
    else:
        ref = jax_fn(*(jnp.asarray(d[k]) for k in NAMES))
        got = port_fn(*(t(d[k], grad=True) for k in NAMES))
        assert not got[0].requires_grad
    assert_images_close(got, ref)
    assert got[2] == int(ref[2]) == 0


@pytest.mark.parametrize("k", [8, 128])
def test_hybrid_matches_jax(k):
    """k=8 truncates harmfully: the hybrid recomposites those tiles with the
    CSR blend; image, logT, dropped, csr_overflow and gradients against the
    JAX hybrid with its Pallas blends. k=128 overflows no tile: the hybrid is
    exactly the capped render and launches no CSR blend."""
    d = tiled_inputs(32, n=200, wall=0)  # at most 106 members per tile
    d["opacity"] = (d["opacity"] * 0.3).astype(np.float32)
    w_img, w_lt = weights(33)
    rest = [d[kk] for kk in REST]
    ref, grads_r = jax_value_and_grads(
        lambda *x: jtiled.rasterize_tiled_hybrid(
            *x, *map(jnp.asarray, rest), width=W, height=H, k_per_tile=k, backend="pallas"
        ),
        d, w_img, w_lt,
    )
    calls, harmful = tracing.counter("hybrid.calls"), tracing.counter("hybrid.harmful_tiles")
    got, grads = port_value_and_grads(
        lambda *x: ttiled.rasterize_tiled_hybrid(*x, *map(t, rest), width=W, height=H, k_per_tile=k),
        d, w_img, w_lt,
    )
    n_harm = tracing.counter("hybrid.harmful_tiles") - harmful
    assert tracing.counter("hybrid.calls") == calls + 1
    assert_images_close(got, ref)
    assert_grads_close(grads, grads_r)
    assert int(got[2]) == int(ref[2]) and got[3] == int(ref[3]) == 0
    if k == 8:
        assert n_harm > 0 and int(got[2]) > 0
    else:
        assert n_harm == 0 and int(got[2]) == 0
        capped = ttiled.rasterize_tiled(
            *(t(d[kk]) for kk in NAMES + REST), width=W, height=H, k_per_tile=k
        )
        assert torch.equal(got[0], capped[0]) and torch.equal(got[1], capped[1])


def test_multipass_rasterize_tiled_matches_jax():
    """max_passes > 1 folds farther k-windows in: against the JAX multi-pass
    walk with the Pallas blend, and against the exact CSR render."""
    d = cluster_inputs(34, opacity_scale=0.05)
    args = [d[k] for k in NAMES + REST]
    ref = jtiled.rasterize_tiled(
        *map(jnp.asarray, args), width=W, height=H, k_per_tile=16, backend="pallas",
        max_passes=19,
    )
    got = ttiled.rasterize_tiled(*map(t, args), width=W, height=H, k_per_tile=16, max_passes=19)
    one = ttiled.rasterize_tiled(*map(t, args), width=W, height=H, k_per_tile=16)
    assert int(one[2]) > 0  # one window truncates
    assert_images_close(got, ref)
    assert int(got[2]) == int(ref[2]) == 0
    exact = ttiled.rasterize_tiled_exact(*map(t, args), width=W, height=H)
    np.testing.assert_allclose(got[0].numpy(), exact[0].numpy(), atol=1e-5)


def test_budget_overflow_fallbacks(monkeypatch):
    """With the port's entry cap patched below what the scene needs: the
    exact rasterizer drops as many memberships as the JAX one at the same
    budget; render(exact=True) takes the multi-pass walk and still matches
    the uncapped image; the hybrid degrades to the k-capped render."""
    d = cluster_inputs(35, opacity_scale=0.05)
    args = [d[k] for k in NAMES + REST]
    full = ttiled.rasterize_tiled_exact(*map(t, args), width=W, height=H)
    assert full[2] == 0
    monkeypatch.setattr(ttiled, "_ENTRY_CAP", 512)
    ref = jtiled.rasterize_tiled_exact(
        *map(jnp.asarray, args), width=W, height=H, entry_budget=512, interpret=True
    )
    got = ttiled.rasterize_tiled_exact(*map(t, args), width=W, height=H)
    assert got[2] == int(ref[2]) > 0
    assert_images_close(got, ref)

    seen = []
    real = trender.rasterize_tiled

    def recording(*a, **kw):
        seen.append(kw.get("max_passes", 1))
        return real(*a, **kw)

    monkeypatch.setattr(trender, "rasterize_tiled", recording)
    _, tbuf = scene_buffers(36, n=250)
    cam = make_camera(W, H, INTR, np.eye(4), device="cpu")
    out = trender.render(tbuf, cam, k_per_tile=16, exact=True)
    assert seen and seen[-1] > 1
    monkeypatch.setattr(ttiled, "_ENTRY_CAP", 1 << 23)
    uncapped = trender.render(tbuf, cam, k_per_tile=16, exact=True)
    np.testing.assert_allclose(out.rgb.numpy(), uncapped.rgb.numpy(), atol=1e-5)
    assert int(out.dropped) == 0

    monkeypatch.setattr(ttiled, "_ENTRY_CAP", 512)
    hybrid = ttiled.rasterize_tiled_hybrid(*map(t, args), width=W, height=H, k_per_tile=8)
    capped = ttiled.rasterize_tiled(*map(t, args), width=W, height=H, k_per_tile=8)
    assert hybrid[3] > 0
    assert torch.equal(hybrid[0], capped[0]) and int(hybrid[2]) == int(capped[2]) > 0
    monkeypatch.setattr(jtiled, "_ENTRY_CAP", 512)
    ref_h = jtiled.rasterize_tiled_hybrid(
        *map(jnp.asarray, args), width=W, height=H, k_per_tile=8, backend="pallas",
        ladder=(0.25,),
    )
    assert hybrid[3] == int(ref_h[3])


@pytest.mark.parametrize("mode", ["exact", "grad_exact", "hybrid"])
def test_render_exact_modes_match_jax(mode):
    """render() with exact=True, grad_exact=True and grad_exact="hybrid"
    against the JAX render (Pallas blends) at a truncating k."""
    kw = {"exact": {"exact": True}, "grad_exact": {"grad_exact": True},
          "hybrid": {"grad_exact": "hybrid"}}[mode]
    jbuf, tbuf = scene_buffers(37)
    ref = jax.jit(jax_render, static_argnames=("k_per_tile", "backend", "exact", "grad_exact"))(
        jbuf, jg.make_camera(W, H, INTR, np.eye(4)), k_per_tile=16, backend="pallas", **kw
    )
    got = trender.render(tbuf, make_camera(W, H, INTR, np.eye(4), device="cpu"), k_per_tile=16, **kw)
    for name in ("rgb", "depth", "depth_sq", "alpha"):
        np.testing.assert_allclose(
            getattr(got, name).detach().numpy(), np.asarray(getattr(ref, name)),
            rtol=1e-5, atol=2e-5, err_msg=name,
        )
    assert int(got.dropped) == int(ref.dropped)
    capped = trender.render(tbuf, make_camera(W, H, INTR, np.eye(4), device="cpu"), k_per_tile=16)
    assert int(capped.dropped) > 0  # the cap bites in this scene


def cluster_buffer(seed, n=300, capacity=512):
    """tests/test_overflow.py's dense cluster at 300 Gaussians: translucent
    splats in a 1 m patch 2 m in front of the camera, hundreds per central
    tile, none saturating."""
    rng = np.random.default_rng(seed)
    d = {k: np.zeros(s, np.float32) for k, s in (
        ("means3d", (capacity, 3)), ("rgb", (capacity, 3)), ("quats", (capacity, 4)),
        ("logit_opacities", (capacity,)), ("log_scales", (capacity, 3)),
        ("timestep", (capacity,)), ("max_radius", (capacity,)), ("grad_accum", (capacity,)),
        ("denom", (capacity,)))}
    d["quats"][:, 0] = 1.0
    d["log_scales"][:] = -10.0
    d["means3d"][:n] = np.column_stack(
        [rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
         1.8 + 0.8 * np.arange(n) / n]  # a depth ramp: no ties
    )
    d["rgb"][:n] = rng.uniform(0, 1, (n, 3))
    d["quats"][:n] = rng.normal(size=(n, 4))
    d["logit_opacities"][:n] = -3.0
    # anisotropic, so that the rotations carry a gradient
    d["log_scales"][:n] = np.log(rng.uniform(0.05, 0.11, (n, 3)))
    d["active"] = np.arange(capacity) < n
    jbuf = jg.GaussianBuffer(
        params=jg.GaussianParams(*(jnp.asarray(d[f]) for f in (
            "means3d", "rgb", "quats", "logit_opacities", "log_scales"))),
        active=jnp.asarray(d["active"]),
        **{f: jnp.asarray(d[f]) for f in ("timestep", "max_radius", "grad_accum", "denom")},
    )
    return jbuf, buffer_from_numpy(d, device="cpu")


@pytest.mark.parametrize("mode", ["on", "hybrid"])
def test_mapping_loss_exact_training_matches_jax(mode):
    """mapping_loss with exact_training "on" and "hybrid" at a truncating k:
    value and the five parameter gradients against the JAX mapping loss
    (mirrors tests/test_exact_grad.py:136-167 and tests/test_hybrid.py:
    208-238), and, as there, equal to the uncapped loss; the k-capped
    gradient is off by more than 10% of its scale."""
    jbuf, tbuf = cluster_buffer(38)
    rng = np.random.default_rng(39)
    im = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    dep = rng.uniform(1.5, 3.0, (H, W)).astype(np.float32)
    jcam = jg.make_camera(W, H, INTR, np.eye(4))
    tcam = make_camera(W, H, INTR, np.eye(4), device="cpu")
    cfg = dict(chunk=64, k_per_tile=16, exact_training=mode)
    loss_fn = jax.jit(jax.value_and_grad(jstep.mapping_loss, has_aux=True), static_argnames=("cfg",))
    (loss_r, aux_r), grads_r = loss_fn(
        jbuf.params, jbuf, jcam, jnp.asarray(im), jnp.asarray(dep), cfg=JaxConfig(**cfg)
    )
    loss, aux, grads = tstep.loss_and_grads(tbuf, tcam, t(im), t(dep), MapperConfig(**cfg))
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-5)
    assert int(aux.dropped) == int(aux_r.dropped)
    for f in ("means3d", "rgb", "quats", "logit_opacities", "log_scales"):
        r = np.asarray(getattr(grads_r, f))
        np.testing.assert_allclose(getattr(grads, f).numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=f)

    uncapped = dataclasses.replace(MapperConfig(**cfg), k_per_tile=512, exact_training="off")
    loss_u, _, grads_u = tstep.loss_and_grads(tbuf, tcam, t(im), t(dep), uncapped)
    capped = dataclasses.replace(MapperConfig(**cfg), exact_training="off")
    _, aux_c, grads_c = tstep.loss_and_grads(tbuf, tcam, t(im), t(dep), capped)
    np.testing.assert_allclose(float(loss), float(loss_u), rtol=1e-5)
    g, g_u, g_c = (x.logit_opacities.numpy() for x in (grads, grads_u, grads_c))
    scale = np.abs(g_u).max()
    np.testing.assert_allclose(g / scale, g_u / scale, atol=1e-4)
    assert int(aux_c.dropped) > 0 and np.abs(g_c - g_u).max() / scale > 0.1
