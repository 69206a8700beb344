"""The port's densify phases and the mean2d gradient tap against the JAX
package on the same numpy inputs: densify_phase (exact silhouette: the JAX
side takes its CSR render in Pallas interpret mode, backend="pallas"),
densify_gradient_phase (the port's clone/split fed jax.random's normal
draws), mapping_loss_with_tap (both sides blend the capped tiles without an
early exit: the reference's XLA blend and its plain port) and a mapping
event with use_gs_densification.

Tolerances: the inserted slots and counts exactly; parameters 1e-5 (the same
float32 arithmetic, the exact render's sums in another order); the tap and
parameter gradients 1e-4 of each one's largest value (the loss gradients'
tolerance in tests/test_torch_mapper.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activesplat_tpu.mapper import step as jstep
from activesplat_tpu.mapper.config import MapperConfig as JaxConfig
from activesplat_tpu.mapper.keyframes import KeyframeStore as JaxStore
from activesplat_tpu.models import gaussians as jg
from activesplat_tpu_torch.convert import buffer_from_numpy, buffer_to_numpy
from activesplat_tpu_torch.mapper import step as tstep
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.mapper.keyframes import KeyframeStore
from tests.reference_impl import random_scene
from tests.test_torch_mapper import (
    FIELDS,
    H,
    W,
    assert_buffers_close,
    camera_pose,
    cameras,
    jax_to_numpy,
    numpy_to_jax,
    slice_scene,
    t,
)

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def assert_same_slots(got, ref):
    np.testing.assert_array_equal(got["active"], ref["active"])
    np.testing.assert_array_equal(got["timestep"], ref["timestep"])


@pytest.mark.parametrize("factor", [1, 2])
def test_densify_phase_matches_jax(factor):
    """A sparse map of the frame's surfaces: the unexplained pixels become
    new Gaussians in the same slots, with the same parameters."""
    d, rgb, depth = slice_scene(seed=9, n=200, capacity=4096)
    jcam, tcam = cameras()
    kw = dict(k_per_tile=64, chunk=64, densify_downscale_factor=factor)
    ref, ref_drop, ref_new = jstep.densify_phase(
        numpy_to_jax(d), jcam, jnp.asarray(rgb), jnp.asarray(depth), jnp.float32(4.0),
        JaxConfig(**kw), backend="pallas",
    )
    got, got_drop, got_new = tstep.densify_phase(
        buffer_from_numpy(d, device="cpu"), tcam, t(rgb), t(depth), 4.0, MapperConfig(**kw)
    )
    assert int(got_new) == int(ref_new) > 100 and int(got_drop) == int(ref_drop) == 0
    got_d, ref_d = buffer_to_numpy(got), jax_to_numpy(ref)
    assert_same_slots(got_d, ref_d)
    assert_buffers_close(got_d, ref_d, rtol=1e-5, atol=1e-5)


def test_densify_phase_drops_past_capacity():
    d, rgb, depth = slice_scene(seed=10, n=200, capacity=256)
    jcam, tcam = cameras()
    kw = dict(k_per_tile=64, chunk=64)
    ref, ref_drop, ref_new = jstep.densify_phase(
        numpy_to_jax(d), jcam, jnp.asarray(rgb), jnp.asarray(depth), jnp.float32(1.0),
        JaxConfig(**kw), backend="pallas",
    )
    got, got_drop, got_new = tstep.densify_phase(
        buffer_from_numpy(d, device="cpu"), tcam, t(rgb), t(depth), 1.0, MapperConfig(**kw)
    )
    assert int(got_drop) == int(ref_drop) > 0 and int(got_new) == int(ref_new) == 56
    assert_same_slots(buffer_to_numpy(got), jax_to_numpy(ref))


def gradient_scene(seed=11):
    """tests/test_gs_densify.py's scene: 32 random Gaussians, half of them
    high-gradient, in a buffer with room for their children."""
    scene = random_scene(np.random.default_rng(seed), 32)
    d = jax_to_numpy(jg.GaussianBuffer.empty(64))
    for f in FIELDS:
        d[f][:32] = scene[f]
    d["active"][:32] = True
    d["grad_accum"][:16] = 1.0
    d["grad_accum"][20:24] = 0.2  # below the threshold
    d["denom"][:] = 1.0
    return d


@pytest.mark.parametrize("scene_radius", [1.0, 200.0])
def test_densify_gradient_phase_matches_jax(scene_radius):
    """Clones (small Gaussians; scene_radius 200) and splits (radius 1):
    with jax.random's normal draws handed to the port, the same slots,
    counts and parameters; the port's own generator gives the same slots
    and counts."""
    d = gradient_scene()
    cfg_kw = dict(use_gs_densification=True, densify_grad_thresh=0.5)
    key = jax.random.PRNGKey(0)
    ref, ref_drop, ref_new = jstep.densify_gradient_phase(
        numpy_to_jax(d), jnp.float32(scene_radius), jnp.float32(3.0), key, JaxConfig(**cfg_kw)
    )
    noise = np.asarray(jax.random.normal(key, d["means3d"].shape))
    got, got_drop, got_new = tstep.clone_split(
        buffer_from_numpy(d, device="cpu"), scene_radius, 3.0, t(noise), MapperConfig(**cfg_kw)
    )
    assert int(got_new) == int(ref_new) == 16 and int(got_drop) == int(ref_drop) == 0
    got_d, ref_d = buffer_to_numpy(got), jax_to_numpy(ref)
    assert_same_slots(got_d, ref_d)
    assert_buffers_close(got_d, ref_d, rtol=1e-5, atol=1e-6)
    own, _, own_new = tstep.densify_gradient_phase(
        buffer_from_numpy(d, device="cpu"), scene_radius, 3.0, torch.Generator().manual_seed(0),
        MapperConfig(**cfg_kw),
    )
    assert int(own_new) == 16
    assert_same_slots(buffer_to_numpy(own), ref_d)


@pytest.mark.parametrize("mode", ["off", "hybrid"])
def test_mapping_loss_with_tap_matches_jax(mode):
    """The loss, the parameter gradients and the mean2d tap gradient; the
    tap reaches only Gaussians that were seen. At k=16 the cap bites, so
    "hybrid" recomposites harmful tiles through the CSR blend."""
    d, rgb, depth = slice_scene(seed=12)
    jcam, tcam = cameras()
    kw = dict(k_per_tile=16, chunk=64, use_gs_densification=True, exact_training=mode)
    jbuf = numpy_to_jax(d)

    def jloss(params, tap):
        return jstep.mapping_loss_with_tap(params, tap, jbuf, jcam, jnp.asarray(rgb),
                                           jnp.asarray(depth), JaxConfig(**kw))

    (loss_r, aux_r), (grads_r, tap_r) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jbuf.params, jnp.zeros((d["means3d"].shape[0], 2))
    )
    loss, aux, grads, g_tap = tstep.loss_and_grads_with_tap(
        buffer_from_numpy(d, device="cpu"), tcam, t(rgb), t(depth), MapperConfig(**kw)
    )
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-5)
    assert int(aux.dropped) == int(aux_r.dropped)
    for got, ref in [(g_tap, tap_r)] + [(getattr(grads, f), getattr(grads_r, f)) for f in FIELDS]:
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    unseen = ~(aux.radii > 0).numpy()
    assert unseen.any() and not g_tap.numpy()[unseen].any()


def test_mapping_phase_accumulates_the_tap():
    """One event with use_gs_densification and no committed keyframe (no
    random draw decides anything): grad_accum, denom and the parameters as
    JAX's."""
    d, rgb, depth = slice_scene(seed=13)
    c2w = camera_pose()
    jcam, tcam = cameras()
    kw = dict(k_per_tile=64, chunk=64, use_gs_densification=True, mapping_window_size=4,
              kf_select_pixels=64)
    w2c = np.linalg.inv(c2w).astype(np.float32)
    jbuf, _, jm = jstep.mapping_phase(
        numpy_to_jax(d), JaxStore.empty(4, H, W), jnp.asarray(rgb), jnp.asarray(depth),
        jnp.asarray(w2c), jnp.int32(0), jcam, jax.random.PRNGKey(0), JaxConfig(**kw), 3,
    )
    tbuf, _, tm = tstep.mapping_phase(
        buffer_from_numpy(d, device="cpu"), KeyframeStore.empty(4, H, W, device="cpu"), t(rgb),
        t(depth), t(w2c), 0, tcam, torch.Generator().manual_seed(0), MapperConfig(**kw), 3,
    )
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-5)
    got, ref = buffer_to_numpy(tbuf), jax_to_numpy(jbuf)
    assert ref["denom"].max() == 3.0 and ref["grad_accum"].max() > 0
    np.testing.assert_array_equal(got["denom"], ref["denom"])
    np.testing.assert_allclose(got["grad_accum"], ref["grad_accum"], rtol=1e-4,
                               atol=1e-4 * ref["grad_accum"].max())
    assert_buffers_close({f: got[f] for f in FIELDS}, {f: ref[f] for f in FIELDS},
                         rtol=1e-5, atol=2e-6)
