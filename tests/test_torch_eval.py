"""The port's metrics (activesplat_tpu_torch/eval/metrics.py, lpips.py)
against the JAX package's on the same seeded numpy images, on the CPU.

Tolerances: the image and depth metrics within rtol 1e-5 / atol 1e-6 (as
tests/test_eval.py::test_frame_scores_jax_matches_frame_report holds the
JAX device scorer to its host path: both sides compute in float32 and
differ in summation order only); LPIPS within rel 1e-4 (as
tests/test_lpips.py holds the JAX network to a torch oracle: convolutions
of 11x11x3 to 3x3x384 taps summed in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activesplat_tpu.eval import lpips_jax
from activesplat_tpu.eval import metrics as jm
from activesplat_tpu_torch.eval import lpips as tl
from activesplat_tpu_torch.eval import metrics as tm

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-6
LPIPS_REL = 1e-4


def pair(rng, h, w, noise=0.08):
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = (a + rng.normal(0, noise, a.shape)).astype(np.float32)  # out of range too
    return a, b


def depths(rng, h, w, holes=0.2):
    gt = rng.uniform(0.5, 5.0, (h, w)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < holes] = 0.0
    pred = (gt + rng.normal(0, 0.05, gt.shape)).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("name", ["psnr", "ssim"])
def test_image_metric_matches_jax(name):
    rng = np.random.default_rng(0)
    a, b = pair(rng, 40, 52)
    want = getattr(jm, name)(a, b)
    got = getattr(tm, name)(a, b, device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("levels,size", [(1, (24, 30)), (2, (48, 48)), (3, (50, 61)),
                                         (5, (256, 256))])
def test_ms_ssim_matches_jax(levels, size):
    """ms_ssim against the JAX package's core under one jit (its eager
    ops would each compile apart; ms_ssim itself is checked through
    frame_report below)."""
    rng = np.random.default_rng(levels)
    a, b = pair(rng, *size)
    b = np.clip(b, 0, 1)
    want = float(jax.jit(jm.ms_ssim_jax, static_argnums=2)(jnp.asarray(a), jnp.asarray(b),
                                                            levels))
    np.testing.assert_allclose(tm.ms_ssim(a, b, levels=levels, device="cpu"), want,
                               rtol=RTOL, atol=ATOL)


def test_ms_ssim_identity_and_too_small():
    rng = np.random.default_rng(1)
    a, _ = pair(rng, 32, 32)
    assert tm.ms_ssim(a, a, levels=2, device="cpu") > 0.999
    assert tm.psnr(a, a, device="cpu") > 60
    with pytest.raises(ValueError, match="too small"):
        tm.ms_ssim(a, a, levels=3, device="cpu")


def test_ms_ssim_levels():
    for side in range(1, 600):
        assert tm.ms_ssim_levels(side, side) == jm.ms_ssim_levels(side, side), side
        assert tm.ms_ssim_levels(side, side + 7, 3) == jm.ms_ssim_levels(side, side + 7, 3)
    assert tm.ms_ssim_levels(42, 42) == 2  # the naive 10*2^(L-1) bound says 3
    assert (tm.ms_ssim_levels(8, 8), tm.ms_ssim_levels(256, 256)) == (1, 5)


@pytest.mark.parametrize("side", [10, 21, 42, 84])
def test_ms_ssim_borderline_sizes(side):
    """Truncating 2x downsampling shrinks borderline sizes below the 11-px
    window (42 -> 20 -> 10): frame_report stays finite and equal to the
    JAX one at each size."""
    rng = np.random.default_rng(side)
    a = rng.uniform(0, 1, (side, side, 3))  # float64, as the JAX test feeds it
    b = np.clip(a + 0.05, 0, 1)
    d = rng.uniform(1, 3, (side, side))
    got = tm.frame_report(a, b, d, d, device="cpu")
    want = jm.frame_report(a, b, d, d)
    assert np.isfinite(got["ms_ssim"])
    for key in tm.SCORE_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL, err_msg=key)


def test_frame_report_matches_jax():
    rng = np.random.default_rng(2)
    rgb_pred, rgb_gt = pair(rng, 48, 64)
    depth_pred, depth_gt = depths(rng, 48, 64)
    got = tm.frame_report(rgb_pred, rgb_gt, depth_pred, depth_gt, device="cpu")
    want = jm.frame_report(rgb_pred, rgb_gt, depth_pred, depth_gt)
    assert set(got) == set(want) == set(tm.SCORE_KEYS)
    for key in tm.SCORE_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("size,holes", [((48, 48), 0.2), ((32, 40), 0.0), ((9, 9), 0.5),
                                        ((16, 16), 1.0)])
def test_frame_scores_matches_jax(size, holes):
    """frame_scores against frame_scores_jax and against the port's own
    frame_report (the fused scorer reproduces the host path), including
    out-of-range predictions, invalid depth, frames below one SSIM window
    (levels 0) and frames with no valid depth."""
    rng = np.random.default_rng(3)
    rgb_pred, rgb_gt = pair(rng, *size)
    depth_pred, depth_gt = depths(rng, *size, holes=holes)
    levels = jm.ms_ssim_levels(*size) if min(size) >= 11 else 0
    scores_jax = jax.jit(jm.frame_scores_jax, static_argnums=4)
    want = np.asarray(scores_jax(jnp.asarray(rgb_pred), jnp.asarray(rgb_gt),
                                 jnp.asarray(depth_pred), jnp.asarray(depth_gt), levels))
    t = [torch.from_numpy(x) for x in (rgb_pred, rgb_gt, depth_pred, depth_gt)]
    got = tm.frame_scores(*t, levels).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    report = tm.frame_report(rgb_pred, rgb_gt, depth_pred, depth_gt, device="cpu")
    np.testing.assert_allclose(got, [report[k] for k in tm.SCORE_KEYS], rtol=RTOL, atol=ATOL)


def test_depth_metrics_and_ate_match_jax():
    gt = np.array([[1.0, 2.0], [0.0, 3.0]])
    pred = np.array([[1.1, 2.0], [5.0, 2.5]])
    assert tm.depth_metrics(pred, gt) == jm.depth_metrics(pred, gt)
    np.testing.assert_allclose(tm.depth_metrics(pred, gt)[0], 0.6 / 3, atol=1e-6)
    assert tm.depth_metrics(pred, np.zeros_like(gt)) == (0.0, 0.0)
    rng = np.random.default_rng(0)
    gt_c2w = np.tile(np.eye(4), (20, 1, 1))
    gt_c2w[:, :3, 3] = rng.uniform(-3, 3, (20, 3))
    theta = 0.7
    rot = np.array([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                    [0, 0, 1]])
    est = gt_c2w.copy()
    est[:, :3, 3] = gt_c2w[:, :3, 3] @ rot.T + np.array([1.0, -2.0, 0.5])
    assert tm.ate_rmse(est, gt_c2w) < 1e-9  # a rigid motion aligns away
    est[:, :3, 3] += rng.normal(0, 0.05, (20, 3))
    assert tm.ate_rmse(est, gt_c2w) == jm.ate_rmse(est, gt_c2w) > 0.01


@pytest.fixture(scope="module")
def weights():
    return tl.random_weights(np.random.default_rng(3))


def test_random_weights_are_the_jax_tests_recipe(weights):
    """The port's copy draws what tests/test_lpips.py's make_weights draws."""
    rng = np.random.default_rng(3)
    c_in = 3
    for i, (k, _, _, c_out, _) in enumerate(lpips_jax.ALEX_LAYERS):
        np.testing.assert_array_equal(
            weights[f"conv{i}_w"], rng.normal(0, 0.1, (k, k, c_in, c_out)).astype(np.float32))
        np.testing.assert_array_equal(weights[f"conv{i}_b"],
                                      rng.normal(0, 0.1, (c_out,)).astype(np.float32))
        np.testing.assert_array_equal(weights[f"lin{i}_w"],
                                      rng.uniform(0, 1, (c_out,)).astype(np.float32))
        c_in = c_out
    assert tl.ALEX_LAYERS == lpips_jax.ALEX_LAYERS
    np.testing.assert_array_equal(tl.SHIFT, lpips_jax.SHIFT)
    np.testing.assert_array_equal(tl.SCALE, lpips_jax.SCALE)


@pytest.mark.parametrize("size,noise", [((64, 64), 0.1), ((72, 96), 0.3)])
def test_lpips_matches_jax(weights, size, noise):
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (*size, 3))
    b = a + rng.normal(0, noise, a.shape)  # the clamp is the metric's
    got = tl.lpips(a, b, weights=weights, device="cpu")
    want = lpips_jax.lpips(a, b, weights=weights)
    assert got == pytest.approx(want, rel=LPIPS_REL)
    assert tl.lpips(a, a, weights=weights, device="cpu") == pytest.approx(0.0, abs=1e-6)


def test_lpips_gating_env(weights, tmp_path, monkeypatch):
    """metrics.lpips and frame_report pick up the network through the env
    weights file, cached per device; without it LPIPS is absent."""
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    d = rng.uniform(1, 3, (64, 64)).astype(np.float32)
    monkeypatch.delenv("ACTIVESPLAT_LPIPS_WEIGHTS", raising=False)
    assert not tm.lpips_available()
    assert tm.lpips(a, b, device="cpu") is None
    assert "lpips" not in tm.frame_report(a, b, d, d, device="cpu")
    path = str(tmp_path / "lpips_alex.npz")
    np.savez(path, **weights)
    monkeypatch.setenv("ACTIVESPLAT_LPIPS_WEIGHTS", path)
    monkeypatch.setattr(tl, "_CACHE", {})
    assert tm.lpips_available()
    value = tm.lpips(a, b, device="cpu")
    assert value == pytest.approx(lpips_jax.lpips(a, b, weights=weights), rel=LPIPS_REL)
    assert tm.frame_report(a, b, d, d, device="cpu")["lpips"] == pytest.approx(value, rel=1e-6)
    assert list(tl._CACHE) == [(path, "cpu")]


def test_convert_torch_state_dict(weights):
    """Round-trip the lpips-package state_dict naming (as tensors and as
    arrays) into the npz schema, equal to the JAX converter's."""
    sd = {}
    for i in range(5):
        sd[f"net.slice{i + 1}.0.weight"] = torch.from_numpy(
            weights[f"conv{i}_w"].transpose(3, 2, 0, 1).copy())  # back to OIHW
        sd[f"net.slice{i + 1}.0.bias"] = weights[f"conv{i}_b"]
        sd[f"lin{i}.model.1.weight"] = weights[f"lin{i}_w"].reshape(1, -1, 1, 1)
    out = tl.convert_torch_state_dict(sd)
    ref = lpips_jax.convert_torch_state_dict({k: np.asarray(v) for k, v in sd.items()})
    assert set(out) == set(ref)
    for key in out:
        np.testing.assert_array_equal(out[key], ref[key])
        np.testing.assert_array_equal(out[key], weights[key])
    del sd["lin4.model.1.weight"]
    with pytest.raises(ValueError, match="lin4_w"):
        tl.convert_torch_state_dict(sd)
