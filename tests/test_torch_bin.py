"""The bin's kernel route (B6) against the JAX package: bin_slots' plain twin,
reached through the port's bin_gaussians(use_kernel=True), against JAX
bin_gaussians(backend="pallas", use_kernel=True), whose bin_slots_pallas runs
in interpret mode here; both against the port's sort route; the reference's
static gate; the import-time switch; and the render with the switch on and
off. Every comparison is bitwise: the lists are integers."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activesplat_tpu.ops.raster_tiled import bin_gaussians as jax_bin
from activesplat_tpu_torch.ops import raster_cuda, raster_tiled
from activesplat_tpu_torch.ops.raster_tiled import bin_gaussians

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent

# tests/test_raster_tiled.py:324-332's scenes: (n, width, height)
SCENES = [(1000, 256, 256), (500, 144, 96)]


def scene(n, w, h):
    mean2d = np.random.default_rng(n).uniform(-20, max(w, h) + 20, (n, 2)).astype(np.float32)
    radius = np.random.default_rng(n + 1).uniform(1, 25, n).astype(np.float32)
    valid = np.random.default_rng(n + 2).uniform(0, 1, n) > 0.15
    return mean2d, radius, valid


def port_lists(mean2d, radius, valid, w, h, k, off, use_kernel):
    return bin_gaussians(torch.from_numpy(mean2d), torch.from_numpy(radius),
                         torch.from_numpy(valid), w, h, k, off, use_kernel=use_kernel)


def assert_lists_equal(got, want):
    for f in ("indices", "count", "overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("n,w,h", SCENES)
@pytest.mark.parametrize("k", [128, 256])
def test_kernel_route_matches_jax_bin_slots(n, w, h, k, monkeypatch):
    """Indices (sentinel n on both sides), counts and overflow, bitwise, at
    slot offsets 0, 128 and 256; the port's sort route gives the same."""
    calls = []
    real = raster_tiled.bin_slots
    monkeypatch.setattr(raster_tiled, "bin_slots", lambda *a: calls.append(a) or real(*a))
    mean2d, radius, valid = scene(n, w, h)
    for off in (0, 128, 256):
        ref = jax_bin(jnp.asarray(mean2d), jnp.asarray(radius), jnp.asarray(valid), w, h, k,
                      jnp.int32(off), backend="pallas", use_kernel=True)
        got = port_lists(mean2d, radius, valid, w, h, k, off, use_kernel=True)
        assert got.indices.dtype == torch.int64
        assert_lists_equal(got, ref)
        assert_lists_equal(port_lists(mean2d, radius, valid, w, h, k, off, use_kernel=False), ref)
        assert int((got.indices == n).sum()) > 0  # some tile ends inside the window
    assert len(calls) == 3  # the kernel route ran, through the wrapper


@pytest.mark.parametrize("case", ["k=64", "nb>4096"])
def test_gate_takes_the_sort_route(case, monkeypatch):
    """The reference's static gate: k a multiple of 128 and at most 4,096
    blocks of 128 Gaussians; outside it the sort route runs, with the same
    lists."""
    monkeypatch.setattr(raster_tiled, "bin_slots", lambda *a: pytest.fail("bin_slots ran"))
    if case == "k=64":
        mean2d, radius, valid = scene(1000, 256, 256)
        k = 64
    else:
        n = raster_cuda.BIN_MAX_BLOCKS * raster_cuda.BIN_BLOCK + 1
        mean2d, radius, valid = scene(1000, 256, 256)
        pad = n - 1000
        mean2d = np.concatenate([mean2d, np.full((pad, 2), -1e4, np.float32)])
        radius = np.concatenate([radius, np.ones(pad, np.float32)])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
        k = 128
    got = port_lists(mean2d, radius, valid, 256, 256, k, 0, use_kernel=True)
    want = jax_bin(jnp.asarray(mean2d[:1000]), jnp.asarray(radius[:1000]),
                   jnp.asarray(valid[:1000]), 256, 256, k, jnp.int32(0))
    np.testing.assert_array_equal(
        np.where(got.indices.numpy() >= 1000, -1, got.indices.numpy()),
        np.where(np.asarray(want.indices) >= 1000, -1, np.asarray(want.indices)),
    )
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))


def test_gate_sends_wide_frames_to_the_sort_route(monkeypatch):
    """A frame 4,112 px wide (257 tile columns, more than the packed words
    hold) with the switch on takes the sort route: the same lists as
    use_kernel=False, and neither pass of the kernel route runs."""
    for name in ("bin_count", "bin_slots"):
        monkeypatch.setattr(raster_tiled, name, lambda *a, name=name: pytest.fail(f"{name} ran"))
    w, h = 4112, 32
    assert -(-w // 16) > raster_cuda.BIN_MAX_TILES
    rng = np.random.default_rng(0)
    mean2d = np.stack([rng.uniform(-20, w + 20, 1000), rng.uniform(-20, h + 20, 1000)],
                      1).astype(np.float32)
    radius = rng.uniform(1, 40, 1000).astype(np.float32)
    valid = rng.uniform(0, 1, 1000) > 0.15
    got = port_lists(mean2d, radius, valid, w, h, 128, 0, use_kernel=True)
    assert_lists_equal(got, port_lists(mean2d, radius, valid, w, h, 128, 0, use_kernel=False))
    assert int(got.count.sum()) > 0


@pytest.mark.parametrize("value,expect", [("1", True), ("0", False), (None, False)])
def test_switch_is_read_at_import(value, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("ACTIVESPLAT_BIN_KERNEL", None)
    if value is not None:
        env["ACTIVESPLAT_BIN_KERNEL"] = value
    out = subprocess.run(
        [sys.executable, "-c",
         "from activesplat_tpu_torch.ops import raster_tiled; print(raster_tiled._BIN_KERNEL)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(expect)


def render_inputs(seed=3, n=3000, w=96, h=80):
    """Projected splats over a 96x80 image, many per tile, depths without
    ties (the port's sort is stable, the reference's is not)."""
    rng = np.random.default_rng(seed)
    mean2d = rng.uniform(-10, max(w, h) + 10, (n, 2))
    conic = np.stack([rng.uniform(0.02, 0.3, n), rng.uniform(-0.01, 0.01, n),
                      rng.uniform(0.02, 0.3, n)], -1)
    args = [mean2d, conic, rng.uniform(0.05, 0.6, n), rng.uniform(0, 1, (n, 5)),
            rng.uniform(size=n) > 0.1, rng.uniform(2, 12, n),
            np.linspace(1.0, 5.0, n)[rng.permutation(n)]]
    return [torch.tensor(a, dtype=torch.float32) if a.dtype != bool else torch.from_numpy(a)
            for a in args], w, h


@pytest.mark.parametrize("max_passes", [1, 3])
def test_render_with_the_switch_on_equals_off(max_passes, monkeypatch):
    """rasterize_tiled (k=128, so the gate holds) gives bitwise the same
    image with the switch on and off, with one window or up to three (slot
    offsets 0, 128, 256); the kernel route ran once per window."""
    args, w, h = render_inputs()
    calls = []
    real = raster_tiled.bin_slots
    monkeypatch.setattr(raster_tiled, "bin_slots", lambda *a: calls.append(a[3]) or real(*a))
    outs = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the blend twin's products then sum in one fixed order
    try:
        for on in (False, True):
            monkeypatch.setattr(raster_tiled, "_BIN_KERNEL", on)
            outs[on] = raster_tiled.rasterize_tiled(*args, width=w, height=h, k_per_tile=128,
                                                    max_passes=max_passes)
    finally:
        torch.set_num_threads(threads)
    for a, b in zip(outs[False], outs[True]):
        assert torch.equal(a, b)
    # the cap bites: the first window drops harmful memberships, and the
    # multi-pass walk reads farther windows
    assert calls == [128 * p for p in range(len(calls))]
    assert int(outs[True][2]) > 0 if max_passes == 1 else 1 < len(calls) <= max_passes


def test_bin_slots_refuses_bad_inputs():
    cum = torch.zeros((2, 4), dtype=torch.int32)  # (nb, T): two blocks, four tiles
    with pytest.raises(ValueError, match="aabb"):
        raster_cuda.bin_slots(cum, torch.zeros(128, dtype=torch.int32), 128, 0, 2, 10)
    with pytest.raises(ValueError, match="cum_t"):
        raster_cuda.bin_slots(cum.long(), torch.zeros(256, dtype=torch.int32), 128, 0, 2, 10)
    with pytest.raises(ValueError, match="cuda"):
        raster_cuda.bin_slots(cum.to("meta"), torch.zeros(256, dtype=torch.int32, device="meta"),
                              128, 0, 2, 10)
