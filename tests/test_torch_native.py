"""The port's native raycaster (runtime/native_raycast.py, csrc/raycast.cpp):
against its numpy path within 1e-4 (tests/test_native.py's tolerance) and
against the JAX package's native raycaster on the same inputs, bitwise:
both build the same source with the same flags. (On these cases the native
frames also equal the numpy path's bitwise, a maximum difference of 0.0 on
this CPU; the test holds that pair only to 1e-4.) Also:
ACTIVESPLAT_NATIVE=0 selects numpy, BoxWorld.render takes the native path
by default, and a build that fails raises with the compiler's message
rather than falling back."""

import numpy as np
import pytest

from activesplat_tpu.runtime import native_raycast as jnative
from activesplat_tpu_torch.runtime import native_raycast as tnative
from activesplat_tpu_torch.runtime.synthetic import BoxWorld
from activesplat_tpu_torch.utils.transforms import rot_axis

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4


def pose(center, yaw_deg, pitch_deg=0.0):
    c2w = np.eye(4)
    c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
    c2w[:3, 3] = center
    return rot_axis(rot_axis(c2w, "y", np.deg2rad(yaw_deg)), "x", np.deg2rad(pitch_deg))


CASES = [
    (BoxWorld.two_room(seed=0), np.array([[40.0, 0, 31.0], [0, 40.0, 23.0], [0, 0, 1]]), 64, 48,
     pose([5.0, 1.25, 1.5], 40)),
    (BoxWorld.two_room(seed=3), np.array([[60.0, 0, 47.0], [0, 60.0, 47.0], [0, 0, 1]]), 96, 96,
     pose([2.0, 1.25, 4.5], -130, -20)),
    (BoxWorld.single_room(seed=1), np.array([[30.0, 0, 15.0], [0, 30.0, 15.0], [0, 0, 1]]), 32,
     32, pose([3.0, 1.25, 3.0], 200, 25)),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_native_matches_numpy_and_the_jax_library(case, monkeypatch):
    world, intr, w, h, c2w = CASES[case]
    rgb_c, depth_c = world.render(c2w, intr, w, h, depth_max=4.0)
    monkeypatch.setenv("ACTIVESPLAT_NATIVE", "0")
    rgb_np, depth_np = world.render(c2w, intr, w, h, depth_max=4.0)
    assert (depth_np > 0).any()
    if case == 0:
        assert (depth_np == 0).any()  # the depth clamp is exercised
    np.testing.assert_allclose(depth_c, depth_np, atol=ATOL)
    np.testing.assert_allclose(rgb_c, rgb_np, atol=ATOL)
    assert jnative.native_available()
    rgb_j, depth_j = jnative.raycast(c2w, intr, w, h, world.size, world.obstacles.reshape(-1, 6),
                                     0.0, 4.0)
    # the same source and flags: bitwise
    np.testing.assert_array_equal(rgb_c, rgb_j)
    np.testing.assert_array_equal(depth_c, depth_j)


def test_boxworld_uses_native_by_default(monkeypatch):
    world, intr, w, h, c2w = CASES[2]
    calls = []
    real = tnative.raycast
    monkeypatch.setattr(tnative, "raycast", lambda *a: calls.append(a) or real(*a))
    monkeypatch.delenv("ACTIVESPLAT_NATIVE", raising=False)
    rgb, depth = world.render(c2w, intr, w, h)
    assert len(calls) == 1
    assert rgb.shape == (h, w, 3) and depth.shape == (h, w)
    assert rgb.dtype == depth.dtype == np.float32
    assert depth[depth > 0].min() > 0.1
    monkeypatch.setenv("ACTIVESPLAT_NATIVE", "0")
    world.render(c2w, intr, w, h)
    assert len(calls) == 1  # ACTIVESPLAT_NATIVE=0 honoured


def test_library_keyed_and_built_once(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    path = tnative.build()
    assert path.parent == tmp_path and path.name.startswith("libraycast-")
    assert tnative.build() == path
    assert sorted(p.name for p in tmp_path.iterdir()) == [path.name]  # no temporary left


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    world, intr, w, h, c2w = CASES[2]
    monkeypatch.delenv("ACTIVESPLAT_NATIVE", raising=False)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        world.render(c2w, intr, w, h)
    # a compiler that runs and fails: its message is raised, nothing falls back
    bad = tmp_path / "raycast.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="building the native raycaster failed"):
        world.render(c2w, intr, w, h)
    assert not list(tmp_path.glob("*.so"))
