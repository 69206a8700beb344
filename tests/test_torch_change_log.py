"""The mapper's change log (SplaTAMMapper._log_change, mapper/cloud_box.py,
csrc/cloud_box.cpp): each box bitwise the box of numpy's back-projection of
every valid pixel, the formula kept here as it stood before the bound pass
(`numpy_box`), on frames that tie many pixels at an extreme (walls seen
square on), put an edge at 0 (a floor at world height 0), hold no, one or
negative valid pixels, or non-finite ones (numpy's lines then run on every
valid pixel); the span's `pixels` and `rows` counters under the profiler;
and the benchmark's reader of those counters, mapper.aabb_rows."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from activesplat_tpu_torch.mapper.cloud_box import candidates
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.mapper.splatam import SplaTAMMapper
from activesplat_tpu_torch.utils import tracing
from activesplat_tpu_torch.utils.transforms import rot_axis

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent


def numpy_box(depth, intrinsics, c2w):
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    v, u = np.nonzero(depth > 0)
    if len(v) == 0:
        p = c2w[:3, 3][None]
    else:
        z = depth[v, u].astype(np.float64)
        x = (u - cx) / fx * z
        y = (v - cy) / fy * z
        p = np.stack([x, y, z], -1) @ c2w[:3, :3].T + c2w[:3, 3]
    return np.stack([p.min(0), p.max(0)])


def intrinsics(n):
    f = n / 2  # 90 degrees
    return np.array([[f, 0, n / 2 - 1], [0, f, n / 2 - 1], [0, 0, 1]])


def pose(position, yaw_deg, pitch_deg=0.0):
    c2w = np.eye(4)
    c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
    c2w[:3, 3] = position
    return rot_axis(rot_axis(c2w, "y", np.deg2rad(yaw_deg)), "x", np.deg2rad(pitch_deg))


def ulp_pose():
    c2w = np.eye(4)
    c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
    c2w[:3, 3] = [-0.15, -0.01, -0.07]
    return rot_axis(rot_axis(c2w, "y", 6.2e-16), "x", -6.3e-16)


def ulp_wall(rng, n):
    steps = np.random.default_rng(21).integers(-2, 3, (n, n)).astype(np.float32)
    return np.float32(2.325) * (1 + steps * np.float32(2**-23))


def random_depth(rng, n, holes=0.1):
    depth = rng.uniform(0.1, 6.0, (n, n)).astype(np.float32)
    depth[rng.random((n, n)) < holes] = 0.0
    return depth


def floor_depth(n, c2w):
    """The z-depth of the plane at world height 0; 0 where a ray misses it."""
    k = intrinsics(n)
    v, u = np.mgrid[:n, :n]
    rays = np.stack([(u - k[0, 2]) / k[0, 0], (v - k[1, 2]) / k[1, 1], np.ones((n, n))], -1)
    down = rays @ c2w[1, :3]  # the world height each unit of z-depth adds
    with np.errstate(divide="ignore"):
        z = -c2w[1, 3] / down
    return np.where((z > 0) & (z < 20.0), z, 0.0).astype(np.float32)


def wall(z):
    """A frame of one depth: a wall seen square on when the pose is."""
    return lambda rng, n: np.full((n, n), z, np.float32)


def one_pixel(rng, n):
    depth = np.zeros((n, n), np.float32)
    depth[n // 3, n // 5] = 2.5
    return depth


def negative(rng, n):
    depth = random_depth(rng, n)
    depth[rng.random((n, n)) < 0.3] *= -1
    return depth


def non_finite(rng, n):
    depth = random_depth(rng, n)
    depth[3, 7] = np.nan
    depth[n - 5, 2] = np.inf
    return depth


def nan_only(rng, n):
    depth = random_depth(rng, n)
    depth[rng.random((n, n)) < 0.05] = np.nan  # holes to numpy's mask: the bound pass runs
    return depth


CASES = {
    "random_256": (256, random_depth, pose([2.0, 1.25, 3.0], 37.0, -12.0)),
    "random_512": (512, random_depth, pose([1.0, 1.25, -2.0], -141.0, 8.0)),
    "wall_yaw0": (256, wall(2.75), pose([2.0, 1.25, 3.0], 0.0)),
    "wall_yaw90": (512, wall(1.5), pose([2.0, 1.25, 3.0], 90.0)),
    # a wall a float32 ulp deep, turned off square by about an ulp of 1: its
    # coordinates lie a few ulps apart, in another order under each rounding
    "wall_ulp": (64, ulp_wall, ulp_pose()),
    "floor_pitch": (256, None, pose([2.0, 1.25, 3.0], 30.0, -35.0)),
    "yaw_pitch": (256, lambda rng, n: random_depth(rng, n, 0.0),
                  pose([-3.5, 0.4, 7.25], 233.0, 17.0)),
    "no_valid": (256, wall(0.0), pose([2.0, 1.25, 3.0], 15.0)),
    "one_valid": (256, one_pixel, pose([2.0, 1.25, 3.0], 15.0, -5.0)),
    "negative": (256, negative, pose([2.0, 1.25, 3.0], 60.0)),
    "nan_holes": (256, nan_only, pose([2.0, 1.25, 3.0], 100.0, -20.0)),
    "nan_and_inf": (256, non_finite, pose([2.0, 1.25, 3.0], 100.0, -20.0)),
}


@pytest.fixture(scope="module")
def mapper():
    cfg = MapperConfig(initial_capacity=1 << 10, keyframe_capacity=2)
    return SplaTAMMapper(cfg, 32, 32, intrinsics(32), step_num=10, save_dataset=False,
                         device="cpu")


def frame(name):
    n, make, c2w = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    depth = floor_depth(n, c2w) if make is None else make(rng, n)
    return depth, intrinsics(n), c2w


def log_change(mapper, depth, k, c2w):
    """The box _log_change appends for `depth`."""
    mapper.intrinsics = k
    mapper.map_version += 1
    mapper._log_change(depth, c2w)
    return mapper.boxes_since(mapper.map_version - 1)[0]


@pytest.mark.parametrize("name", list(CASES))
def test_boxes_bitwise_numpy(mapper, name):
    depth, k, c2w = frame(name)
    box = log_change(mapper, depth, k, c2w)
    ref = numpy_box(depth, k, c2w)
    np.testing.assert_array_equal(box, ref, strict=True)
    assert (np.signbit(box) == np.signbit(ref)).all()
    if name == "nan_and_inf":
        assert not np.isfinite(ref).all()  # the non-finite path ran
    else:
        assert np.isfinite(ref).all()
    if name == "floor_pitch":
        assert abs(box[0, 1]) < 1e-6 and abs(box[1, 1]) < 1e-6  # the floor's edge at 0
    if name == "no_valid":
        np.testing.assert_array_equal(box, [c2w[:3, 3], c2w[:3, 3]])


@pytest.mark.parametrize("name", [n for n in CASES if n != "nan_and_inf"])
def test_candidates_hold_each_extreme(name):
    """The bound pass leaves distinct valid pixels in row-major order, two or
    more where the frame has two valid pixels, and among them a pixel at
    each of numpy's six extremes."""
    depth, k, c2w = frame(name)
    idx, valid = candidates(depth, k, c2w)
    v, u = np.nonzero(depth > 0)
    assert valid == len(v)
    assert (np.diff(idx) > 0).all() and (depth.reshape(-1)[idx] > 0).all()
    assert len(idx) >= min(valid, 2)
    if valid == 0:
        return
    z = depth[v, u].astype(np.float64)
    p = np.stack([(u - k[0, 2]) / k[0, 0] * z, (v - k[1, 2]) / k[1, 1] * z, z], -1)
    p = p @ c2w[:3, :3].T + c2w[:3, 3]
    picked = np.isin(v * depth.shape[1] + u, idx)
    for extreme in (p.min(0), p.max(0)):
        assert ((p == extreme) & picked[:, None]).any(0).all()


def test_counters_on_the_change_log_span(mapper):
    names = ("random_512", "wall_yaw0", "nan_and_inf", "no_valid")
    frames = [frame(name)[0] for name in names]
    tracing.clear_log()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for name in names:
            with tracing.stage("mapper/change_log"):
                log_change(mapper, *frame(name))
    spans = [r["counters"] for r in tracing.span_log() if r["name"] == "mapper/change_log"]
    tracing.clear_log()
    assert len(spans) == len(names)
    random, wall, non_finite, empty = zip(frames, spans)
    depth, counters = random
    assert counters["pixels"] == int((depth > 0).sum())
    assert 2 <= counters["rows"] < 0.001 * counters["pixels"]
    depth, counters = wall  # every pixel ties at one extreme: the four corners are left
    assert counters["pixels"] == depth.size and counters["rows"] == 4
    depth, counters = non_finite  # numpy's lines on every valid pixel
    assert counters["rows"] == counters["pixels"] == int((depth > 0).sum())
    assert empty[1] == {"pixels": 0, "rows": 0}
    # with the profiler off nothing is logged
    with tracing.stage("mapper/change_log"):
        log_change(mapper, *frame("random_256"))
    assert tracing.span_log() == []


def load_metric(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_aabb_rows_reads_the_log(monkeypatch):
    metric = load_metric("mapper.aabb_rows")
    stretch = SimpleNamespace(start=1000.0, end=9000.0, actions=2, ranges=[])
    ctx = SimpleNamespace(stretch=stretch, actions=2, host_syncs=None)

    def rec(name, start, **counters):
        return {"name": name, "start": start, "end": start + 10.0, "id": 1, "parent": None,
                "thread": 1, "action": 0, "counters": counters}

    log = [rec("mapper/change_log", 1500.0, pixels=262144, rows=12),
           rec("mapper/change_log", 4000.0, pixels=250000, rows=30),
           rec("mapper/change_log", 9500.0, pixels=262144, rows=7),  # past the stretch
           rec("mapper/frame", 1400.0, rows=1000)]
    monkeypatch.setattr(tracing, "span_log", lambda ranges=None: log)
    assert metric.read(ctx) == (12 + 30) / 2
    # the parent's spans: no counters
    monkeypatch.setattr(tracing, "span_log",
                        lambda ranges=None: [rec("mapper/change_log", 1500.0)])
    assert metric.read(ctx) is None
    monkeypatch.delattr(tracing, "span_log")
    assert metric.read(ctx) is None
