"""The port's judges (activesplat_tpu_torch/eval/replay.py, nvs.py,
batch.py) against the JAX package's, on the CPU.

Coverage: the JAX raycaster runs in numpy (ACTIVESPLAT_NATIVE=0), so both
sides replay bitwise the same frames, and the float64 KD-tree math is the
same: the four numbers agree to rtol 1e-12 and the observed point counts
are equal. Also tests/test_eval.py's coverage tests on the port.

Map quality and NVS on one small dump (a port episode of 9 frames at
32x32): dense at k_per_tile=0, exact at k_per_tile>0, where the JAX side's
forward_backend is patched to "pallas" (its CSR kernel in interpret mode)
so that both blends take the early exit. Tolerance: rtol 1e-5 / atol 1e-6
on each averaged score, as for the metrics alone (tests/test_torch_eval.py):
both sides render the same map in float32, their images agree to about
1e-6, and the sums differ in order only."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import activesplat_tpu.eval.nvs as jnvs
import activesplat_tpu.eval.replay as jreplay
from activesplat_tpu.runtime import dataloader as jdl
from activesplat_tpu.runtime.synthetic import BoxWorld as JaxBoxWorld
from activesplat_tpu_torch.eval import batch as tbatch
from activesplat_tpu_torch.eval import nvs as tnvs
from activesplat_tpu_torch.eval import replay as treplay
from activesplat_tpu_torch.io.actions import read_actions
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.runtime import dataloader as tdl
from activesplat_tpu_torch.runtime.bus import Bus
from activesplat_tpu_torch.runtime.dataloader import SimAction, action_to_twist
from activesplat_tpu_torch.runtime.mapper_node import MapperNode
from activesplat_tpu_torch.runtime.synthetic import BoxWorld

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

COVERAGE_RTOL = 1e-12
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
SMALL_CFG = MapperConfig(initial_capacity=1 << 11, max_capacity=1 << 11, keyframe_capacity=16,
                         mapping_iters=2, map_every=2, kf_every=2, mapping_window_size=4,
                         chunk=128, k_per_tile=0, kf_select_pixels=64)


def make_dataset(results_dir, step_num=40, mod=tdl, world_cls=BoxWorld):
    """tests/test_eval.py's judge scene, from either package."""
    sensor = mod.RGBDSensor.from_fov(32, 32, 90.0, depth_min=0.0, depth_max=10.0)
    return mod.SyntheticDataset(world_cls.single_room(seed=5), sensor, step_num=step_num,
                                start_position=np.array([3.0, 0.0, 3.0]), turn_angle_deg=30.0,
                                results_dir=results_dir)


def record(results_dir, actions):
    dataset = make_dataset(results_dir)
    for action in actions:
        dataset.step(action)
    dataset.close()
    return os.path.join(results_dir, "actions.txt")


SPIN_AND_ADVANCE = [SimAction.TURN_LEFT] * 12 + [SimAction.MOVE_FORWARD] * 20


def test_eval_actions_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("ACTIVESPLAT_NATIVE", "0")
    path = record(str(tmp_path), SPIN_AND_ADVANCE + [SimAction.LOOK_DOWN, SimAction.TURN_RIGHT])
    kw = dict(num_gt_samples=20000, frame_stride=2)
    got = treplay.eval_actions(make_dataset(None), path, **kw)
    want = jreplay.eval_actions(make_dataset(None, mod=jdl, world_cls=JaxBoxWorld), path, **kw)
    assert got.num_observed_points == want.num_observed_points > 0
    for key in ("completeness", "completeness_ratio", "accuracy", "path_length"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key), rtol=COVERAGE_RTOL,
                                   err_msg=key)
    assert got.as_row() == want.as_row()


def test_coverage_judge(tmp_path):
    """tests/test_eval.py::test_coverage_judge on the port: plausible
    numbers, threaded queries equal to serial, and the union-cloud tree
    equal to the reference's per-frame trees with a running minimum."""
    from scipy.spatial import cKDTree

    path = record(str(tmp_path), SPIN_AND_ADVANCE)
    kw = dict(num_gt_samples=20000, frame_stride=2)
    report = treplay.eval_actions(make_dataset(None), path, **kw)
    assert 0.0 < report.completeness < 2.0
    assert 0.1 < report.completeness_ratio <= 1.0  # a full spin sees much of the room
    assert report.accuracy < 0.2  # backprojected GT depth lies on surfaces
    np.testing.assert_allclose(report.path_length, 20 * 0.065, atol=1e-9)

    par = treplay.eval_actions(make_dataset(None), path, workers=2, **kw)
    assert dataclasses.astuple(par) == dataclasses.astuple(report)

    slow = make_dataset(None)
    slow.reset()
    gt = treplay.sample_gt_surface(slow, 20000)
    frames = [slow.get_frame()]
    for a in read_actions(path):
        slow.step(SimAction(a))
        frames.append(slow.get_frame())
    min_dist = np.full(len(gt), np.inf)
    for f in frames[::2]:
        pts = treplay.backproject_frame(f["depth"], slow.sensor.intrinsics,
                                        np.asarray(f["c2w"], np.float64))[::4]
        if len(pts):
            np.minimum(min_dist, cKDTree(pts).query(gt, k=1)[0], out=min_dist)
    np.testing.assert_allclose(report.completeness, min_dist.mean())
    np.testing.assert_allclose(report.completeness_ratio, (min_dist < 0.05).mean())


def test_coverage_monotone(tmp_path):
    """More exploration -> better coverage."""
    short = record(str(tmp_path / "short"), [SimAction.TURN_LEFT] * 3)
    long = record(str(tmp_path / "long"), [SimAction.TURN_LEFT] * 12)
    kw = dict(num_gt_samples=10000, frame_stride=2)
    r1 = treplay.eval_actions(make_dataset(None), short, **kw)
    r2 = treplay.eval_actions(make_dataset(None), long, **kw)
    assert r2.completeness_ratio > r1.completeness_ratio


def test_mesh_backed_and_habitat_sets_refused(tmp_path):
    """Since the Habitat side is ported, a mesh-backed dataset is sampled
    from its mesh (tests/test_torch_mesh.py) and the Habitat scene sets run
    through the adapter: what is refused is a mesh that is not there, a
    dataset with neither a world nor a mesh, and the real simulator without
    its wheels."""
    class MeshDataset:
        scene_mesh_url = str(tmp_path / "scene.glb")

    with pytest.raises(FileNotFoundError):
        treplay.sample_gt_surface(MeshDataset())
    with pytest.raises(ValueError, match="gt_samples"):
        treplay.sample_gt_surface(object())
    with pytest.raises(ImportError, match="--habitat_sim mock"):
        tbatch.run_batch("gibson_small", str(tmp_path), device="cpu")
    assert callable(tbatch.habitat_dataset_factory())


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """A port episode's outputs at 32x32: 8 actions mapped by the node on
    the CPU, params.npz and 9 dumped frames. The saved means get a ramp of
    1 um a Gaussian so that no two depths tie in any view: the packages'
    depth sorts order ties differently (ROADMAP.md queue C, "Unstable
    sort"), and a tie between two colours moves a pixel by up to 0.03."""
    results_dir = str(tmp_path_factory.mktemp("dump"))
    dataset = make_dataset(results_dir, step_num=8)
    node = MapperNode(Bus(), dataset, SMALL_CFG, results_dir, pixel_max=40, device="cpu")
    for action in [SimAction.TURN_LEFT] * 6 + [SimAction.MOVE_FORWARD] * 2:
        node.bus.publish("cmd_vel", action_to_twist(action))
    node.finish()
    dataset.close()
    gdir = os.path.join(results_dir, "gaussians_data")
    path = os.path.join(gdir, "params.npz")
    params = dict(np.load(path))
    ramp = 1e-6 * np.arange(len(params["means3D"]), dtype=np.float32)
    params["means3D"] = params["means3D"] + ramp[:, None] * np.array([1.0, 2.0, 3.0], np.float32)
    np.savez(path, **params)
    return path, gdir


@pytest.fixture
def jax_exact(monkeypatch):
    """The JAX side's forward renders take its CSR kernel (interpret mode)."""
    monkeypatch.setattr(sys.modules["activesplat_tpu.ops.render"], "forward_backend",
                        lambda: "pallas")


def assert_scores_close(got, want):
    assert set(got) == set(want), (got, want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=SCORE_RTOL, atol=SCORE_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("k_per_tile", [0, 64])
def test_eval_map_quality_matches_jax(dump, k_per_tile, request):
    if k_per_tile:
        request.getfixturevalue("jax_exact")
    params, gdir = dump
    kw = dict(frame_stride=2, chunk=128, k_per_tile=k_per_tile)
    got = treplay.eval_map_quality(params, gdir, device="cpu", **kw)
    want = jreplay.eval_map_quality(params, gdir, **kw)
    assert_scores_close(got, want)
    assert got["psnr"] > 10 and got["depth_l1"] < 2.0, got  # a 2-iteration map of 9 frames


@pytest.mark.parametrize("k_per_tile", [0, 64])
def test_eval_nvs_from_dump_matches_jax(dump, k_per_tile, request):
    if k_per_tile:
        request.getfixturevalue("jax_exact")
    params, gdir = dump
    kw = dict(holdout_every=3, chunk=128, k_per_tile=k_per_tile)
    got = tnvs.eval_nvs_from_dump(params, gdir, device="cpu", **kw)
    want = jnvs.eval_nvs_from_dump(params, gdir, **kw)
    assert_scores_close(got, want)
    assert got["num_eval_frames"] == 3
    # the reference's quirk: its "depth_rmse" takes the sqrt per pixel
    if got["valid_frame_ratio"] > 0:
        np.testing.assert_allclose(got["depth_rmse"], got["depth_l1"], rtol=1e-6)


def test_eval_nvs_silhouette_mask(dump):
    """mask_with_silhouette (the mapping_iters==0 mode) on both sides."""
    params, gdir = dump
    kw = dict(holdout_every=3, chunk=128, mask_with_silhouette=True, sil_thres=0.5)
    assert_scores_close(tnvs.eval_nvs_from_dump(params, gdir, device="cpu", **kw),
                        jnvs.eval_nvs_from_dump(params, gdir, **kw))


def test_run_batch(tmp_path, monkeypatch):
    """Episodes and the coverage judge over a one-scene set with a small
    dataset_factory; the summary is rewritten after every run."""
    monkeypatch.setitem(tbatch.SCENE_SETS, "tiny",
                        [{"scene_id": "single_room", "seed": 5, "step_num": 4}])
    built = []

    def factory(spec, results_dir):
        built.append(results_dir)
        return make_dataset(results_dir, step_num=spec["step_num"])

    results = tbatch.run_batch("tiny", str(tmp_path), repetitions=2, mapper_cfg=SMALL_CFG,
                               pixel_max=40, dataset_factory=factory, device="cpu")
    runs = [os.path.join(str(tmp_path), f"single_room-5-rep{r}") for r in range(2)]
    assert built == [runs[0], None, runs[1], None]  # the judge's replay writes nothing
    assert [r["run"] for r in results] == ["single_room-5-rep0", "single_room-5-rep1"]
    for run, row in zip(runs, results):
        assert len(read_actions(os.path.join(run, "actions.txt"))) == 4
        values = [float(v) for v in open(os.path.join(run, "actions_error.txt")).read().split()]
        np.testing.assert_allclose(values, [row[k] for k in ("completeness", "completeness_ratio",
                                                             "accuracy", "path_length")],
                                   atol=1e-6)
        assert 0 < row["completeness_ratio"] <= 1
    import json

    summary = json.load(open(os.path.join(str(tmp_path), "summary.json")))
    assert summary["scene_set"] == "tiny" and len(summary["runs"]) == 2
    np.testing.assert_allclose(summary["mean_completeness_ratio"],
                               np.mean([r["completeness_ratio"] for r in results]))


def test_judges_default_to_cuda(dump, tmp_path, monkeypatch):
    """Without device= the judges ask for CUDA and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, gdir = dump
    for call in (lambda: treplay.eval_map_quality(params, gdir),
                 lambda: tnvs.eval_nvs_from_dump(params, gdir),
                 lambda: tbatch.run_batch("synthetic_small", str(tmp_path))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
