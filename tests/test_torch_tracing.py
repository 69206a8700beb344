"""The span log of utils/tracing and what it records on the render path: the
row gather's autograd Function against plain indexing, its backward's
counters, the spans of a profiled mapping iteration on the trace's clock,
the log's silence with the profiler off, the benchmark's readers of the
log, and where the new spans open in a profiled episode.

All on the CPU with one intra-op thread, at a tiny size."""

import contextlib
import dataclasses
from collections import Counter
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from activesplat_tpu_torch.mapper.adam import AdamState
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.mapper.step import mapping_iteration
from activesplat_tpu_torch.ops import raster_tiled
from activesplat_tpu_torch.runtime.bench_scene import build_map
from activesplat_tpu_torch.runtime.dataloader import RGBDSensor, SyntheticDataset
from activesplat_tpu_torch.runtime.launch import run_episode
from activesplat_tpu_torch.runtime.synthetic import BoxWorld
from activesplat_tpu_torch.utils import tracing

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
RENDER_SPANS = ("render/project", "render/prepare", "render/bin", "render/gather",
                "render/blend", "render/harmful", "render/csr_layout", "render/csr_blend",
                "render/gather_bwd")
MAPPER_SPANS = ("mapper/loss", "mapper/grad", "mapper/adam")


@pytest.fixture(autouse=True)
def empty_log():
    tracing.clear_log()
    yield
    tracing.clear_log()


def profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def trace_ranges(prof, tmp_path):
    """The trace's user ranges as (name, start, end, tid), microseconds."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [SimpleNamespace(name=e["name"], start=float(e["ts"]),
                            end=float(e["ts"]) + float(e.get("dur", 0)), tid=e.get("tid"))
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def gather_case(kind, seed=0):
    """An (N, 11) table and ids with most entries the padding row N: the
    capped lists (T, K') or a CSR entry stream (E,)."""
    g = torch.Generator().manual_seed(seed)
    n = 300
    data = torch.randn((n, 11), generator=g)
    shape = (64, 96) if kind == "capped" else (4096,)
    ids = torch.randint(0, n, shape, generator=g)
    ids = torch.where(torch.rand(shape, generator=g) < 0.7, n, ids)
    return data, ids


@pytest.mark.parametrize("kind", ["capped", "csr"])
def test_gather_function_matches_plain_indexing_bitwise(kind):
    data, ids = gather_case(kind)
    cot = torch.randn(ids.shape + (16,), generator=torch.Generator().manual_seed(1))
    outs, grads = [], []
    for gather in (lambda d: torch.nn.functional.pad(raster_tiled._pad_table(d)[ids], (0, 5)),
                   lambda d: raster_tiled._gather_rows(d, ids)):
        d = data.clone().requires_grad_(True)
        rows = gather(d)
        (g,) = torch.autograd.grad((rows * cot).sum(), d)
        outs.append(rows.detach())
        grads.append(g)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(grads[0], grads[1])
    assert int((ids == data.shape[0]).sum()) > ids.numel() // 2


@pytest.mark.parametrize("kind", ["capped", "csr"])
def test_gather_backward_counters_match_numpy(kind):
    data, ids = gather_case(kind, seed=2)
    d = data.clone().requires_grad_(True)
    with profiler():
        rows = raster_tiled._gather_rows(d, ids)
        torch.autograd.grad(rows.sum(), d)
    [rec] = [r for r in tracing.span_log() if r["name"] == "render/gather_bwd"]
    ids_np = ids.numpy()
    n = data.shape[0]
    assert rec["counters"] == {"rows": ids_np.size, "pad_rows": int(np.sum(ids_np == n)),
                               "table_rows": n + 1, "width": data.shape[1]}


def tiny_iteration_inputs():
    """A 64x64 frame of a 3,000-Gaussian map, trained with the hybrid at a
    cap of 16 so that some tiles are harmful and the CSR half runs."""
    scene = build_map(3000, 64, k_per_tile=16, device="cpu")
    cfg = dataclasses.replace(scene.cfg, exact_training="hybrid")
    rgb, depth = scene.frame(scene.c2w)
    return scene.buf, scene.cam, rgb, depth, cfg


def run_iteration(inputs):
    buf, cam, rgb, depth, cfg = inputs
    with tracing.stage("mapper/mapping_iters"):
        mapping_iteration(buf, AdamState.init(buf.params), cam, rgb, depth, cfg)


def total_syncs():
    return sum(v.get("sync", 0) for v in tracing.stage_report_io().values())


@pytest.fixture(scope="module")
def iteration():
    return tiny_iteration_inputs()


def test_profiled_iteration_spans_nest_and_sit_on_the_trace_clock(iteration, tmp_path):
    tracing.set_action(7)
    harmful = tracing.counter("hybrid.harmful_tiles")
    with profiler() as prof:
        run_iteration(iteration)
    assert tracing.counter("hybrid.harmful_tiles") > harmful
    ranges = trace_ranges(prof, tmp_path)
    log = tracing.span_log(ranges)
    names = {r["name"] for r in log}
    assert set(RENDER_SPANS + MAPPER_SPANS) <= names, names
    by_id = {r["id"]: r for r in log}
    for r in log:
        if r["name"].startswith("render/"):
            assert r["action"] == 7
            parent = by_id[r["parent"]]
            assert parent["thread"] == r["thread"]
            assert parent["start"] <= r["start"] and r["end"] <= parent["end"]
        # a trace range of the same name within 1 ms at both ends, beyond the
        # slack of the host's reads (long only where the thread was
        # descheduled while the range opened or closed)
        same = [x for x in ranges if x.name == r["name"]]
        gap = min(max(abs(x.start - r["start"]), abs(x.end - r["end"])) for x in same)
        assert gap < 1e3 + r["slack"], (r, gap)
    [top] = [r for r in log if r["name"] == "mapper/mapping_iters"]
    assert top["parent"] is None
    assert by_id[next(r["parent"] for r in log if r["name"] == "mapper/grad")] is top
    bwd = [r for r in log if r["name"] == "render/gather_bwd"]
    assert len(bwd) == 2  # the capped window's rows and the CSR entries


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # a stage's record_function range is no tensor work
        if not str(func.overloadpacket).startswith("profiler."):
            self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def test_profiler_off_adds_no_record_sync_or_device_work(iteration):
    before = total_syncs()
    run_iteration(iteration)
    syncs_off = total_syncs() - before
    assert tracing.span_log() == []
    before = total_syncs()
    with profiler():
        run_iteration(iteration)
    syncs_on = total_syncs() - before
    log = tracing.span_log()
    assert syncs_off == syncs_on > 0
    assert sum(r["counters"].get("syncs", 0) for r in log) == syncs_on
    # the gather backward's own operations: those of autograd's index
    # backward with the profiler off, and the padding count besides on
    data, ids = gather_case("capped")

    def backward_ops(gather, profiled=False):
        d = data.clone().requires_grad_(True)
        with profiler() if profiled else contextlib.nullcontext():
            rows = gather(d)
            with OpLog() as ops:
                torch.autograd.grad(rows.sum(), d)
        return ops.ops

    def plain(d):
        return raster_tiled._pad_table(d)[ids]

    def function(d):
        return raster_tiled._GatherRows.apply(raster_tiled._pad_table(d), ids)

    off, on = backward_ops(function), backward_ops(function, profiled=True)
    # under a dispatch mode autograd's index backward calls index_put, the
    # functional form; without one it calls _index_put_impl_, as the Function
    d = data.clone().requires_grad_(True)
    rows = plain(d)
    with profiler() as prof:
        torch.autograd.grad(rows.sum(), d)
    assert "aten::_index_put_impl_" in {e.key for e in prof.key_averages()}
    assert off == ["aten._index_put_impl_" if op == "aten.index_put" else op
                   for op in backward_ops(plain)]
    assert Counter(on) - Counter(off) == Counter({"aten.eq": 1, "aten.sum": 1})


def load_metric(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stretch_ctx(actions=2):
    """A stretch from 1,000 to 9,000 us of two actions."""
    stretch = SimpleNamespace(start=1000.0, end=9000.0, actions=actions, ranges=[])
    return SimpleNamespace(stretch=stretch, actions=actions, host_syncs=None)


def rec(i, name, start, parent=None, **counters):
    return {"name": name, "start": start, "end": start + 10.0, "id": i, "parent": parent,
            "thread": 1, "action": 0, "counters": counters}


SYNTHETIC = [
    rec(1, "mapper/mapping_iters", 1500.0, syncs=1),
    rec(2, "render/prepare", 1600.0, parent=1, syncs=2),
    rec(3, "render/csr_layout", 1700.0, parent=2, syncs=3),
    rec(4, "render/gather_bwd", 1800.0, rows=1000, pad_rows=250, table_rows=401, width=11,
        device_us=400.0),
    rec(5, "render/gather_bwd", 2800.0, rows=3000, pad_rows=2000, table_rows=401, width=11,
        device_us=1600.0),
    rec(6, "render/gather_bwd", 9500.0, rows=7, pad_rows=7, table_rows=401, width=11,
        device_us=9.0),  # past the stretch
    rec(7, "queries/topdown", 3000.0, syncs=5),  # not in a mapping event
    rec(8, "mapper/mapping_iters", 500.0, syncs=4),  # starts before the stretch
    rec(9, "render/prepare", 1200.0, parent=8, syncs=1),  # inside it, in the stretch
]


def least_s(rows, table_rows, width):
    return max((rows * width * 4 + rows * 8 + table_rows * width * 4) / 3.35e12,
               rows * width / 67e12)


@pytest.mark.parametrize("name,expected", [
    ("gather.bwd_ms", (400.0 + 1600.0) / 2 * 1e-3),
    ("gather.bwd_share", (least_s(1000, 401, 11) + least_s(3000, 401, 11)) / 2000e-6),
    ("gather.bwd_rows", 4000 / 2),
    ("gather.pad_share", 2250 / 4000),
    ("mapper.iter_syncs", (1 + 2 + 3 + 1) / 2),
])
def test_metrics_read_the_log(monkeypatch, name, expected):
    metric = load_metric(name)
    monkeypatch.setattr(tracing, "span_log", lambda ranges=None: SYNTHETIC)
    assert metric.read(stretch_ctx()) == pytest.approx(expected, rel=1e-12)
    # nothing of its kind in the stretch
    rest = [r for r in SYNTHETIC if r["name"] not in ("render/gather_bwd", "mapper/mapping_iters")]
    monkeypatch.setattr(tracing, "span_log", lambda ranges=None: rest)
    assert metric.read(stretch_ctx()) is None
    # a program without the span log
    monkeypatch.delattr(tracing, "span_log")
    assert metric.read(stretch_ctx()) is None


def test_new_spans_open_inside_the_planner_only_through_existing_ranges(tmp_path):
    """A profiled tiny episode (the bootstrap spin, a target chosen, the
    first steps towards it): every range that opens directly inside a
    planner/* range on the same thread is planner/*, an anchor, or one of
    the ranges that opened there before the render path had spans
    (simulator, mapper/frame, mapper/high_loss, queries/*, runtime/*), so
    planner.host_ms, a self time, keeps its meaning; and the mapper's
    frames carry the action the node set."""
    results_dir = str(tmp_path / "episode")
    ds = SyntheticDataset(BoxWorld.single_room(seed=2),
                          RGBDSensor.from_fov(32, 32, 90.0, depth_min=0.0, depth_max=10.0),
                          step_num=24, start_position=np.array([3.0, 0.0, 3.0]),
                          turn_angle_deg=45.0, tilt_angle_deg=15.0, results_dir=results_dir,
                          scene_id="test-room")
    cfg = MapperConfig(initial_capacity=1 << 12, max_capacity=1 << 13, keyframe_capacity=32,
                       mapping_iters=2, map_every=5, kf_every=5, mapping_window_size=5,
                       chunk=128, kf_select_pixels=128, k_per_tile=64, exact_training="hybrid",
                       exact_online_metrics=False)
    with profiler() as prof:
        run_episode(ds, results_dir, mapper_cfg=cfg, device="cpu", pixel_max=40, max_ticks=4,
                    pano_scale=0.4)
    ranges = trace_ranges(prof, tmp_path)
    by_tid = {}
    for r in ranges:
        by_tid.setdefault(r.tid, []).append(r)
    inside_planner = set()
    for spans in by_tid.values():
        spans.sort(key=lambda r: (r.start, -r.end))
        stack = []
        for r in spans:
            while stack and stack[-1].end <= r.start:
                stack.pop()
            if stack and stack[-1].name.startswith("planner/"):
                inside_planner.add(r.name)
            stack.append(r)
    existing = {"simulator", "mapper/frame", "mapper/high_loss"}
    allowed = [n for n in inside_planner if n.startswith(("planner/", "queries/", "runtime/",
                                                          tracing.ANCHOR)) or n in existing]
    assert sorted(inside_planner) == sorted(allowed)
    # the bootstrap spin's frames, then a target chosen from the top-down
    # maps and the panoramas' scores: renders under the planner's queries
    assert {"simulator", "mapper/frame", "queries/topdown", "queries/panorama_global"} <= \
        inside_planner
    names = {r.name for r in ranges}
    assert {"render/prepare", "render/gather", "render/gather_bwd", "mapper/grad"} <= names
    frames = [r for r in tracing.span_log(ranges) if r["name"] == "mapper/frame"]
    actions = [r["action"] for r in frames]
    assert actions and actions == sorted(actions) and actions[-1] >= 1
