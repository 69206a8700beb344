"""A scene config's planner block reaches the port's planner FSM, and the
planner's new spans and counters.

The block rides on the dataset (SyntheticDataset, HabitatDataset through
habitat_backend.get_dataset) into the get_dataset_config payload, where
PlannerFSM takes each knob its caller left None: a value passed explicitly
wins, a config without a block keeps the defaults, and an
obstacle_approx_precision other than 7.5 is refused.

Against the JAX package: its PlannerFSM, built by hand with mp3d_large's
knobs passed explicitly (its launcher drops the block), and the port's,
fed the block through the payload, side by side on tests/
test_torch_planner_fsm.py's moving two-room world whose local query always
proposes one more view, so that each refinement runs to its cap. The
same twists, states, targets and logs on every tick, through an arrival
and the refinement after it; the port under Gibson's block (cap 5) parts
from both at that refinement's fifth view.

The counters: on a profiled run the planner/subregions spans carry
`subregions` and `nodes`, planner/select_target (inside planner/tick)
`stay` and `switch`, the tick that ends a refinement `views`, the tick of an
arrival `arrived`; unprofiled, the log stays empty. The benchmark's
reader of the panorama views on a hand-built span log.

All on the CPU with one intra-op thread."""

import contextlib
import copy
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from activesplat_tpu.runtime.bus import Bus as JaxBus
from activesplat_tpu.runtime.planner_fsm import PlannerFSM as JaxPlannerFSM
from activesplat_tpu_torch.configs import load_scene_config
from activesplat_tpu_torch.eval.batch import habitat_dataset_factory, habitat_scene_specs
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.runtime.bus import Bus
from activesplat_tpu_torch.runtime.launch import build_episode_from_config, run_episode
from activesplat_tpu_torch.runtime.mock_habitat import make_mock_sim
from activesplat_tpu_torch.runtime.planner_fsm import PLANNER_DEFAULTS, PlannerFSM
from activesplat_tpu_torch.utils import tracing
from activesplat_tpu_torch.utils.transforms import rot_axis
from tests.test_torch_planner_fsm import MovingWorld

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
MP3D_LARGE = load_scene_config("mp3d_large")
BLOCK = MP3D_LARGE["planner"]
# every knob off its default, so that each one is seen to travel
ALTERED = dict(BLOCK, step_num_as_visited=12, step_num_as_arrived=2.5, local_view_limit=3,
               radius_num_as_rotated=5.0, max_pitch_angle=30)
# mp3d_large's knobs as the JAX package's PlannerFSM takes them
JAX_KNOBS = dict(step_num_as_visited=15, step_num_as_arrived=1.5, local_view_limit=4,
                 radius_num_as_rotated=3.0, max_pitch_angle=45.0,
                 obstacle_approx_precision_m=0.225)
# to the arrival at tick 99 and the refinement after it, 4 views at most
SIDE_BY_SIDE_TICKS = 125


@pytest.fixture(autouse=True)
def empty_log():
    tracing.clear_log()
    yield
    tracing.clear_log()


def knobs(fsm):
    """The FSM's knobs in the block's terms."""
    mpp = fsm.topdown_cfg.meter_per_pixel
    return {"step_num_as_visited": fsm.px_as_visited / fsm.step_px,
            "step_num_as_arrived": fsm.px_as_arrived / fsm.step_px,
            "local_view_limit": fsm.local_view_limit,
            "radius_num_as_rotated": fsm.radius_num_as_rotated,
            "max_pitch_angle": fsm.max_pitch_angle,
            "obstacle_approx_precision_m": fsm.approx_precision_px * mpp}


def expected(block):
    out = {k: pytest.approx(float(block.get(k, d))) for k, d in PLANNER_DEFAULTS.items()}
    out["obstacle_approx_precision_m"] = pytest.approx(0.225)
    return out


def tiny_env_yaml(tmp_path, res=32):
    """The bundled env YAML at res x res."""
    text = (ROOT / "activesplat_tpu_torch" / "configs" / "env"
            / "activesplat_pointnav.yaml").read_text()
    for key in ("width", "height"):
        assert text.count(f"{key}: 256") == 2
        text = text.replace(f"{key}: 256", f"{key}: {res}")
    path = tmp_path / "env.yaml"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("block", [BLOCK, ALTERED], ids=["mp3d_large", "altered"])
def test_the_block_reaches_the_planner_through_the_launcher(block, tmp_path):
    """mp3d_large's scene config through build_episode_from_config (an mp3d
    HabitatDataset on the mock simulator) and run_episode: the FSM the
    episode builds holds each knob of the block."""
    cfg = copy.deepcopy(MP3D_LARGE)
    cfg["env"]["config"] = tiny_env_yaml(tmp_path)
    cfg["planner"] = block
    results_dir = str(tmp_path / "results")
    ep = build_episode_from_config(cfg, results_dir, sim_factory=make_mock_sim,
                                   overrides={"step_num": 4})
    assert ep["dataset"].dataset_config(results_dir)["planner"] == block
    mapper_cfg = MapperConfig(initial_capacity=1 << 12, max_capacity=1 << 13,
                              keyframe_capacity=32, mapping_iters=2, map_every=5, kf_every=5,
                              mapping_window_size=5, chunk=128, kf_select_pixels=128,
                              k_per_tile=64, exact_online_metrics=False)
    _, planner = run_episode(ep["dataset"], results_dir, mapper_cfg=mapper_cfg, pixel_max=40,
                             max_ticks=0, device="cpu")
    assert knobs(planner) == expected(block)


def test_the_block_rides_on_the_synthetic_dataset_and_the_batch_sets(tmp_path):
    synthetic = {"dataset": {"format": "synthetic", "scene_id": "two_room", "seed": 0,
                             "step_num": 4},
                 "env": {"width": 16, "height": 16}, "planner": ALTERED}
    ds = build_episode_from_config(synthetic, None)["dataset"]
    assert ds.dataset_config("")["planner"] == ALTERED
    # the reference's big-scene lists: mp3d_big runs mp3d_large, gibson_big gibson_large
    for name, config in (("mp3d_big", "mp3d_large"), ("gibson_big", "gibson_large")):
        spec = habitat_scene_specs(name)[0]
        ds = habitat_dataset_factory(sim_factory=make_mock_sim)(spec, str(tmp_path / name))
        assert ds.dataset_config("")["planner"] == load_scene_config(config)["planner"]


class Services:
    """The two bus services PlannerFSM reads at construction, from a
    two-room SyntheticDataset whose payload carries `block` (none: the key
    is left out, as an older payload has it)."""

    def __init__(self, block):
        bus = Bus()
        world = MovingWorld(bus, "two_room", "")
        if block is None:
            del world.cfg_ds["planner"]
        else:
            world.cfg_ds["planner"] = block
        self.bus = bus


def test_an_explicit_knob_beats_the_block():
    fsm = PlannerFSM(Services(ALTERED).bus, step_num_as_visited=7, local_view_limit=6,
                     max_pitch_angle=20.0)
    want = expected(ALTERED)
    want.update(step_num_as_visited=pytest.approx(7.0), local_view_limit=6,
                max_pitch_angle=pytest.approx(20.0))
    assert knobs(fsm) == want


@pytest.mark.parametrize("block", [None, {}, {"agent_foot_adjust": 0.1}],
                         ids=["no_key", "empty", "no_knob"])
def test_without_a_block_the_defaults_stand(block):
    fsm = PlannerFSM(Services(block).bus)
    assert knobs(fsm) == expected({})
    assert fsm.local_view_limit == 5 and fsm.max_pitch_angle == 45.0


@pytest.mark.parametrize("value", [5.0, 0.225, 10])
def test_another_obstacle_precision_is_refused(value):
    with pytest.raises(ValueError, match="obstacle_approx_precision"):
        PlannerFSM(Services(dict(BLOCK, obstacle_approx_precision=value)).bus)
    # passed explicitly, it wins and the block's value is not read
    fsm = PlannerFSM(Services(dict(BLOCK, obstacle_approx_precision=value)).bus,
                     obstacle_approx_precision_m=0.3)
    assert knobs(fsm)["obstacle_approx_precision_m"] == pytest.approx(0.3)


class EveryViewWorld(MovingWorld):
    """The moving world, its local query proposing one more view (0.7 rad
    to the left of the camera) every time, so that each refinement runs to
    its cap."""

    def opacity(self, arrived, positions=None, nodes=None):
        if arrived:
            return super().opacity(arrived, positions, nodes)
        self.local_calls += 1
        return {"targets_frustums": [rot_axis(self.ds.camera_c2w(), "y", 0.7)],
                "targets_frustums_invisibility": [1.0], "targets_frustums_volume": [0.0]}


def side_by_side(bus_cls, fsm_cls, tmp_path, block=None, profiled=False, **kw):
    """Run an FSM on the every-view world (under torch.profiler when
    `profiled`); the trace of (state, target, twists, path) after each tick,
    and the decision log."""
    np.random.seed(0)  # the Voronoi sampling jitter's global stream
    bus = bus_cls()
    world = EveryViewWorld(bus, "two_room", tmp_path)
    if block is not None:
        world.cfg_ds["planner"] = block
    fsm = fsm_cls(bus, seed=3, **kw)
    twists = []
    bus.subscribe("cmd_vel", lambda t: twists.append((tuple(t["linear"]), tuple(t["angular"]))))
    trace = []
    with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
          if profiled else contextlib.nullcontext()):
        for _ in range(SIDE_BY_SIDE_TICKS):
            n = len(twists)
            fsm.tick()
            path = fsm.navigation_path
            trace.append((fsm.state.value, fsm.navigation_target_index, twists[n:],
                          None if path is None else path.tolist()))
    return trace, fsm.decision_log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("side_by_side")
    tracing.clear_log()
    return {
        "jax": side_by_side(JaxBus, JaxPlannerFSM, tmp / "jax", **JAX_KNOBS),
        "port": side_by_side(Bus, PlannerFSM, tmp / "port", block=BLOCK, profiled=True),
        "span_log": tracing.span_log(),
        "gibson": side_by_side(Bus, PlannerFSM, tmp / "gibson",
                               block=load_scene_config("gibson")["planner"]),
        "gibson_span_log": tracing.span_log(),
    }


def refines(log):
    """(index of the tick that began it, of the tick that ended it) of each
    local refinement that ended (a state change is logged with the count of
    ticks done, the events inside a tick with its index)."""
    out, begin = [], None
    for e in log:
        if e["event"] == "refine_begin":
            begin = e["tick"]
        elif e["event"] == "state" and e["frm"] == "LOCAL_REFINE" and begin is not None:
            out.append((begin, e["tick"] - 1))
            begin = None
    return out


def test_side_by_side_with_the_reference_under_mp3d_large(runs):
    (jtrace, jlog), (ttrace, tlog) = runs["jax"], runs["port"]
    for tick, (a, b) in enumerate(zip(jtrace, ttrace)):
        assert a == b, f"tick {tick}: reference {a[:2]}, port {b[:2]}"
    assert tlog == jlog
    # a refinement that continues no global navigation began and ended
    arrival = [e for e in tlog if e["event"] == "refine_begin" and not e["continue_global"]]
    assert arrival and any(b == arrival[-1]["tick"] for b, _ in refines(tlog))


def test_gibsons_cap_parts_from_mp3d_large_at_the_fifth_view(runs):
    """Gibson's block differs in step_num_as_visited (10) and
    local_view_limit (5): the two runs agree until the arrival's
    refinement, where Gibson's FSM turns to a fifth view."""
    (ttrace, tlog), (gtrace, _) = runs["port"], runs["gibson"]
    first = next(i for i, (a, b) in enumerate(zip(ttrace, gtrace)) if a != b)
    begin, end = refines(tlog)[-1]
    assert begin < first <= end
    assert gtrace[first][0] == "LOCAL_REFINE"


def test_counters_on_their_spans_with_the_profiler_on(runs):
    log = runs["span_log"]
    by_id = {r["id"]: r for r in log}
    select = [r for r in log if r["name"] == "planner/select_target"]
    assert select
    for r in select:
        assert by_id[r["parent"]]["name"] == "planner/tick"
        assert r["counters"].keys() == {"stay", "switch"}
        assert r["counters"]["stay"] + r["counters"]["switch"] <= 1
    # planner/subregions opens inside the selection's tick
    sub = [r for r in log if r["name"] == "planner/subregions"]
    assert len(sub) == len(select)
    for r in sub:
        assert by_id[r["parent"]]["name"] == "planner/select_target"
        assert r["counters"]["subregions"] == 2 and r["counters"]["nodes"] >= 2
    ticks = [r for r in log if r["name"] == "planner/tick"]
    assert len(ticks) == SIDE_BY_SIDE_TICKS
    views = [r["counters"]["views"] for r in ticks if "views" in r["counters"]]
    assert len(views) == len(refines(runs["port"][1])) and max(views) == 4
    # an arrival ends the navigation: a refinement begins there, or a bounce
    arrived = [i for i, r in enumerate(ticks) if r["counters"].get("arrived")]
    assert arrived
    for i in arrived:
        assert any(e["tick"] == i and e["event"] in ("refine_begin", "bounce")
                   for e in runs["port"][1])
    # nothing is logged with the profiler off
    assert runs["gibson_span_log"] == log


def load_metric(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rec(i, name, start, parent=None, **counters):
    return {"name": name, "start": start, "end": start + 10.0, "id": i, "parent": parent,
            "thread": 1, "action": 0, "counters": counters}


# a stretch from 1,000 to 9,000 us of four actions
SPANS = [
    rec(1, "planner/tick", 1100.0),
    rec(2, "planner/select_target", 1110.0, parent=1, stay=1, switch=0),
    rec(3, "planner/subregions", 1120.0, parent=2, subregions=2, nodes=11),
    rec(4, "queries/panorama_global", 1130.0, parent=2, views=12),
    rec(5, "planner/tick", 2000.0, views=4),
    rec(6, "queries/panorama_local", 2010.0, parent=5, views=3),
    rec(7, "planner/tick", 3000.0, arrived=1),
    rec(8, "planner/subregions", 4000.0, subregions=3, nodes=17),
    rec(9, "planner/tick", 5000.0, views=1),
    rec(10, "planner/subregions", 5100.0),  # a program without the counter
    rec(11, "planner/subregions", 9500.0, subregions=9, nodes=40),  # past the stretch
    rec(12, "planner/tick", 500.0, views=5),  # before it
    rec(13, "queries/panorama_local", 9800.0, views=3),  # past it
    rec(14, "queries/topdown", 6000.0, views=7),  # not a panorama
]


@pytest.mark.parametrize("name,expected_value,start,end", [
    ("queries.pano_views", (12 + 3) / 4, 1000.0, 9000.0),
    ("queries.pano_views", 3 / 4, 2000.0, 9000.0),  # the global query before the stretch
    ("queries.pano_views", 12 / 4, 1000.0, 2005.0),  # the local query past it
])
def test_readers_read_the_log(monkeypatch, name, expected_value, start, end):
    metric = load_metric(name)
    stretch = SimpleNamespace(start=start, end=end, actions=4, ranges=[])
    ctx = SimpleNamespace(stretch=stretch, actions=4, host_syncs=None)
    monkeypatch.setattr(tracing, "span_log", lambda ranges=None: SPANS)
    assert metric.read(ctx) == pytest.approx(expected_value, rel=1e-12)
    # the parent program: the spans without the new counters
    bare = [dict(r, counters={}) for r in SPANS]
    monkeypatch.setattr(tracing, "span_log", lambda ranges=None: bare)
    assert metric.read(ctx) is None
    monkeypatch.setattr(tracing, "span_log", lambda ranges=None: [])
    assert metric.read(ctx) is None
    monkeypatch.delattr(tracing, "span_log")
    assert metric.read(ctx) is None


def test_the_benchmark_config_is_the_bundled_one_with_its_cut(tmp_path):
    bench = json.loads((ROOT / "benchmark" / "configs" / "mp3d_large.json").read_text())
    assert bench.pop("benchmark")["scene"] == {"room": "two_room", "seed": 0}
    assert bench["dataset"].pop("step_num") == 100000
    source = copy.deepcopy(MP3D_LARGE)
    assert source["dataset"].pop("step_num") == 2000
    assert bench == source
