"""The benchmark's own tests. They run on the CPU, apart from those marked
`card`, which skip without a CUDA card.

    python -m pytest benchmark/ -q
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import stats  # noqa: E402
from benchmark.harness import trace as T  # noqa: E402
from benchmark.harness.episode import BENCH, cell_files, load_json, load_kind  # noqa: E402

MANIFEST = load_json(ROOT / "BENCHMARK.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "activesplat_tpu")


def test_rate_and_p90_over_known_stamps():
    stamps, end = [10.0, 10.1, 10.3, 10.6, 11.0], 11.5
    walls = stats.action_walls(stamps, end)
    assert np.allclose(walls, [0.1, 0.2, 0.3, 0.4, 0.5])
    assert stats.action_ms(stamps, end) == pytest.approx(1500.0 / 5)
    assert stats.percentile(walls, 90) == pytest.approx(np.percentile(walls, 90))
    assert stats.beyond(walls, stats.percentile(walls, 90)) == 1
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)


def _stretch():
    s = T.Span
    ranges = [
        s("planner/tick", 0, 100, 1), s("simulator", 10, 20, 1), s("mapper/frame", 30, 80, 1),
        s("mapper/mapping_iters", 40, 70, 1), s("planner/scores", 85, 95, 1),
        s("queries/topdown", 82, 84, 1), s("queries/topdown/full", 82.5, 83.5, 1),
        s("planner/tick", 100, 150, 1),  # past the stretch's end: clipped away
    ]
    device = [s("k1", 5, 15, 0), s("k2", 10, 25, 0), s("indexing_backward_kernel<float>", 50, 60, 0),
              s("k3", 95, 130, 0)]
    return T.Stretch(0.0, 100.0, 4, ranges, device)


def test_self_time_inclusive_time_and_idle_share():
    st = _stretch()
    # planner/tick: 100 - (10 + 50 + 10 + 2) = 28, planner/scores 10
    assert T.self_us(st, "planner/*") == pytest.approx(38.0)
    assert T.inclusive_us(st, "mapper/frame") == pytest.approx(50.0)
    assert T.inclusive_us(st, "queries/*") == pytest.approx(2.0)  # outermost only
    assert T.device_busy_us(st) == pytest.approx(20 + 10 + 5)
    assert T.kernel_us(st, ("indexing_backward_kernel",)) == pytest.approx(10.0)
    bd = T.breakdown(st)
    assert bd["device_ops"][0][0] == "k2"
    gaps = dict(bd["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx((100 - 35) * 1e-6)
    assert gaps["mapper/frame"] == pytest.approx(60e-6)  # 25-50 and 60-95, by midpoint


def _metric_reader(name):
    from benchmark.harness.episode import load_metric

    return load_metric(name)


def test_every_name_resolves_to_its_files():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for conf in MANIFEST["configs"]:
        path = ROOT / conf["file"]
        assert path.is_file() and conf["file"].startswith("benchmark/")
        data = load_json(path)
        for key in conf["reduced"]:
            assert key in data
        bench = data["benchmark"]
        yaml = (BENCH / "configs" / "env" / Path(data["env"]["config"]).name).read_text()
        for key in ("width", "height"):
            assert yaml.count(f"{key}: {bench['camera'][key]}") == 2
    for w in MANIFEST["workloads"]:
        files = cell_files(w["name"], MANIFEST)
        assert callable(load_kind(files["traffic"]["kind"]).run)
        assert set(files["limits"]) >= {"loss_gap", "grad_gap", "step_gap"}
    for m in MANIFEST["per_layer"]:
        assert callable(_metric_reader(m["name"]).read)
        assert set(m.get("workloads", cells)) <= cells


def test_configs_keep_every_source_key_outside_reduced():
    for conf in MANIFEST["configs"]:
        data = load_json(ROOT / conf["file"])
        source = load_json(ROOT / "activesplat_tpu_torch" / "configs" / "datasets"
                           / f"{conf['name']}.json")
        for key, value in source.items():
            if key not in conf["reduced"]:
                assert data[key] == value, key


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_program_or_jax():
    mods = _loaded_after(
        "import sys, json; sys.path.insert(0, '.');"
        "import benchmark.reference.checks, benchmark.reference.render, benchmark.sim.boxworld;"
        "print(json.dumps(sorted(sys.modules)))")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {*FORBIDDEN, "activesplat_tpu_torch"}


def _cpu_run(*args, timeout=900):
    out = subprocess.run([sys.executable, str(BENCH / "tools" / "cpu_run.py"), *args],
                         cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2])["forbidden"], json.loads(lines[-1])


def test_a_whole_run_on_the_cpu_is_correct_and_loads_no_jax():
    forbidden, result = _cpu_run("--seed", "2147483693", "--trace", "1", "--seconds", "12")
    assert forbidden == []
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    assert {"episode.host_syncs", "planner.host_ms", "mapper.frame_ms"} <= set(result["metrics"])


@pytest.mark.parametrize("fault,warm,caught", [
    ("unchanged_step", 20, "step_gap"),
    ("half_batch", 20, "loss_gap"),
    ("altered_gradient", 20, "grad_gap"),
    ("altered_topdown", 90, "topdown_px"),
    ("altered_densify", 20, "densify_px"),
])
def test_a_planted_fault_makes_the_run_incorrect(fault, warm, caught):
    _, result = _cpu_run("--seed", "11", "--fault", fault, "--warm", str(warm),
                         "--seconds", "12")
    assert result["correct"] is False
    check = result["checks"][caught]
    assert check["value"] > check["limit"]


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_the_control_is_not_correct_on_the_card(workload):
    """The reference under TF32 (the nearest precision below the stated
    float32 with TF32 off), put in the program's place, fails a limit at the
    cell's own size, while the program passes."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.harness.episode import run_cell

    readings = {}
    result = run_cell(workload, 7, 20.0, False, variants=("program", "control"),
                      readings=readings, log=lambda m: None)
    limits = cell_files(workload, MANIFEST)["limits"]
    assert result["correct"] is True, result["checks"]
    assert any(v > limits[k] for k, v in readings["control"].items()), readings
