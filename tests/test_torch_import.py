"""The port stands alone: it imports neither JAX nor the JAX package, nor
OpenCV, networkx, scikit-learn, PIL, imageio, torchmetrics, trimesh or
PyYAML (which the machine with the card lacks), the Habitat wheels only
inside HabitatDataset.setup(),
its entry points run on CUDA unless told otherwise, and its smoke script
refuses to run without a card."""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import activesplat_tpu_torch
from activesplat_tpu_torch.convert import buffer_from_numpy
from activesplat_tpu_torch.device import resolve_device
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.mapper.keyframes import KeyframeStore
from activesplat_tpu_torch.mapper.splatam import SplaTAMMapper
from activesplat_tpu_torch.models.gaussians import GaussianBuffer, make_camera
from activesplat_tpu_torch.ops import raster_cuda

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "activesplat_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "activesplat_tpu", "cv2", "networkx", "sklearn", "PIL",
             "imageio", "torchmetrics", "trimesh", "yaml")
# imported by the real-simulator branch only, inside this function
HABITAT_WHEELS = ("habitat", "omegaconf")
HABITAT_GATE = ("activesplat_tpu_torch/runtime/habitat_backend.py", "HabitatDataset.setup")


def port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PACKAGE.rglob("*.py")
    )


def imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
        + "import importlib\n"
        + "".join(f"importlib.import_module({m!r})\n" for m in port_modules())
        + "assert not any(m.split('.')[0] in %r for m in sys.modules if sys.modules[m])\n"
        % (FORBIDDEN,)
        + "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py", *sorted(PACKAGE.rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    assert not imported_roots(path) & set(FORBIDDEN)


def wheel_imports(path: Path):
    """(qualified name of the enclosing function, module) of every import
    of the Habitat wheels in `path`."""
    found = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                visit(child, scope + (child.name,))
                continue
            names = []
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                names = [child.module]
            found.extend((".".join(scope), n) for n in names if n.split(".")[0] in HABITAT_WHEELS)
            visit(child, scope)

    visit(ast.parse(path.read_text()), ())
    return found


def test_habitat_wheels_only_inside_setup():
    where = {str(p.relative_to(ROOT)): wheel_imports(p)
             for p in [ROOT / "chip_smoke.py", *PACKAGE.rglob("*.py")]}
    gate_file, gate_fn = HABITAT_GATE
    assert {f for f, found in where.items() if found} == {gate_file}
    assert {fn for fn, _ in where[gate_file]} == {gate_fn}
    assert {m.split(".")[0] for _, m in where[gate_file]} == set(HABITAT_WHEELS)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Here (no CUDA) it exits non-zero and prints no result; alone in a
    directory it cannot find the port either."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_chip_smoke_gradient_check_is_per_column():
    """The smoke holds each gradient column to 1e-5 of its own largest value:
    float32 rounding passes, a zeroed colour column fails even when another
    column's gradients are 1e4 times larger."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(0)
    want = torch.from_numpy(rng.normal(size=(8, 64, 16)).astype(np.float32))
    want[..., 2] *= 1e4  # a conic column, as dx^2 makes it
    want[..., 14:] = 0.0
    limit = smoke.REL_TOL * want.abs().amax(dim=(0, 1))
    share = smoke.check_close("rounding", want * (1 + 1e-7), want, limit)
    assert share < 0.1
    zeroed = want.clone()
    zeroed[..., 6] = 0.0
    smoke.must_reject("zeroed colour column",
                      lambda: smoke.check_close("zeroed", zeroed, want, limit))
    with pytest.raises(AssertionError, match="planted fault"):
        smoke.must_reject("no fault", lambda: smoke.check_close("same", want, want, limit))


def test_entry_points_default_to_cuda(monkeypatch):
    """Without device= the entry points ask for CUDA and raise where there
    is none; device='cpu' runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    intr = np.array([[40.0, 0, 31], [0, 40.0, 23], [0, 0, 1]])
    d = {k: np.zeros(s, np.float32) for k, s in (
        ("means3d", (4, 3)), ("rgb", (4, 3)), ("quats", (4, 4)), ("logit_opacities", (4,)),
        ("log_scales", (4, 3)), ("timestep", (4,)), ("max_radius", (4,)),
        ("grad_accum", (4,)), ("denom", (4,)))}
    d["active"] = np.zeros(4, bool)
    for call in (
        lambda **kw: GaussianBuffer.empty(4, **kw),
        lambda **kw: make_camera(64, 48, intr, np.eye(4), **kw),
        lambda **kw: KeyframeStore.empty(4, 48, 64, **kw),
        lambda **kw: buffer_from_numpy(d, **kw),
        lambda **kw: SplaTAMMapper(MapperConfig(initial_capacity=1024, keyframe_capacity=2),
                                   64, 48, intr, 10, **kw),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_wrappers_refuse_other_devices():
    """A wrapper runs its twin only for CPU tensors; anything else that is
    not CUDA is refused rather than computed somewhere else."""
    rows = torch.zeros((1, 64, 16), device="meta")
    origin = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        raster_cuda.blend_tiles_fwd(rows, origin, origin, 5)


def test_tf32_is_off():
    assert activesplat_tpu_torch.__version__
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
