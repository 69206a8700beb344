"""Build the CUDA sources under csrc/ into shared libraries, at first use.

Each `csrc/<name>.cu` becomes `build/lib<name>-<hash>.so` at the checkout's
root, keyed by a hash of the source and the compiler flags, so a changed
source is rebuilt and an unchanged one is loaded as it is. The libraries have
a plain C interface and are loaded with ctypes: no PyTorch headers, so each
builds in seconds. All missing sources are compiled at once, one nvcc process
each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = (
    "blend_fwd", "blend_bwd", "blend_csr_fwd", "blend_csr_bwd", "blend_csr_dual", "bin_slots"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA toolkit is "
        "installed (set NVCC to its path)"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library of `names` in parallel; return paths.
    The compiler's report (registers, shared memory, spills) is kept beside
    each library as <library>.log."""
    paths = {name: library_path(name) for name in names}
    missing = [n for n in names if not paths[n].exists()]
    if not missing:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        tmp = BUILD_DIR / f"{paths[name].name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            tmp,
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
        )
    errors = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        os.replace(tmp, paths[name])  # atomic: concurrent builders agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library `name`, building all sources first if needed."""
    if name not in _loaded:
        paths = build()
        for n, path in paths.items():
            _loaded.setdefault(n, ctypes.CDLL(str(path)))
    return _loaded[name]
