"""Stage timers and device-to-host copy counters (counterpart of the stage and
fetch half of activesplat_tpu/utils/tracing.py).

- `stage(name)`: a context manager that tags the region for torch.profiler
  (`record_function`, so the stage shows up in a device trace) and adds its
  host wall-clock to a per-name sum. Stages nest; each name accumulates.
- `fetch(x)`: the one device-to-host copy of a tensor to numpy. It counts
  copies and bytes against the innermost active stage (where the reference
  counts relay fetches).
- `stage_report()`, `stage_report_io()`, `format_stage_report()` and
  `reset_stages()` read and clear the sums.

Stage times are host wall-clock without a synchronize: a stage that ends in
a fetch includes the device work it waited for, one that does not measures
its dispatch. Device times come from a torch.profiler trace.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_lock = threading.Lock()
_sums: Dict[str, float] = {}
_counts: Dict[str, int] = {}
_io: Dict[str, Dict[str, int]] = {}  # stage -> {"fetch": copies, "fetch_bytes": bytes}
_tls = threading.local()


def _cur_stage() -> Optional[str]:
    stk = getattr(_tls, "stack", None)
    return stk[-1] if stk else None


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Time a named stage and tag it for the profiler."""
    stk = getattr(_tls, "stack", None)
    if stk is None:
        stk = _tls.stack = []
    stk.append(name)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        stk.pop()
        with _lock:
            _sums[name] = _sums.get(name, 0.0) + dt
            _counts[name] = _counts.get(name, 0) + 1


def fetch(x: torch.Tensor) -> np.ndarray:
    """x as a numpy array on the host, counted against the active stage as
    one device-to-host copy of its bytes (a CPU tensor counts too: the
    caller's code path is the same)."""
    a = x.detach().cpu().numpy()
    name = _cur_stage() or "(no stage)"
    with _lock:
        d = _io.setdefault(name, {"fetch": 0, "fetch_bytes": 0})
        d["fetch"] += 1
        d["fetch_bytes"] += int(a.nbytes)
    return a


def stage_report() -> Dict[str, Tuple[float, int]]:
    """{stage: (total_seconds, calls)} accumulated so far."""
    with _lock:
        return {k: (_sums[k], _counts[k]) for k in _sums}


def stage_report_io() -> Dict[str, Dict[str, int]]:
    """{stage: {"fetch": copies, "fetch_bytes": bytes}} accumulated so far."""
    with _lock:
        return {k: dict(v) for k, v in _io.items()}


def reset_stages() -> None:
    with _lock:
        _sums.clear()
        _counts.clear()
        _io.clear()


def format_stage_report() -> str:
    rows = sorted(stage_report().items(), key=lambda kv: -kv[1][0])
    if not rows:
        return "no stages recorded"
    width = max(len(k) for k, _ in rows)
    return "\n".join(
        f"{k:<{width}}  {tot:8.3f} s  /{cnt:6d} calls  = {tot / cnt * 1000:8.2f} ms/call"
        for k, (tot, cnt) in rows
    )
