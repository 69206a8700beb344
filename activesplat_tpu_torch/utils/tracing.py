"""Stage timers, host-sync and device-to-host copy counters, and the profiler
capture (counterpart of activesplat_tpu/utils/tracing.py).

- `stage(name)`: a context manager that tags the region for torch.profiler
  (`record_function`, so the stage shows up in a device trace) and adds its
  host wall-clock to a per-name sum. Stages nest; each name accumulates.
- `fetch(x)`: the one device-to-host copy of a tensor to numpy. It counts
  copies and bytes against the innermost active stage (where the reference
  counts relay fetches).
- `host_value(x)`: a blocking read of a small tensor as Python numbers, for
  a value the host branches or sizes on (the visible count, the pair and
  entry totals, the harmful tiles, the mapper's metrics). It counts one host
  sync against the innermost active stage.
- `stage_report()`, `stage_report_full()`, `stage_report_io()`,
  `format_stage_report()` and `reset_stages()` read and clear the sums.
- `trace_capture(logdir)`: a torch.profiler trace of the region, written to
  `logdir` or ACTIVESPLAT_TRACE_DIR; a no-op when neither is set.

Stage times are host wall-clock without a synchronize: a stage that ends in
a fetch or a host read includes the device work it waited for, one that
does not measures its dispatch. Device times come from a profiler trace.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_lock = threading.Lock()
_sums: Dict[str, float] = {}
_counts: Dict[str, int] = {}
_maxes: Dict[str, float] = {}
# stage -> {"fetch": copies, "fetch_bytes": bytes, "sync": host reads}; a key
# appears once its event has happened in the stage
_io: Dict[str, Dict[str, int]] = {}
_tls = threading.local()


def _cur_stage() -> Optional[str]:
    stk = getattr(_tls, "stack", None)
    return stk[-1] if stk else None


def _note_io(**incs: int) -> None:
    name = _cur_stage() or "(no stage)"
    with _lock:
        d = _io.setdefault(name, {})
        for key, inc in incs.items():
            d[key] = d.get(key, 0) + inc


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
            _maxes[name] = max(_maxes.get(name, 0.0), dt)


def fetch(x: torch.Tensor) -> np.ndarray:
    """x as a numpy array on the host, counted against the active stage as
    one device-to-host copy of its bytes (a CPU tensor counts too: the
    caller's code path is the same)."""
    a = x.detach().cpu().numpy()
    _note_io(fetch=1, fetch_bytes=int(a.nbytes))
    return a


def host_value(x: torch.Tensor):
    """x.tolist(): a Python number for a 0-d tensor, a list otherwise. The
    host waits for the device to produce it; counted against the active
    stage as one host sync."""
    v = x.detach().tolist()
    _note_io(sync=1)
    return v


def stage_report() -> Dict[str, Tuple[float, int]]:
    """{stage: (total_seconds, calls)} accumulated so far."""
    with _lock:
        return {k: (_sums[k], _counts[k]) for k in _sums}


def stage_report_full() -> Dict[str, Tuple[float, int, float]]:
    """{stage: (total_seconds, calls, max_call_seconds)}: a stage whose max
    is many times its mean had one slow call (a kernel build, an allocator
    growth), not a steady cost."""
    with _lock:
        return {k: (_sums[k], _counts[k], _maxes[k]) for k in _sums}


def stage_report_io() -> Dict[str, Dict[str, int]]:
    """{stage: {"fetch": copies, "fetch_bytes": bytes, "sync": host reads}}
    accumulated so far (each key present once counted)."""
    with _lock:
        return {k: dict(v) for k, v in _io.items()}


def reset_stages() -> None:
    with _lock:
        _sums.clear()
        _counts.clear()
        _maxes.clear()
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


@contextlib.contextmanager
def trace_capture(logdir: Optional[str] = None) -> Iterator[None]:
    """Capture a torch.profiler trace (host and, where there is a card,
    device activity) of the region into `logdir` (or ACTIVESPLAT_TRACE_DIR)
    as a Chrome trace file. No-op when neither is set, so call sites can
    wrap unconditionally."""
    logdir = logdir or os.environ.get("ACTIVESPLAT_TRACE_DIR")
    if not logdir:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
