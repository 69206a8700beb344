"""Stage timers, host-sync and device-to-host copy counters, running
counters, the span log, and the profiler capture (counterpart of
activesplat_tpu/utils/tracing.py).

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
- `count(name, inc)`: a running total by name (`counter(name)` reads it),
  such as the hybrid render's calls and harmful tiles.
- `stage_report()`, `stage_report_full()`, `stage_report_io()`,
  `format_stage_report()` and `reset_stages()` read and clear the sums.
- `trace_capture(logdir)`: a torch.profiler trace of the region, written to
  `logdir` or ACTIVESPLAT_TRACE_DIR; a no-op when neither is set.

Stage times are host wall-clock without a synchronize: a stage that ends in
a fetch or a host read includes the device work it waited for, one that
does not measures its dispatch. Device times come from a profiler trace.

The span log. Only while torch.profiler records (`torch.autograd.
_profiler_enabled()`), each stage leaves one record in a bounded in-memory
log when it closes: its name, host start and end (read just outside the
profiler range, with the slack of those reads), its span id, the id of
the stage open around it on the same thread (its parent), the thread's
native id (the trace's tid), the action number the mapper node last set
(`set_action`, a module variable, so the autograd thread sees it too), and
the counters attached to it while it was open:
- `syncs`: the host syncs (`host_value`) made while it was the innermost
  open record of its thread;
- what `count` adds while it is the innermost open record;
- what `attach` sets on it: a number, a device tensor (read when the log
  is read) or a pair of CUDA timing events (their elapsed time in
  microseconds, resolved when the log is read), so recording adds no host
  sync.
The log's times are on the host's perf_counter. To put them on the
trace's clock, the first record after the log was empty (`clear_log`) and
every `set_action` while the profiler records open a zero-length range
`tracing/anchor/<i>` and keep the host time taken beside it; a record
belongs to the latest anchor at its start. `span_log(ranges)` finds each
record's anchor among the trace's ranges and shifts the record by the
anchor's offset; a record whose anchor the trace lacks (it was logged
under another profiler session and no anchor came since) is left out.

With the profiler off, a stage checks that one flag and does nothing more
than before: no record, no event, no device reduction, no host sync.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Deque, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

_lock = threading.Lock()
_sums: Dict[str, float] = {}
_counts: Dict[str, int] = {}
_maxes: Dict[str, float] = {}
# stage -> {"fetch": copies, "fetch_bytes": bytes, "sync": host reads}; a key
# appears once its event has happened in the stage
_io: Dict[str, Dict[str, int]] = {}
# running totals of count(); never cleared, read as differences
_counters: Dict[str, int] = {}
_tls = threading.local()

_profiling = torch.autograd._profiler_enabled

ANCHOR = "tracing/anchor/"
ANCHOR_SLACK = 200e-6  # s; a profiled range takes tens of microseconds to open
LOG_CAPACITY = 1 << 18
_log: Deque["_Record"] = collections.deque(maxlen=LOG_CAPACITY)
_anchors: List[Tuple[str, float]] = []  # (range name, host perf_counter seconds)
_span_ids = itertools.count(1)
_action: Optional[int] = None


class _Record:
    __slots__ = ("name", "start", "end", "slack", "id", "parent", "thread", "action", "anchor",
                 "counters")

    def __init__(self, name: str, parent: Optional[int]) -> None:
        self.name, self.start, self.end, self.slack = name, 0.0, 0.0, 0.0
        self.id, self.parent = next(_span_ids), parent
        self.thread = threading.get_native_id()
        self.action = _action
        self.anchor = len(_anchors) - 1
        self.counters: Dict[str, object] = {}


def _cur_stage() -> Optional[str]:
    stk = getattr(_tls, "stack", None)
    return stk[-1] if stk else None


def _note_io(**incs: int) -> None:
    name = _cur_stage() or "(no stage)"
    with _lock:
        d = _io.setdefault(name, {})
        for key, inc in incs.items():
            d[key] = d.get(key, 0) + inc


def _anchor() -> None:
    """A zero-length trace range whose host time, read just before it
    opens, is kept beside it. A thread descheduled between the read and the
    range would misplace the clock, so it is tried again (at most 16 times,
    the last one kept) until the range has opened within ANCHOR_SLACK of
    the read."""
    with _lock:
        for _ in range(16):
            name = f"{ANCHOR}{len(_anchors)}"
            rf = torch.profiler.record_function(name)
            t = time.perf_counter()
            rf.__enter__()
            opened = time.perf_counter()
            rf.__exit__(None, None, None)
            _anchors.append((name, t))
            if opened - t < ANCHOR_SLACK:
                break


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Time a named stage and tag it for the profiler; while the profiler
    records, log it as a span."""
    stk = getattr(_tls, "stack", None)
    if stk is None:
        stk = _tls.stack = []
    stk.append(name)
    t0 = time.perf_counter()
    rec = None
    if _profiling():
        if not _anchors:
            _anchor()
        recs = getattr(_tls, "records", None)
        if recs is None:
            recs = _tls.records = []
        rec = _Record(name, recs[-1].id if recs else None)
        recs.append(rec)
    try:
        if rec is None:
            with torch.profiler.record_function(name):
                yield
        else:
            # the host's clock read just before the range opens and just
            # after it closes; `slack`, the longer of the two brackets, is
            # how far the range's own ends may lie inside them
            rf = torch.profiler.record_function(name)
            rec.start = time.perf_counter()
            rf.__enter__()
            opened = time.perf_counter()
            try:
                yield
            finally:
                closing = time.perf_counter()
                rf.__exit__(None, None, None)
                rec.end = time.perf_counter()
                rec.slack = max(opened - rec.start, rec.end - closing)
    finally:
        dt = time.perf_counter() - t0
        stk.pop()
        if rec is not None:
            _tls.records.remove(rec)
            _log.append(rec)
        with _lock:
            _sums[name] = _sums.get(name, 0.0) + dt
            _counts[name] = _counts.get(name, 0) + 1
            _maxes[name] = max(_maxes.get(name, 0.0), dt)


def recording() -> bool:
    """Whether a logged span is open on this thread (so `attach` keeps what
    it is given)."""
    return bool(getattr(_tls, "records", None))


def attach(**values) -> None:
    """Set counters on the innermost logged span open on this thread; a
    no-op when none is. A value may be a number, a device tensor or a pair
    of CUDA timing events (see the module docstring)."""
    recs = getattr(_tls, "records", None)
    if recs:
        recs[-1].counters.update(values)


def _add_to_span(name: str, inc: int) -> None:
    recs = getattr(_tls, "records", None)
    if recs:
        c = recs[-1].counters
        c[name] = c.get(name, 0) + inc


def count(name: str, inc: int = 1) -> None:
    """Add `inc` to the running total `name`, and to the counter of that
    name on the innermost logged span open on this thread."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + inc
    _add_to_span(name, inc)


def counter(name: str) -> int:
    """The running total of `count(name, ...)` so far (0 before any)."""
    with _lock:
        return _counters.get(name, 0)


def set_action(n: int) -> None:
    """The action number the log's records carry from now on; while the
    profiler records, also a fresh anchor."""
    global _action
    _action = n
    if _profiling():
        _anchor()


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
    stage as one host sync, and on the innermost logged span."""
    v = x.detach().tolist()
    _note_io(sync=1)
    _add_to_span("syncs", 1)
    return v


def _resolve(value):
    if isinstance(value, torch.Tensor):
        return value.item()
    if isinstance(value, tuple):  # (start, end) CUDA timing events
        value[1].synchronize()
        return value[0].elapsed_time(value[1]) * 1e3
    return value


def span_log(ranges: Optional[Iterable] = None) -> List[Dict]:
    """The logged spans as dicts (name, start, end, slack, id, parent,
    thread, action, counters), counters resolved; the trace's range of a
    span lies inside [start, end], each of its ends within `slack` of
    them. `ranges`: the ranges of the
    profiler trace the spans were logged under (objects with .name and
    .start in microseconds); each span is then put on the trace's clock, in
    microseconds, by its anchor, and a span whose anchor the trace lacks is
    left out. Without `ranges`, times are the host's perf_counter in
    microseconds."""
    offsets: Dict[int, float] = {}
    if ranges is not None:
        traced = {r.name: r.start for r in ranges if r.name.startswith(ANCHOR)}
        for i, (name, host) in enumerate(list(_anchors)):
            if name in traced:
                offsets[i] = traced[name] - host * 1e6
    out = []
    for rec in list(_log):
        if ranges is None:
            off = 0.0
        elif rec.anchor in offsets:
            off = offsets[rec.anchor]
        else:
            continue
        for key, value in rec.counters.items():
            rec.counters[key] = _resolve(value)
        out.append({"name": rec.name, "start": rec.start * 1e6 + off,
                    "end": rec.end * 1e6 + off, "slack": rec.slack * 1e6, "id": rec.id,
                    "parent": rec.parent, "thread": rec.thread, "action": rec.action,
                    "counters": dict(rec.counters)})
    return out


def clear_log() -> None:
    """Drop the logged spans and their anchors."""
    with _lock:
        _log.clear()
        _anchors.clear()


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
