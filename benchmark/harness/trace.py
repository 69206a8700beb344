"""Reading a torch.profiler Chrome trace over a stretch of whole actions.

The stretch runs from one `bench/action` marker (a zero-length range the
harness's simulator clock opens at every step) to another. Host ranges are
the program's `record_function` ranges (its tracing stages); device
intervals are the kernels, copies and sets that ran on the card.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

MARKER = "bench/action"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Span(NamedTuple):
    name: str
    start: float  # microseconds
    end: float
    tid: int


class Stretch(NamedTuple):
    start: float
    end: float
    actions: int
    ranges: List[Span]  # host ranges (program stages), every thread
    device: List[Span]  # device intervals

    @property
    def wall_us(self) -> float:
        return self.end - self.start


def load(path: str, first_action: int, actions: int) -> Stretch:
    """The stretch from the first_action-th marker of the trace to the
    (first_action + actions)-th."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    ranges, device, markers = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        span = Span(e.get("name", ""), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e.get("tid", 0) if isinstance(e.get("tid", 0), int) else 0)
        if cat == "user_annotation":
            if span.name == MARKER:
                markers.append(span.start)
            else:
                ranges.append(span)
        elif cat in DEVICE_CATS:
            device.append(span)
    markers.sort()
    if len(markers) < first_action + actions + 1:
        raise RuntimeError(f"the trace holds {len(markers)} action markers, "
                           f"{first_action + actions + 1} needed")
    return Stretch(markers[first_action], markers[first_action + actions], actions, ranges,
                   device)


def clip(a: float, b: float, s: Stretch) -> float:
    return max(0.0, min(b, s.end) - max(a, s.start))


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def device_busy_us(s: Stretch) -> float:
    """Length of the union of device intervals inside the stretch."""
    return sum(clip(a, b, s) for a, b in union([(d.start, d.end) for d in s.device]))


def kernel_us(s: Stretch, names) -> float:
    """Device time of the kernels whose name contains one of `names`."""
    return sum(clip(d.start, d.end, s) for d in s.device if any(n in d.name for n in names))


def _matches(name: str, pattern: str) -> bool:
    if pattern.endswith("*"):
        return name.startswith(pattern[:-1])
    return name == pattern


def inclusive_us(s: Stretch, pattern: str) -> float:
    """Length inside the stretch of the outermost ranges matching `pattern`
    (a name, or a prefix ending in '*'): a matching range nested in another
    is not counted twice."""
    spans = sorted((r for r in s.ranges if _matches(r.name, pattern)),
                   key=lambda r: (r.tid, r.start, -r.end))
    total, cover_end, cover_tid = 0.0, float("-inf"), None
    for r in spans:
        if r.tid == cover_tid and r.end <= cover_end:
            continue
        total += clip(r.start, r.end, s)
        cover_end, cover_tid = r.end, r.tid
    return total


def self_us(s: Stretch, pattern: str) -> float:
    """Self time inside the stretch of the ranges matching `pattern`: each
    range's length less the parts of it its direct child ranges cover."""
    by_tid: Dict[int, List[Span]] = defaultdict(list)
    for r in s.ranges:
        by_tid[r.tid].append(r)
    total = 0.0
    for spans in by_tid.values():
        spans.sort(key=lambda r: (r.start, -r.end))
        stack: List[List] = []  # [span, child time]
        done: List[Tuple[Span, float]] = []
        for r in spans:
            while stack and stack[-1][0].end <= r.start:
                done.append(tuple(stack.pop()))
            if stack:
                stack[-1][1] += clip(r.start, min(r.end, stack[-1][0].end), s)
            stack.append([r, 0.0])
        done.extend(tuple(x) for x in stack)
        total += sum(clip(r.start, r.end, s) - child for r, child in done
                     if _matches(r.name, pattern))
    return total


def innermost(s: Stretch, t: float, tid: Optional[int] = None) -> str:
    best = None
    for r in s.ranges:
        if r.start <= t < r.end and (tid is None or r.tid == tid):
            if best is None or r.end - r.start < best.end - best.start:
                best = r
    return best.name if best is not None else "(no program range)"


def breakdown(s: Stretch, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time in the stretch, and the idle
    gaps grouped by the innermost program range open on the host during
    each (at its midpoint), in seconds."""
    ops: Dict[str, float] = defaultdict(float)
    for d in s.device:
        ops[d.name[:160]] += clip(d.start, d.end, s)
    busy = union([(max(d.start, s.start), min(d.end, s.end)) for d in s.device
                  if d.end > s.start and d.start < s.end])
    gaps: Dict[str, float] = defaultdict(float)
    edges = [s.start] + [x for ab in busy for x in ab] + [s.end]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[innermost(s, 0.5 * (a + b))] += b - a

    def ranked(d):
        return [[k, v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}
