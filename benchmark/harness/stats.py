"""The window's arithmetic: per-action walls from the simulator's step
stamps, their mean over the window and their 90th percentile, and the
spread used to set bounds."""

from __future__ import annotations

import statistics
from typing import List, Sequence


def action_walls(stamps: Sequence[float], end: float) -> List[float]:
    """Each action's wall time: from its step to the next step, the last to
    the window's close."""
    edges = list(stamps) + [end]
    return [b - a for a, b in zip(edges[:-1], edges[1:])]


def action_ms(stamps: Sequence[float], end: float) -> float:
    """The whole window over the actions in it, in ms."""
    return (end - stamps[0]) / len(stamps) * 1e3


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile with linear interpolation between order
    statistics (numpy's default rule)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def beyond(values: Sequence[float], threshold: float) -> int:
    return sum(1 for v in values if v > threshold)


def spread(values: Sequence[float]) -> float:
    """Interquartile distance as a share of the median
    (statistics.quantiles(values, n=4))."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
