"""Arithmetic of the metrics, free of any device: a percentile over all
requests, a rate over a whole window, and the union of intervals."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least ``q`` of the values at or below it. A missing value is
    ``math.inf``, so a failed request counts above every served one."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(math.ceil(q * len(ordered)) - 1, 0)]


def rate(amount: float, seconds: float) -> float:
    """All the work of a window over all of its time."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return amount / seconds


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of [start, end) intervals: the time in which
    at least one ran (two overlapping kernels count once)."""
    total, end = 0.0, -math.inf
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]
