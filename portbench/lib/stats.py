"""Statistics of a run's samples."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of all samples by nearest rank: the smallest
    sample that at least 95% of the samples do not exceed."""
    if not values:
        raise ValueError("p95 of no samples")
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The sub-intervals of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]
