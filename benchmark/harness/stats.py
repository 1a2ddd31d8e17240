"""Order statistics of the host-clock records."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, linear between the
    two nearest ranks (numpy's default, ``statistics.quantiles``' inclusive
    method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    gaps, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def in_window(stamps: Sequence[float], start: float, end: float) -> List[float]:
    return [t for t in stamps if start <= t <= end]


def gaps_ms(stamps: Sequence[float]) -> List[float]:
    """Present-to-present gaps, ms, of consecutive stamps."""
    xs = sorted(stamps)
    return [(b - a) * 1e3 for a, b in zip(xs, xs[1:])]


def completions_at(stamps: Sequence[float], t: float) -> float:
    """The count of completions by time ``t``, linear between consecutive
    completions (the ``i``-th completion, from 1, counts ``i`` at its stamp),
    so that a rate over a window holds the partial frames at its two ends."""
    xs = sorted(stamps)
    if not xs or t < xs[0] or t > xs[-1]:
        raise ValueError("the window must lie between the first and the last completion")
    import bisect

    i = bisect.bisect_right(xs, t)  # completions at or before t
    if i == len(xs):
        return float(i)
    return i + (t - xs[i - 1]) / (xs[i] - xs[i - 1])
