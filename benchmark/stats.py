"""The arithmetic of the benchmark's numbers, over all samples of a window:
percentiles, rates, shares, and the busy time of a set of intervals."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of ``values``, interpolated linearly
    between the closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no samples")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work done per second of the whole window."""
    if seconds <= 0:
        raise ValueError("empty window")
    return count / seconds


def share_pct(part: float, whole: float) -> float:
    """``part`` as a percentage of ``whole``."""
    if whole <= 0:
        raise ValueError("nothing to share")
    return 100.0 * part / whole


def union_length(intervals) -> float:
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


def gaps(intervals, start: float, end: float):
    """The idle gaps ``(start, end)`` of ``[start, end]`` that no interval
    covers."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]


def idle_pct(busy: float, window: float) -> float:
    """100 minus the busy share of the window."""
    return 100.0 - share_pct(busy, window)
