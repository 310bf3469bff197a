"""The benchmark's arithmetic: rates, tails, the device's busy and idle
time over a window, and the relative L1 gap, on plain numbers and
interval lists, so that the tests can hold it to made-up inputs."""

from __future__ import annotations

import numpy as np


def rate(work: float, seconds: float) -> float:
    """Work per second over a whole window."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return work / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, linear between the
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def idle_pct(intervals, lo: float, hi: float) -> float:
    """Share of [lo, hi] in which no interval runs, in percent."""
    return 100.0 * (1.0 - union(intervals, lo, hi) / (hi - lo))


def rel_l1(got, want) -> float:
    """sum |got - want| / sum |want| over two arrays of one shape."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    num, den = np.abs(got - want).sum(), np.abs(want).sum()
    return float(num / den) if den else (0.0 if num == 0 else float("inf"))
