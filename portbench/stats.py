"""The arithmetic of the end-to-end metrics and of the trace's reduction."""
from __future__ import annotations

import math

SECONDS_PER_YEAR = 365.0 * 86400.0
SECONDS_PER_DAY = 86400.0


def sypd(steps: int, dt: float, wall_s: float) -> float:
    """Simulated years per wall-clock day: all the window's steps times dt,
    over all the window's wall time (CPMIP, Balaji et al., GMD 2017; 365-day
    years)."""
    if steps < 1 or wall_s <= 0:
        raise ValueError(f"a rate needs steps and time, got {steps} steps in {wall_s} s")
    return (steps * dt / SECONDS_PER_YEAR) / (wall_s / SECONDS_PER_DAY)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, linearly interpolated
    between the two nearest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("a percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def intervals_between(stamps) -> list[float]:
    """The gaps between consecutive time stamps: one step's time for each
    stamp after the first."""
    return [b - a for a, b in zip(stamps, stamps[1:])]


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals: the time in which at
    least one of them ran."""
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


def gaps(intervals, start: float, end: float) -> list[tuple[float, float]]:
    """The idle stretches of [start, end] that no interval covers, longest first."""
    out, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])

