"""The harness's arithmetic: percentiles, spreads, unions of intervals, seeds."""

from __future__ import annotations

import math
import statistics

import numpy as np

__all__ = ["percentile", "spread", "union_seconds", "idle_gaps", "sub_seed", "median"]

median = statistics.median


def percentile(values, q: float):
    """The ``q``-th percentile by nearest rank, and the number of values
    above it.  Returns (value, beyond)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("a percentile of no values")
    v = xs[max(math.ceil(q / 100.0 * len(xs)), 1) - 1]
    return v, sum(1 for x in xs if x > v)


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_seconds(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    return sum(b - a for a, b in _merged(intervals))


def idle_gaps(intervals, start: float, end: float):
    """The gaps in [start, end] that no interval covers, as (start, end)."""
    gaps, t = [], start
    for a, b in _merged(intervals):
        if a > t:
            gaps.append((t, min(a, end)))
        t = max(t, b)
    if t < end:
        gaps.append((t, end))
    return [g for g in gaps if g[1] > g[0]]


def sub_seed(seed: int, *path: int) -> int:
    """A 32-bit seed drawn from ``seed`` and a path of indices: the same
    arguments give the same seed, whatever the size of ``seed``."""
    return int(np.random.SeedSequence([int(seed) & (2**64 - 1), *path]).generate_state(1)[0])
