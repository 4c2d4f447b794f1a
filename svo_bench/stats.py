"""The benchmark's arithmetic: rates, tails, spreads and interval unions."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

import numpy as np


def rate(n_frames: int, window_s: float) -> float:
    """Frames per second: every frame the window tracked over the whole
    window, never a mean of per-chunk rates."""
    return n_frames / window_s


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of every value (numpy's linear interpolation),
    never a statistic of per-chunk statistics."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, by
    ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of the intervals: time in which at least one
    of them runs, overlaps counted once."""
    return sum(e - s for s, e in merge(intervals))
