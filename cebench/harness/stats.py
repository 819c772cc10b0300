"""The arithmetic of the end-to-end metrics and of their spreads."""
from __future__ import annotations

import math
import statistics


def rate(count: int, seconds: float) -> float:
    """Work over all the time of the window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def percentile(values, p: float) -> float:
    """The ``p``-th percentile (0-100) by the nearest-rank rule: the
    smallest value with at least p % of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    rank = max(1, math.ceil(p / 100.0 * len(v)))
    return v[rank - 1]


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles`` with n=4, its default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def q_error(est: float, true: float) -> float:
    """max(e, t) / min(e, t), both clamped to at least 1."""
    e, t = max(float(est), 1.0), max(float(true), 1.0)
    return max(e, t) / min(e, t)
