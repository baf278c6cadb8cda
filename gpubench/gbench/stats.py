"""The arithmetic of the end-to-end metrics and of the spreads that set
their bounds."""
from __future__ import annotations

import statistics


def rate(count: float, seconds: float) -> float:
    """Work per second over all the work and all the time of a window."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return count / seconds


def spread(values) -> float:
    """The distance between the first and third quartile as a share of
    the median (statistics.quantiles, n=4, its default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
