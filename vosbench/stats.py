"""Small statistics of the benchmark, on plain lists."""
from __future__ import annotations

import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) with linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of the
    median, quartiles as `statistics.quantiles(values, n=4)` gives them."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError(f"a rate over {seconds} s")
    return count / seconds
