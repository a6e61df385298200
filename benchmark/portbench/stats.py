"""Order statistics of the benchmark."""

from __future__ import annotations

from typing import Sequence


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q`` quantile (``ceil(q * n) - 1``, 0-based): a
    value that actually occurred, as the port's ``profiling.quantiles``
    computes it (copied, so no program change moves the yardstick).
    NaN for no values."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    num = int(round(q * 10000))
    rank = max(0, -(-num * len(xs) // 10000) - 1)
    return float(xs[min(len(xs) - 1, rank)])

