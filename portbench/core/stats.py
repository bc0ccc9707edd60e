"""Statistics of a run: percentiles over every operation of the window
(never medians of chunks)."""
from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by the nearest-rank rule: the
    smallest value with at least q % of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[rank - 1])
