"""Percentiles and spreads, kept here so that a change to the program
cannot move the yardstick.

``pct`` is the percentile arithmetic of ``repro_torch/core/metrics.py``
(numpy's linear interpolation), over every value given: a request that
failed is passed in as ``math.inf`` and so lies beyond every finite one.
``spread`` is the benchmark's measure of noise: the distance between the
first and third quartiles of ``statistics.quantiles(values, n=4)`` as a
share of the median.
"""
from __future__ import annotations

import math
import statistics
from typing import Sequence

import numpy as np


def pct(values: Sequence[float], p: float) -> float:
    """The p-th percentile of every value, inf where the rank falls on a
    failed request; nan for no values."""
    if not len(values):
        return math.nan
    xs = np.sort(np.asarray(values, dtype=np.float64))
    rank = (len(xs) - 1) * p / 100.0
    lo, hi = int(math.floor(rank)), int(math.ceil(rank))
    if math.isinf(xs[hi]):
        return math.inf
    return float(xs[lo] + (xs[hi] - xs[lo]) * (rank - lo))


def spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
