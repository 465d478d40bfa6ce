"""Metric arithmetic shared by the metric readers."""

from __future__ import annotations

import math


def rate(counts, window_s: float) -> float:
    """Work a second over the whole window: every count of the window
    over all of its time."""
    return sum(counts) / window_s


def percentile(values, q: float) -> float:
    """The q-th percentile by nearest rank over every value: the least
    value with at least q % of the values at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]


def span_per_mpair(batches, key: str):
    """A span the program reports for each batch (ms), summed over the
    batches, in milliseconds a million pairs; None where a batch lacks it."""
    if not batches or any(b.get(key) is None for b in batches):
        return None
    return sum(b[key] for b in batches) / (sum(b["pairs"] for b in batches)
                                           / 1e6)
