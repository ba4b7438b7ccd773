"""Small arithmetic the metric readers share."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    values at or below it (an infinite value sorts last)."""
    if not values:
        raise ValueError("no values")
    ranked = sorted(values)
    return ranked[max(0, math.ceil(q / 100.0 * len(ranked)) - 1)]


def window_polls(run: Dict) -> List[Dict]:
    """The polls that saw decode steps inside the window, less those
    inside a profiled span (the profiler slows the host)."""
    span = run["counters"].get("prof_polls", [0, 0])
    out = []
    for i, p in enumerate(run["polls"]):
        if span[0] <= i < span[-1]:
            continue
        if 0.0 <= p["t"] < run["window_s"]:
            out.append(p)
    return out


def profiled_polls(run: Dict) -> List[Dict]:
    span = run["counters"].get("prof_polls")
    if not span or len(span) < 2:
        return []
    return run["polls"][span[0]:span[1]]


def counter_delta(run: Dict, key: str) -> float:
    """A counter's growth over the window, less its growth over a
    profiled span inside it."""
    c = run["counters"]
    delta = c["close"][key] - c["open"][key]
    if "prof_close" in c:
        delta -= c["prof_close"][key] - c["prof_open"][key]
    return delta
