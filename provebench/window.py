"""Arithmetic of a measured window: rates, percentiles, the union of device
intervals, idle gaps and the prover stages they fall in.

Times are seconds on one clock (the host's `time.perf_counter`); device
intervals are brought onto it before they come here (profiling.py).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def rate(proves: Sequence[dict], window_s: float) -> float:
    """Trace steps of all proves completed in the window over its length."""
    return sum(p["steps"] for p in proves) / window_s


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q % of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def merged(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The intervals clipped to [lo, hi], sorted and merged where they
    overlap or touch."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Length of the union of the intervals inside [lo, hi]."""
    return sum(b - a for a, b in merged(intervals, lo, hi))


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in merged(intervals, lo, hi):
        if a > cur:
            out.append((cur, a))
        cur = b
    if hi > cur:
        out.append((cur, hi))
    return out


def stage_edges(start: float, stages: Sequence[Tuple[str, float]]) -> List[Tuple[str, float, float]]:
    """Consecutive stages of one prove from its start and their seconds in
    order: (name, begin, end), each stage beginning where the last ended."""
    out, t = [], start
    for name, seconds in stages:
        out.append((name, t, t + seconds))
        t += seconds
    return out


def label_gaps(gap_list: Sequence[Interval], spans: Sequence[Tuple[str, float, float]],
               outside: str = "outside_prove") -> Dict[str, float]:
    """Idle seconds by the stage they fall in: each gap is cut at the stage
    edges; a part inside no stage counts under `outside`."""
    spans = sorted(spans, key=lambda s: s[1])
    out: Dict[str, float] = {}
    for g0, g1 in gap_list:
        covered = 0.0
        for name, a, b in spans:
            if b <= g0:
                continue
            if a >= g1:
                break
            part = min(b, g1) - max(a, g0)
            if part > 0:
                out[name] = out.get(name, 0.0) + part
                covered += part
        if g1 - g0 - covered > 0:
            out[outside] = out.get(outside, 0.0) + (g1 - g0 - covered)
    return out


def mean_stage(proves: Sequence[dict], *keys: str):
    """Mean over the proves of the sum of these `timings` keys that each
    prove has; None when no prove carries timings with any of them."""
    vals = []
    for p in proves:
        t = p.get("timings")
        if t and any(k in t for k in keys):
            vals.append(sum(t.get(k, 0.0) for k in keys))
    return sum(vals) / len(vals) if vals else None
