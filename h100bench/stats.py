"""Window arithmetic on host timestamps: which tokens, gaps and requests
fall in the measured window, percentiles and rates. Times are seconds on
one clock (`time.perf_counter`). The window is half-open, [w0, w1)."""

from __future__ import annotations

import math


def inside(t: float, w0: float, w1: float) -> bool:
    return w0 <= t < w1


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the two
    nearest ranks (numpy's default); an infinite value stays infinite."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    r = q / 100.0 * (len(v) - 1)
    lo, hi = math.floor(r), math.ceil(r)
    if lo == hi or v[hi] == v[lo]:
        return float(v[lo])
    if math.isinf(v[hi]):
        return math.inf
    return float(v[lo] + (r - lo) * (v[hi] - v[lo]))


def tokens_in(times_per_request, w0: float, w1: float) -> int:
    """Tokens delivered inside the window, over every request."""
    return sum(inside(t, w0, w1) for times in times_per_request for t in times)


def gaps_in(times_per_request, w0: float, w1: float) -> list[float]:
    """Every gap between consecutive tokens of a request, both ends inside
    the window."""
    out = []
    for times in times_per_request:
        for a, b in zip(times, times[1:]):
            if inside(a, w0, w1) and inside(b, w0, w1):
                out.append(b - a)
    return out


def ttfts(requests, w0: float, w1: float) -> list[float]:
    """Time from due to first token of every request due inside the window:
    (due, first token time or None, failed) triples; a failed request, or
    one that never delivered a token, counts as infinite."""
    out = []
    for due, first, failed in requests:
        if inside(due, w0, w1):
            out.append(math.inf if failed or first is None else first - due)
    return out


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def gaps_between(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle gaps of [lo, hi) that no interval covers, as (start, end)."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]
