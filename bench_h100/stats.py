"""Statistics over all the requests of a window."""
from __future__ import annotations

from statistics import quantiles
from typing import Dict, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0 < q < 100) by linear interpolation between
    order statistics (``statistics.quantiles``, inclusive); None if empty."""
    vals = sorted(values)
    if not vals:
        return None
    if len(vals) == 1:
        return float(vals[0])
    return float(quantiles(vals, n=100, method="inclusive")[int(round(q)) - 1])


def ttfa_ms(recs: List[Dict]) -> List[float]:
    """Each request's time from its due time to its first audio chunk."""
    return [(r["chunks"][0][0] - r["due"]) * 1e3 for r in recs if r["chunks"]]


def chunk_gaps_ms(recs: List[Dict]) -> List[float]:
    """Every gap between two consecutive chunks of a request, all requests."""
    out = []
    for r in recs:
        t = [c[0] for c in r["chunks"]]
        out += [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    return out


def frames_per_s(recs: List[Dict], t0: float) -> Optional[float]:
    """Every frame delivered, over the window from its start to the last
    delivery: a closed loop's window ends when its last request does."""
    ends = [r["end"] for r in recs if r.get("end") is not None and r["chunks"]]
    if not ends:
        return None
    return sum(c[1] for r in recs for c in r["chunks"]) / (max(ends) - t0)


def union_ms(intervals: List[tuple], lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_share(ctx) -> Optional[float]:
    """% of the window in which no recorded device interval runs."""
    t = ctx.get("trace")
    if not t:
        return None
    window = ctx["window_s"] * 1e3
    return 100.0 * (1.0 - union_ms(t["intervals"], 0.0, window) / window)
