"""The program's own tracer as a traced run's readers see it
(``qwen3tts_tpu_torch.utils.timing.TRACE``): its host spans and the device
parts of its captured steps, those of the window.  A program without the
tracer, or whose tracer is off, gives None, and so do the readers built on
it: the result line then leaves their metrics out."""
from __future__ import annotations

from typing import List, Optional


def tracer():
    """The program's tracer while it records, else None."""
    try:
        from qwen3tts_tpu_torch.utils.timing import TRACE
    except ImportError:
        return None
    return TRACE if TRACE.on else None


def window_spans(ctx, name: str, device: bool = False) -> Optional[List]:
    """Spans ``name`` (device parts with ``device``) that start inside the
    window [t0, t0 + window_s]; None without a tracer."""
    tr = tracer()
    if tr is None:
        return None
    t0, t1 = ctx["t0"], ctx["t0"] + ctx["window_s"]
    spans = tr.device_spans(name, t0, t1) if device else tr.spans(name, t0, t1)
    return [s for s in spans if t0 <= s.start <= t1]


def device_ms_per_step(ctx, part: str) -> Optional[float]:
    """Mean device ms of the captured steps' ``part`` over every stamped
    step of the window."""
    spans = window_spans(ctx, part, device=True)
    if not spans:
        return None
    return 1e3 * sum(s.end - s.start for s in spans) / len(spans)


def merged(intervals, lo: float, hi: float) -> List[tuple]:
    """(start, end) intervals clipped to [lo, hi] and merged, in order."""
    out: List[list] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def overlap(a: List[tuple], b: List[tuple]) -> float:
    """Length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_while(ctx, name: str) -> Optional[float]:
    """% of the window in which no device interval of the traced run
    (``ctx["trace"]["intervals"]``, ms from the window's start: the ones
    ``device_idle_share`` reads) runs while the host is inside a span
    ``name``; at most that share."""
    t, tr = ctx.get("trace"), tracer()
    if not t or tr is None:
        return None
    t0, window = ctx["t0"], ctx["window_s"] * 1e3
    host = merged([((s.start - t0) * 1e3, (s.end - t0) * 1e3)
                   for s in tr.spans(name, t0, t0 + ctx["window_s"])], 0.0, window)
    if not host:
        return None
    busy = overlap(host, merged(t["intervals"], 0.0, window))
    return 100.0 * (sum(e - s for s, e in host) - busy) / window
