"""Seconds of the program's ``capture`` spans (a chunk graph captured,
its eager workspace step included) that end before the window starts:
the captures' part of ``setup_s`` from the point tracing starts (the
traced run's recording graphs)."""
from tracer import tracer


def read(ctx):
    tr = tracer()
    if tr is None:
        return None
    return float(sum(s.end - s.start for s in tr.spans("capture") if s.end <= ctx["t0"]))
