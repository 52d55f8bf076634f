"""Median over all requests of the window of the time from a request's call
to its first audio chunk, ms (host clock)."""
from stats import percentile, ttfa_ms


def read(ctx):
    return percentile(ttfa_ms(ctx["recs"]), 50)
