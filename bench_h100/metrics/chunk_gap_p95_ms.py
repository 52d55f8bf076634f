"""95th percentile over every gap between two consecutive audio chunks of a
request, all requests of the window, ms (host clock)."""
from stats import chunk_gaps_ms, percentile


def read(ctx):
    return percentile(chunk_gaps_ms(ctx["recs"]), 95)
