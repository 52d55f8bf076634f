"""90th percentile over all requests of the window of the time from a
request's due time to its first audio chunk, ms (host clock): the highest
percentile with at least ten of the window's 168 requests beyond it."""
from stats import percentile, ttfa_ms


def read(ctx):
    return percentile(ttfa_ms(ctx["recs"]), 90)
