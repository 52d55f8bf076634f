"""95th percentile of the scheduler's ``queue_ms`` (submission to the row's
start), read from each request's first chunk timing, ms."""
from stats import percentile


def read(ctx):
    return percentile([r["chunks"][0][2]["queue_ms"] for r in ctx["recs"]
                       if r["chunks"] and "queue_ms" in r["chunks"][0][2]], 95)
