"""Median of the streaming loop's ``prefill_ms`` (the host's dispatch of the
eager prefill; it flows into the first chunk), ms."""
from stats import percentile


def read(ctx):
    return percentile([r["chunks"][0][2]["prefill_ms"] for r in ctx["recs"]
                       if r["chunks"] and "prefill_ms" in r["chunks"][0][2]], 50)
