"""95th percentile of ``ContinuousBatcher.submit``'s duration on the
caller's thread (the prompt is built there), ms: the benchmark's span."""
from stats import percentile


def read(ctx):
    return percentile([(r["submit1"] - r["submit0"]) * 1e3 for r in ctx["recs"]
                       if r.get("submit1") is not None], 95)
