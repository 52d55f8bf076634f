"""Median over the window's requests of the program's ``prompt`` span (the
prompt build: tokenizer, the cached voice's speaker projection, the text
and codec embeddings), ms; a request's spans are summed by request id."""
from collections import defaultdict

from stats import percentile
from tracer import window_spans


def read(ctx):
    spans = window_spans(ctx, "prompt")
    if spans is None:
        return None
    per = defaultdict(float)
    for s in spans:
        per[s.rid] += s.end - s.start
    return percentile([1e3 * v for v in per.values()], 50)
