"""Share of the window with no device work, %: 1 less the union of the
replays' CUDA-event intervals and the eager prefills', joins' and full
decodes' intervals (gaps inside a graph count as busy)."""
from stats import idle_share


def read(ctx):
    return idle_share(ctx)
