"""Every codec frame delivered in the window over the window, frames/s
(host clock; a closed loop's window ends with its last request)."""
from stats import frames_per_s


def read(ctx):
    return frames_per_s(ctx["recs"], ctx["t0"])
