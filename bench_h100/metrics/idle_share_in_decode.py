"""% of the window in which the card runs nothing (no replay's and no eager
prefill's, join's or full decode's interval, as ``device_idle_share``
reads them) while the host is inside a ``decode`` span of the program (a
batch's chunk loop); at most ``device_idle_share``."""
from tracer import idle_share_while


def read(ctx):
    return idle_share_while(ctx, "decode")
