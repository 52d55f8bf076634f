"""% of the window in which the card runs nothing (the intervals
``device_idle_share`` reads) while the host is inside a ``prompt`` span of
the program (a batch's prompt build); at most ``device_idle_share``."""
from tracer import idle_share_while


def read(ctx):
    return idle_share_while(ctx, "prompt")
