"""Chunk graphs the batch engine captured inside the window
(``ChunkGraphs.captures`` after less before); each stalls every stream."""


def read(ctx):
    n = ctx.get("captures_in_window")
    return None if n is None else float(n)
