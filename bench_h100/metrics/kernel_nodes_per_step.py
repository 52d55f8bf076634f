"""Kernel nodes the window's replays launched a frame step: each replayed
graph walked (``ChunkGraphs(record=True).kernel_nodes``), its nodes outside
the steps plus the bodies of the steps it ran, over the steps run."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["steps"]:
        return None
    return t["nodes"] / t["steps"]
