"""The routed experts' decode kernel (``routed_experts_*``: routing, gate|up,
down) against its bound, %: the least time to read, in every routed layer
of each profiled step, the router and the weights of the experts the
program counted as touched (``counts/<name>.py:expert_call`` at the mean
experts touched a call, from the profiled engine's own device counters,
``TRACE.route_stats``), over the kernels' traced time in the eager
profile.  None without the kernel, or without counters to read."""
from tracer import tracer


def touched_per_call(batch: int):
    """The mean experts a routed layer's call touched, over the calls of the
    newest engine of ``batch`` rows that routed (the profile's)."""
    tr = tracer()
    stats = getattr(tr, "route_stats", None) if tr is not None else None
    if stats is None:
        return None
    for s in reversed(stats()):
        r = s.read()
        if s.batch == batch and r["calls"]:
            return r["experts_touched"]
    return None


def read(ctx):
    p = ctx.get("profile")
    if not p:
        return None
    c, cfg = ctx["counts"], ctx["cfg"]
    if not hasattr(c, "expert_call"):
        return None
    spent = ctx["devtrace"].kernel_time(p["kernels"], "routed_experts_")
    touched = touched_per_call(p["batch"])
    if not spent or touched is None:
        return None
    tc = cfg["talker_config"]
    layers = len(tc["layer_types"]) - tc["num_dense_layers"]
    bound = p["steps"] * layers * c.bound_s(*c.expert_call(cfg, p["batch"], touched))
    return 100.0 * bound / spent
