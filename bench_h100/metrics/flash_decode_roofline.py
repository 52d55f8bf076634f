"""The talker's decode attention (``flash_decode_kernel``) against its
bound, %: the least time to read each profiled step's live K/V slots of
every layer once (``counts/qwen3tts.py:flash_decode_call``) over the
kernel's traced time in the eager profile."""


def read(ctx):
    p = ctx.get("profile")
    if not p:
        return None
    c, tc = ctx["counts"], ctx["cfg"]["talker_config"]
    spent = ctx["devtrace"].kernel_time(p["kernels"], "flash_decode")
    if not spent:
        return None
    bound = sum(tc["num_hidden_layers"] * c.bound_s(*c.flash_decode_call(
        ctx["cfg"], p["batch"], p["pos0"] + i + 1)) for i in range(p["steps"]))
    return 100.0 * bound / spent
