"""The talker's decode attention (``flash_decode_kernel``) against its
bound, %: the least time to read each profiled step's live K/V slots of
every decode-attention layer once (``counts/<name>.py``:
``decode_attention_layers`` x ``flash_decode_call``) over the kernel's
traced time in the eager profile."""


def read(ctx):
    p = ctx.get("profile")
    if not p:
        return None
    c, cfg = ctx["counts"], ctx["cfg"]
    spent = ctx["devtrace"].kernel_time(p["kernels"], "flash_decode")
    if not spent:
        return None
    bound = sum(c.decode_attention_layers(cfg) * c.bound_s(*c.flash_decode_call(
        cfg, p["batch"], p["pos0"] + i + 1)) for i in range(p["steps"]))
    return 100.0 * bound / spent
