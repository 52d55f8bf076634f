"""Every weight product of a frame step against its bound, %: the least
time to read each weight once and do its operations
(``counts/qwen3tts.py:step_products``) over the traced time of the
profile's matrix-product kernels (cuBLAS GEMM / GEMV, their split-K
reductions, the port's matvec)."""

PRODUCTS = r"gemm|gemv|nvjet|cutlass|xmma|splitk|matvec"


def read(ctx):
    p = ctx.get("profile")
    if not p:
        return None
    c = ctx["counts"]
    spent = ctx["devtrace"].kernel_time(p["kernels"], PRODUCTS)
    if not spent:
        return None
    return 100.0 * p["steps"] * c.bound_s(*c.step_products(ctx["cfg"], p["batch"])) / spent
