"""Host ms a frame step of the loops' decode, over all steps of the window:
the streaming loop's per-chunk ``decode_ms`` over its frames, or the batch
loop's ``decode_s`` over its steps (a step advances every row)."""


def read(ctx):
    ms = steps = 0.0
    seen = set()
    for r in ctx["recs"]:
        if r.get("batch_timing") is not None:
            t = r["batch_timing"]
            if id(t) not in seen:
                seen.add(id(t))
                ms += t["decode_s"] * 1e3
                steps += t["steps"] / t["batch"]
        else:
            for _when, n, timing in r["chunks"]:
                if "decode_ms" in timing:
                    ms += timing["decode_ms"]
                    steps += n
    return ms / steps if steps else None
