"""The frame steps' operations over the window against the card's bf16
peak, %: each delivered frame's talker and predictor products, both
attentions at its position and its codec decode
(``counts/qwen3tts.py:frame_ops``), over the window's host seconds and
989 TFLOP/s."""


def read(ctx):
    c = ctx["counts"]
    ops = 0.0
    for r in ctx["recs"]:
        n = sum(ch[1] for ch in r["chunks"])
        prompt = 11 + len(r["text"].encode("utf-8"))
        ops += sum(c.frame_ops(ctx["cfg"], prompt + k + 1) for k in range(n))
    if not ops:
        return None
    return 100.0 * ops / ctx["window_s"] / c.PEAK_BF16_OPS
