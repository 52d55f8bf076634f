"""Operations and bytes of Qwen3-TTS work, from the configuration's shapes.

Counts of what the work needs, whichever kernel does it: every weight is
read once, every input byte once and every output byte written once, a
multiply-add is two operations.  ``cfg`` is the configuration file's dict;
``B`` the rows of a step; ``live`` the key/value slots an attention reads.

H100 SXM peaks (NVIDIA's data sheet, dense): 989e12 bfloat16 operations a
second, 3.35e12 bytes a second of HBM.

A counts module (``bench_h100/counts/<name>.py``, named by a configuration's
``bench.counts``) provides every model-dependent number the readers take:
``step_products``, ``flash_decode_call``, ``decode_attention_layers``,
``frame_ops``, ``codec_ops_per_frame``, ``bound_s``, ``PEAK_BF16_OPS`` and
``HBM_BYTES_PER_S``.
"""
from __future__ import annotations

from typing import Dict, Tuple

PEAK_BF16_OPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2


def _block_products(c: Dict):
    """The (in, out) of each weight product of one decoder block."""
    H, NH, KVH, D, I = (c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"],
                        c["head_dim"], c["intermediate_size"])
    return [(H, (NH + 2 * KVH) * D), (NH * D, H), (H, 2 * I), (I, H)]


def _products(shapes, rows: int, elt: int = BF16) -> Tuple[float, float]:
    """(operations, bytes) of ``rows`` rows through each (in, out) product."""
    ops = sum(2.0 * rows * i * o for i, o in shapes)
    nbytes = sum(elt * (i * o + rows * (i + o)) for i, o in shapes)
    return ops, nbytes


def step_products(cfg: Dict, B: int) -> Tuple[float, float]:
    """(operations, bytes) of every weight product of one frame step at B
    rows: the talker's blocks and codec head once; the predictor's input
    projection and blocks on the 2-token prefill and the 14 micro-steps
    (each reads the weights again), and its 15 heads once each."""
    tc = cfg["talker_config"]
    pc = tc["code_predictor_config"]
    talker = _block_products(tc) * tc["num_hidden_layers"] + [(tc["hidden_size"],
                                                               tc["vocab_size"])]
    ops, nbytes = _products(talker, B)
    n_cb = pc["num_code_groups"] - 1
    pred = [(tc["hidden_size"], pc["hidden_size"])] + \
        _block_products(pc) * pc["num_hidden_layers"]
    o, b = _products(pred, 2 * B)  # the prefill: 2 positions a row
    ops, nbytes = ops + o, nbytes + b
    o, b = _products(pred, B)
    ops, nbytes = ops + (n_cb - 1) * o, nbytes + (n_cb - 1) * b
    o, b = _products([(pc["hidden_size"], pc["codebook_size"])], B)
    return ops + n_cb * o, nbytes + n_cb * b


def flash_decode_call(cfg: Dict, B: int, live: int) -> Tuple[float, float]:
    """(operations, bytes) of one talker layer's decode attention at B rows,
    each reading ``live`` cached slots: q in, K and V of the live slots,
    the output out."""
    tc = cfg["talker_config"]
    NH, KVH, D = tc["num_attention_heads"], tc["num_key_value_heads"], tc["head_dim"]
    ops = 4.0 * B * NH * D * live
    nbytes = BF16 * B * (2 * live * KVH * D + 2 * NH * D)
    return ops, nbytes


def decode_attention_layers(cfg: Dict) -> int:
    """The talker layers that run a decode attention over the KV cache:
    every one of Qwen3's."""
    return cfg["talker_config"]["num_hidden_layers"]


def codec_ops_per_frame(cfg: Dict) -> float:
    """Operations of the codec decoder for one frame of codes: the
    pre-transformer at the frame rate, then every convolution at its own
    rate (samples of its output a frame)."""
    cc = cfg["speech_tokenizer_config"]
    H, I = cc["hidden_size"], cc["intermediate_size"]
    NH, KVH, D = cc["num_attention_heads"], cc["num_key_value_heads"], cc["head_dim"]
    W = cc["sliding_window"]
    ops = cc["num_hidden_layers"] * (2.0 * (H * (NH + 2 * KVH) * D + NH * D * H + 3 * H * I)
                                     + 4.0 * NH * D * W)
    steps, ch = 1, H
    for r in cc["upsampling_ratios"]:
        steps *= r
        ops += 2.0 * steps * (ch * ch + 7 * ch + 8 * ch * ch)  # tconv, dw, pw1 + pw2
    dim = cc["decoder_dim"]
    ops += 2.0 * steps * 7 * ch * dim
    for r in cc["upsample_rates"]:
        steps *= r
        out = dim // 2
        ops += 2.0 * steps * 2 * dim * out  # transposed conv, 2r taps over stride r
        ops += 3 * 2.0 * steps * (7 * out * out + out * out)  # three residual units
        dim = out
    return ops + 2.0 * steps * 7 * dim


def frame_ops(cfg: Dict, live: int) -> float:
    """Operations of one row's frame step at a talker position with
    ``live`` slots: its share of the step's products, the talker's and the
    predictor's attention, and the codec decoder's frame."""
    pc = cfg["talker_config"]["code_predictor_config"]
    ops, _ = step_products(cfg, 1)
    ops += decode_attention_layers(cfg) * flash_decode_call(cfg, 1, live)[0]
    pa = 4.0 * pc["num_attention_heads"] * pc["head_dim"]
    ops += pc["num_hidden_layers"] * pa * sum(range(1, pc["num_code_groups"] + 1))
    return ops + codec_ops_per_frame(cfg)


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the bfloat16 peak and bytes over the HBM rate."""
    return max(ops / PEAK_BF16_OPS, nbytes / HBM_BYTES_PER_S)
