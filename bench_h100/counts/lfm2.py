"""Operations and bytes of the hybrid (LFM2) talker's work, from the
configuration's shapes: the Qwen3-TTS counts (``counts/qwen3tts.py``) for
the code predictor, the codec and the peaks, and LFM2's own layers for the
talker.  Every weight is read once, every input byte once and every output
byte written once; a multiply-add is two operations.

- ``step_products``: the products cuBLAS runs in a frame step (the reader
  of ``matmul_roofline`` times cuBLAS's kernels): each convolution layer's
  in (H x 3H) and out (H x H) projections, each attention layer's qkv and
  o, the dense layers' gate|up and down, the codec head, and the code
  predictor's as in ``qwen3tts``.  The routed experts and the router run in
  the port's own kernel and are left out (``expert_call``).
- ``decode_attention_layers``: the ``full_attention`` layers (6).
- ``flash_decode_call``: ``qwen3tts``'s, at the talker's 32 query / 8 kv
  heads of 64.
- ``frame_ops``: one row's share of the products, its 4 active experts and
  its router, both attentions at its position and the codec's frame.
- ``expert_call(cfg, B, touched)``: one routed layer's decode call at B
  rows that touches ``touched`` experts: the router and every touched
  expert's three matrices read once, the rows in and out.
- ``codec_ops_per_frame``, ``bound_s``, ``PEAK_BF16_OPS`` and
  ``HBM_BYTES_PER_S`` are ``qwen3tts``'s.

A program whose talker configuration has no expert keys would read this
configuration as a Qwen3 talker of LFM2's widths and run that model under
its name: loading these counts there raises (``harness.run`` loads them
before any weight is drawn), so such a run ends at once with an error.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from counts import qwen3tts as base


def _program_runs_the_hybrid_talker() -> None:
    from qwen3tts_tpu_torch.core.config import TalkerConfig

    if "num_experts" not in {f.name for f in dataclasses.fields(TalkerConfig)}:
        raise RuntimeError("the program's TalkerConfig has no hybrid (LFM2) talker keys: it "
                           "cannot run this configuration")


_program_runs_the_hybrid_talker()

PEAK_BF16_OPS = base.PEAK_BF16_OPS
HBM_BYTES_PER_S = base.HBM_BYTES_PER_S
BF16 = base.BF16
bound_s = base.bound_s
flash_decode_call = base.flash_decode_call
codec_ops_per_frame = base.codec_ops_per_frame


def _kinds(tc: Dict) -> Dict[str, int]:
    types = tc["layer_types"]
    dense = tc["num_dense_layers"]
    return {"conv": sum(t == "conv" for t in types),
            "attn": sum(t == "full_attention" for t in types),
            "dense": dense, "moe": len(types) - dense}


def decode_attention_layers(cfg: Dict) -> int:
    """The talker layers that run a decode attention over the KV cache."""
    return _kinds(cfg["talker_config"])["attn"]


def _talker_products(tc: Dict):
    H, NH, KVH, D, I = (tc["hidden_size"], tc["num_attention_heads"],
                        tc["num_key_value_heads"], tc["head_dim"], tc["intermediate_size"])
    n = _kinds(tc)
    return ([(H, 3 * H), (H, H)] * n["conv"] + [(H, (NH + 2 * KVH) * D), (NH * D, H)] * n["attn"]
            + [(H, 2 * I), (I, H)] * n["dense"] + [(H, tc["vocab_size"])])


def step_products(cfg: Dict, B: int) -> Tuple[float, float]:
    """(operations, bytes) of the products cuBLAS runs in one frame step at
    B rows: the talker's convolution, attention and dense projections and
    its codec head once; the code predictor's as ``qwen3tts`` counts them."""
    tc = cfg["talker_config"]
    pc = tc["code_predictor_config"]
    ops, nbytes = base._products(_talker_products(tc), B)
    n_cb = pc["num_code_groups"] - 1
    pred = [(tc["hidden_size"], pc["hidden_size"])] + \
        base._block_products(pc) * pc["num_hidden_layers"]
    o, b = base._products(pred, 2 * B)  # the prefill: 2 positions a row
    ops, nbytes = ops + o, nbytes + b
    o, b = base._products(pred, B)
    ops, nbytes = ops + (n_cb - 1) * o, nbytes + (n_cb - 1) * b
    o, b = base._products([(pc["hidden_size"], pc["codebook_size"])], B)
    return ops + n_cb * o, nbytes + n_cb * b


def expert_call(cfg: Dict, B: int, touched: float) -> Tuple[float, float]:
    """(operations, bytes) of one routed layer's decode call at B rows
    touching ``touched`` experts: the router [H, E], then each row's top k
    experts (gate|up H x 2I, down I x H); every touched expert's weights
    read once, x and h in, the output out."""
    tc = cfg["talker_config"]
    H, E, I, k = (tc["hidden_size"], tc["num_experts"], tc["moe_intermediate_size"],
                  tc["num_experts_per_tok"])
    ops = 2.0 * B * H * E + 2.0 * B * k * 3 * H * I
    nbytes = BF16 * (H * E + touched * 3 * H * I + 3 * B * H)
    return ops, nbytes


def frame_ops(cfg: Dict, live: int) -> float:
    """Operations of one row's frame step at a talker position with
    ``live`` slots: its share of the products, its routed experts and
    router in every routed layer, the talker's and the predictor's
    attention, and the codec decoder's frame."""
    tc = cfg["talker_config"]
    pc = tc["code_predictor_config"]
    ops, _ = step_products(cfg, 1)
    ops += _kinds(tc)["moe"] * expert_call(cfg, 1, tc["num_experts_per_tok"])[0]
    ops += decode_attention_layers(cfg) * flash_decode_call(cfg, 1, live)[0]
    pa = 4.0 * pc["num_attention_heads"] * pc["head_dim"]
    ops += pc["num_hidden_layers"] * pa * sum(range(1, pc["num_code_groups"] + 1))
    return ops + codec_ops_per_frame(cfg)
