"""Int8 weight-only quantization for the decode path.

Port of ``qwen3tts_tpu/ops/quant.py``.  A quantized weight is the dict
``{"q": int8 [..., in, out], "scale": f32 [..., 1, out]}`` (per output
channel), the JAX package's layout.  Only the layer-stack projection
matrices, and the predictor's per-codebook lm_heads, are quantized;
embeddings and norms stay in the model dtype.

Modes: ``"int8"`` quantizes talker and predictor, ``"int8-talker"`` and
``"int8-predictor"`` one of them.  The ``w8a8`` modes (an int8 x int8 dot
with per-token activation scales) are named but not ported: at batch 1 on
the card they need an int8 matrix-vector kernel of their own (ROADMAP,
Queue 1), so ``quantize_bundle`` raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

_QUANT_KEYS = ("qkv_proj", "o_proj", "gateup_proj", "down_proj")
_BASE_MODES = ("int8", "w8a8")
_PARTS = ("talker", "predictor")
MODES = _BASE_MODES + tuple(f"{b}-{p}" for b in _BASE_MODES for p in _PARTS)


def parse_mode(mode: str):
    """'int8' -> ('int8', ('talker', 'predictor')); 'int8-predictor' ->
    ('int8', ('predictor',)).  Raises ValueError on unknown modes."""
    if mode not in MODES:
        raise ValueError(f"unknown quantize mode {mode!r}; expected one of {MODES}")
    base, _, part = mode.partition("-")
    return base, ((part,) if part else _PARTS)


def _not_ported(mode: str):
    raise NotImplementedError(
        f"quantize mode {mode!r} (w8a8) is not ported: it needs a hand-written "
        "int8 x int8 matrix-vector kernel at batch 1 (ROADMAP Queue 1)")


def quantize_tensor(w: torch.Tensor, mode: str = "int8") -> Dict[str, torch.Tensor]:
    """[..., in, out] float -> int8 + f32 per-out-channel scale [..., 1, out].
    Bit-identical to the JAX package: f32 divide, round half to even, clip
    to +-127."""
    if mode != "int8":
        _not_ported(mode)
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)  # per out channel
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequant(w: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    """Each element ``dtype(f32(q) * scale)``: the fused kernels' tile dequant
    (``qwen3tts_tpu/ops/fused_block.py:_tile``)."""
    return (w["q"].float() * w["scale"].float()).to(dtype)


def dequant_matmul(x: torch.Tensor, qw: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``x @ dequant(qw)`` as the JAX package computes it: the int8 weight
    converted to x's values, products accumulated in float32, then scaled per
    output channel and cast to x's dtype."""
    y = torch.matmul(x.float(), qw["q"].float())
    return (y * qw["scale"].float()).to(x.dtype)


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) in ({"q", "scale"}, {"q8", "scale"})


def quantize_block_stack(blocks: Dict[str, Any], mode: str = "int8") -> Dict[str, Any]:
    """Quantize the projection matrices of a layer-stacked block dict."""
    return {k: quantize_tensor(v, mode) if k in _QUANT_KEYS else v
            for k, v in blocks.items()}


def quantize_bundle(bundle: Dict[str, Any], mode: str = "int8") -> Dict[str, Any]:
    """Quantize the decode-path weights of a parameter bundle: the block
    projections of each selected component and, for the predictor, its
    per-codebook lm_heads (read in full every frame)."""
    base, parts = parse_mode(mode)
    if base != "int8":
        _not_ported(mode)
    out = dict(bundle)
    for part in parts:
        p = dict(bundle[part])
        p["blocks"] = quantize_block_stack(p["blocks"], base)
        if part == "predictor":
            p["lm_heads"] = quantize_tensor(p["lm_heads"], "int8")
        out[part] = p
    return out


def maybe_matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for a plain tensor or an int8 weight-only dict."""
    if isinstance(w, dict):
        if "q8" in w:
            _not_ported("w8a8")
        return dequant_matmul(x, w)
    return x @ w
