"""Int8 quantization for the decode path: weight-only and w8a8.

Port of ``qwen3tts_tpu/ops/quant.py``.  Two formats, the JAX package's
layouts (per output channel; the key names the mode):

- ``int8`` (weight-only): ``{"q": int8 [..., in, out], "scale": f32 [...,
  1, out]}``; the weight is converted to the activations' values and the
  products accumulate in float32 (``dequant_matmul``).
- ``w8a8``: ``{"q8": int8, "scale": f32}``; activations are quantized per
  row on the fly and the int8 x int8 products summed exactly
  (``quantize_act``, ``w8a8_matmul``: ``ops/w8a8.py``, with the CUDA
  kernels of ``csrc/w8a8.cu`` on the card).

Only the layer-stack projection matrices, and the predictor's per-codebook
lm_heads, are quantized; embeddings and norms stay in the model dtype.  The
lm_heads stay int8 weight-only even in the w8a8 modes (their logits feed
sampling), as in the JAX package.

Modes: ``"int8"`` / ``"w8a8"`` quantize talker and predictor,
``"<base>-talker"`` and ``"<base>-predictor"`` one of them (``parse_mode``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .w8a8 import quantize_act, w8a8_matmul  # noqa: F401  (part of this module's API)

# the projections of a block (and of the hybrid talker's convolutions); the
# hybrid talker's experts, router and taps are never quantized
_QUANT_KEYS = ("qkv_proj", "o_proj", "gateup_proj", "down_proj", "in_proj", "out_proj")
_BASE_MODES = ("int8", "w8a8")
_PARTS = ("talker", "predictor")
MODES = _BASE_MODES + tuple(f"{b}-{p}" for b in _BASE_MODES for p in _PARTS)


def parse_mode(mode: str):
    """'int8' -> ('int8', ('talker', 'predictor')); 'w8a8-predictor' ->
    ('w8a8', ('predictor',)).  Raises ValueError on unknown modes."""
    if mode not in MODES:
        raise ValueError(f"unknown quantize mode {mode!r}; expected one of {MODES}")
    base, _, part = mode.partition("-")
    return base, ((part,) if part else _PARTS)


def quantize_tensor(w: torch.Tensor, mode: str = "int8") -> Dict[str, torch.Tensor]:
    """[..., in, out] float -> int8 + f32 per-out-channel scale [..., 1, out]:
    ``{"q", "scale"}`` for "int8", ``{"q8", "scale"}`` for "w8a8".
    Bit-identical to the JAX package on the CPU and on the card: IEEE f32
    divides (by a tensor: the card turns a Python-number divisor into a
    reciprocal multiply), round half to even, clip to +-127."""
    if mode not in _BASE_MODES:
        raise ValueError(f"quantize_tensor: mode 'int8' or 'w8a8' wanted; got {mode!r}")
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)  # per out channel
    scale = amax.clamp_min(1e-8) / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale} if mode == "int8" else {"q8": q, "scale": scale}


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
    """Quantize the projection matrices of a layer-stacked block dict (of
    each group of the hybrid talker's: ``models/lfm2.py``)."""
    return {k: quantize_tensor(v, mode) if k in _QUANT_KEYS
            else quantize_block_stack(v, mode) if isinstance(v, dict) and not is_quantized(v)
            else v
            for k, v in blocks.items()}


def quantize_bundle(bundle: Dict[str, Any], mode: str = "int8") -> Dict[str, Any]:
    """Quantize the decode-path weights of a parameter bundle: the block
    projections of each selected component (in the mode's format) and, for
    the predictor, its per-codebook lm_heads (read in full every frame),
    int8 weight-only in every mode: their logits feed sampling."""
    base, parts = parse_mode(mode)
    out = dict(bundle)
    for part in parts:
        p = dict(bundle[part])
        p["blocks"] = quantize_block_stack(p["blocks"], base)
        if part == "predictor":
            p["lm_heads"] = quantize_tensor(p["lm_heads"], "int8")
        out[part] = p
    return out


def maybe_matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for a plain tensor or a quantized dict (the mode from its keys)."""
    if isinstance(w, dict):
        if "q8" in w:
            return w8a8_matmul(x, w)
        return dequant_matmul(x, w)
    return x @ w
