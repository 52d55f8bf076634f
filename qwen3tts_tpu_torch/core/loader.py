"""Parameter bundles for the PyTorch port.

Port of part of ``qwen3tts_tpu/core/loader.py``:

  - ``init_random`` builds a ``random:<preset>`` model from a seeded
    ``torch.Generator`` on the target device, with the JAX initialisers'
    shapes and per-tensor scales (not JAX's numbers);
  - ``bundle_from_jax_numpy`` is the weight bridge: it takes a JAX bundle as
    a pytree of numpy arrays and returns the port's parameters, so that both
    packages compute the same function.

Talker and predictor parameters keep the JAX layout.  Codec and speaker
convolutions change layout: a JAX conv weight ``[K, Cin, Cout]`` becomes
``[Cout, Cin, K]``, and a JAX transposed-conv weight becomes
``w[::-1].permute(1, 2, 0)`` = ``[Cin, Cout, K]`` flipped along K, which is
what makes ``F.conv_transpose1d`` equal ``jax.lax.conv_transpose``.
Talker and predictor are cast to the model dtype, except the int8
weight-only leaves ``{"q", "scale"}`` of a quantized bundle
(``ops/quant.py``), which keep int8 ``q`` and float32 ``scale`` bit for bit;
codec and speaker encoder stay float32, as in the JAX package.

Each entry point builds on the card unless the caller names a device; with
no card and no device given it raises rather than carry on on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .config import TTSModelConfig, dtype_name
from .presets import get_preset


def resolve_device(device) -> torch.device:
    """``device`` as given, else the card; with neither, a RuntimeError."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the port runs on the card; pass device="cpu" '
                           "to run on the CPU")
    return torch.device("cuda")


def init_random(cfg: TTSModelConfig, seed: int = 0, dtype: Optional[torch.dtype] = None,
                device=None) -> Dict[str, Any]:
    from ..models import codec as codec_lib
    from ..models import predictor as predictor_lib
    from ..models import speaker as speaker_lib
    from ..models import talker as talker_lib

    device = resolve_device(device)
    dtype = dtype or cfg.torch_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    return {
        "talker": talker_lib.init_params(gen, cfg.talker, dtype, device),
        "predictor": predictor_lib.init_params(gen, cfg.predictor, cfg.talker.hidden_size,
                                               dtype, device),
        "codec": codec_lib.init_params(gen, cfg.codec, torch.float32, device),
        "speaker": speaker_lib.init_params(gen, cfg.speaker_encoder, torch.float32, device),
    }


def load_pretrained(model_name: str, dtype=None, seed: int = 0, device=None
                    ) -> Tuple[TTSModelConfig, Dict[str, Any]]:
    """Resolve 'random:<preset>'.  Checkpoint directories are not ported yet."""
    device = resolve_device(device)
    if not model_name.startswith("random:"):
        raise NotImplementedError(
            f"'{model_name}': the PyTorch port loads only 'random:<preset>' models; "
            "checkpoint loading is not ported yet")
    cfg = get_preset(model_name.split(":", 1)[1])
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype_name(dtype))
    return cfg, init_random(cfg, seed=seed, dtype=cfg.torch_dtype, device=device)


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device=device, dtype=dtype)


def _tree(tree, dtype, device):
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:  # int8 weight-only leaf
        return {"q": torch.from_numpy(np.array(tree["q"], dtype=np.int8, order="C")).to(device),
                "scale": _t(tree["scale"], torch.float32, device)}
    if isinstance(tree, dict):
        return {k: _tree(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, dtype, device) for v in tree]
    return _t(tree, dtype, device)


def _conv(p, device) -> Dict[str, torch.Tensor]:
    """JAX conv {w [K, Cin, Cout], b} -> {w [Cout, Cin, K], b}."""
    w = _t(p["w"], torch.float32, device).permute(2, 1, 0).contiguous()
    return {"w": w, "b": _t(p["b"], torch.float32, device)}


def _tconv(p, device) -> Dict[str, torch.Tensor]:
    """JAX transposed conv {w [K, Cin, Cout], b} -> {w [Cin, Cout, K] flipped, b}."""
    w = _t(np.asarray(p["w"], np.float32)[::-1], torch.float32, device)
    return {"w": w.permute(1, 2, 0).contiguous(), "b": _t(p["b"], torch.float32, device)}


def _codec_from_jax(codec, device) -> Dict[str, Any]:
    dec = codec["decoder"]
    f32 = torch.float32
    out = {
        "code_embedding": _t(dec["code_embedding"], f32, device),
        "pre_transformer": _tree(dec["pre_transformer"], f32, device),
        "upsample": [],
        "dec_in": _conv(dec["dec_in"], device),
        "blocks": [],
        "out_alpha": _t(dec["out_alpha"], f32, device),
        "out_beta": _t(dec["out_beta"], f32, device),
        "dec_out": _conv(dec["dec_out"], device),
    }
    for st in dec["upsample"]:
        cnx = st["convnext"]
        out["upsample"].append({
            "tconv": _tconv(st["tconv"], device),
            "convnext": {
                "dw": _conv(cnx["dw"], device),  # [7, 1, C] -> [C, 1, 7] depthwise
                **{k: _tree(cnx[k], f32, device)
                   for k in ("norm_w", "norm_b", "pw1", "pw2", "scale")},
            },
        })
    for blk in dec["blocks"]:
        out["blocks"].append({
            "alpha": _t(blk["alpha"], f32, device),
            "beta": _t(blk["beta"], f32, device),
            "tconv": _tconv(blk["tconv"], device),
            "units": [{
                **{k: _t(u[k], f32, device) for k in ("alpha1", "beta1", "alpha2", "beta2")},
                "conv1": _conv(u["conv1"], device),
                "conv2": _conv(u["conv2"], device),
            } for u in blk["units"]],
        })
    res = {"decoder": out}
    if "encoder" in codec:
        enc = codec["encoder"]
        res["encoder"] = {
            "in_conv": _conv(enc["in_conv"], device),
            "stages": [{"alpha": _t(st["alpha"], f32, device),
                        "beta": _t(st["beta"], f32, device),
                        "conv": _conv(st["conv"], device)} for st in enc["stages"]],
            "proj": _tree(enc["proj"], f32, device),
            "transformer": _tree(enc["transformer"], f32, device),
            "codebooks": _t(enc["codebooks"], f32, device),
        }
    return res


def _speaker_from_jax(spk, device) -> Dict[str, Any]:
    return {
        "in_conv": _conv(spk["in_conv"], device),
        "blocks": [{"conv": _conv(b["conv"], device), "pw": _conv(b["pw"], device)}
                   for b in spk["blocks"]],
        "cat_conv": _conv(spk["cat_conv"], device),
        "att_w1": _conv(spk["att_w1"], device),
        "att_w2": _conv(spk["att_w2"], device),
        "out": _tree(spk["out"], torch.float32, device),
    }


def bundle_from_jax_numpy(tree: Dict[str, Any], cfg: TTSModelConfig,
                          dtype: Optional[torch.dtype] = None, device=None
                          ) -> Dict[str, Any]:
    """JAX bundle (numpy leaves; any subset of talker / predictor / codec /
    speaker) -> the port's parameters on ``device``.  The codec keeps its
    encoder when the bundle has one, its convs re-laid as the decoder's."""
    device = resolve_device(device)
    dtype = dtype or cfg.torch_dtype
    out: Dict[str, Any] = {}
    for part in ("talker", "predictor"):
        if part in tree:
            out[part] = _tree(tree[part], dtype, device)
    if "codec" in tree:
        out["codec"] = _codec_from_jax(tree["codec"], device)
    if "speaker" in tree:
        out["speaker"] = _speaker_from_jax(tree["speaker"], device)
    return out
