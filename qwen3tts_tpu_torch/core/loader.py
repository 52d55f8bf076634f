"""Parameter bundles and checkpoints for the PyTorch port.

Port of ``qwen3tts_tpu/core/loader.py``:

  - ``init_random`` builds a ``random:<preset>`` model from a seeded
    ``torch.Generator`` on the target device, with the JAX initialisers'
    shapes and per-tensor scales (not JAX's numbers);
  - ``bundle_from_jax_numpy`` is the weight bridge: it takes a JAX bundle as
    a pytree of numpy arrays or torch tensors and returns the port's
    parameters, so that both packages compute the same function;
    ``bundle_to_jax_layout`` is its inverse;
  - checkpoints, in both of the JAX package's layouts, read and written with
    the port's own safetensors code (``safetensors_io.py``):
      * canonical: ``config.json`` with the nested config dict and one
        ``model.safetensors`` holding the JAX pytree's leaves under their
        ``/``-joined paths (``save_checkpoint``; ``load_checkpoint``);
      * upstream HF torch layout: a ``talker_config`` config.json and torch
        tensor names in ``[out, in]`` / ``[Cout, Cin, K]`` layout, optionally
        sharded as ``model-XXXXX-of-YYYYY.safetensors`` with an index
        (``convert_torch_checkpoint`` stacks per-layer tensors and reports
        what it could not place; ``export_torch_checkpoint`` writes it;
        ``diagnose_torch_checkpoint`` dry-runs the conversion).
    A checkpoint either package writes, the other reads leaf for leaf.

Talker and predictor parameters keep the JAX layout.  Codec and speaker
convolutions change layout: a JAX conv weight ``[K, Cin, Cout]`` becomes
``[Cout, Cin, K]``, and a JAX transposed-conv weight becomes
``w[::-1].permute(1, 2, 0)`` = ``[Cin, Cout, K]`` flipped along K, which is
what makes ``F.conv_transpose1d`` equal ``jax.lax.conv_transpose``.
Talker and predictor are cast to the model dtype, except the quantized
leaves of a quantized bundle (``ops/quant.py``: int8 weight-only
``{"q", "scale"}``, w8a8 ``{"q8", "scale"}``), which keep int8 ``q`` /
``q8`` and float32 ``scale`` bit for bit;
codec and speaker encoder stay float32, as in the JAX package.

Each entry point builds on the card unless the caller names a device; with
no card and no device given it raises rather than carry on on the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import safetensors_io
from .config import (CodecConfig, PredictorConfig, SpeakerEncoderConfig, TalkerConfig,
                     TTSModelConfig, dtype_name)
from .presets import get_preset

logger = logging.getLogger(__name__)

SEP = "/"


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
    """Resolve a model reference: 'random:<preset>' or a checkpoint dir."""
    device = resolve_device(device)
    if model_name.startswith("random:"):
        cfg = get_preset(model_name.split(":", 1)[1])
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype_name(dtype))
        return cfg, init_random(cfg, seed=seed, dtype=cfg.torch_dtype, device=device)
    p = Path(model_name)
    if p.is_dir():
        return load_checkpoint(p, dtype=dtype, device=device)
    raise FileNotFoundError(
        f"Model '{model_name}' not found. Use 'random:<preset>' "
        f"or a local checkpoint directory (no network access in this environment).")


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------


def _t(a, dtype, device) -> torch.Tensor:
    """A leaf on ``device`` in ``dtype``: a torch tensor (a checkpoint's) is
    cast once, exactly; a numpy or JAX array goes through float32."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype, copy=True).contiguous()
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device=device, dtype=dtype)


def _q(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int8, copy=True).contiguous()
    return torch.from_numpy(np.array(a, dtype=np.int8, order="C")).to(device)


def _tree(tree, dtype, device):
    if isinstance(tree, dict) and set(tree) in ({"q", "scale"}, {"q8", "scale"}):
        key = "q" if "q" in tree else "q8"  # int8 weight-only or w8a8 leaf
        return {key: _q(tree[key], device), "scale": _t(tree["scale"], torch.float32, device)}
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
    w = _t(p["w"], torch.float32, device).flip(0)
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
    """JAX bundle (numpy, JAX or torch leaves; any subset of talker /
    predictor / codec / speaker) -> the port's parameters on ``device``.
    The codec keeps its encoder when the bundle has one, its convs re-laid
    as the decoder's.  Torch leaves are cast once (bfloat16 stays exact);
    quantized ``{"q", "scale"}`` / ``{"q8", "scale"}`` leaves keep int8 /
    float32."""
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


# ---------------------------------------------------------------------------
# the inverse bridge: the port's parameters -> the JAX pytree
# ---------------------------------------------------------------------------


def _rev(t: torch.Tensor) -> torch.Tensor:
    """numpy's ``.T``: every axis reversed (rank 0 and 1 unchanged)."""
    return t.permute(*range(t.ndim - 1, -1, -1))


def _to_jax_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _to_jax_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_jax_tree(v, device) for v in tree]
    return tree.to(device)


def _conv_to_jax(p, device) -> Dict[str, torch.Tensor]:
    """{w [Cout, Cin, K], b} -> JAX conv {w [K, Cin, Cout], b}."""
    return {"w": p["w"].permute(2, 1, 0).to(device), "b": p["b"].to(device)}


def _tconv_to_jax(p, device) -> Dict[str, torch.Tensor]:
    """{w [Cin, Cout, K] flipped, b} -> JAX transposed conv {w [K, Cin, Cout], b}."""
    return {"w": p["w"].permute(2, 0, 1).flip(0).to(device), "b": p["b"].to(device)}


def _codec_to_jax(codec, device) -> Dict[str, Any]:
    dec = codec["decoder"]
    out = {
        "code_embedding": dec["code_embedding"].to(device),
        "pre_transformer": _to_jax_tree(dec["pre_transformer"], device),
        "upsample": [{
            "tconv": _tconv_to_jax(st["tconv"], device),
            "convnext": {"dw": _conv_to_jax(st["convnext"]["dw"], device),
                         **{k: _to_jax_tree(st["convnext"][k], device)
                            for k in ("norm_w", "norm_b", "pw1", "pw2", "scale")}},
        } for st in dec["upsample"]],
        "dec_in": _conv_to_jax(dec["dec_in"], device),
        "blocks": [{
            "alpha": blk["alpha"].to(device),
            "beta": blk["beta"].to(device),
            "tconv": _tconv_to_jax(blk["tconv"], device),
            "units": [{**{k: u[k].to(device) for k in ("alpha1", "beta1", "alpha2", "beta2")},
                       "conv1": _conv_to_jax(u["conv1"], device),
                       "conv2": _conv_to_jax(u["conv2"], device)} for u in blk["units"]],
        } for blk in dec["blocks"]],
        "out_alpha": dec["out_alpha"].to(device),
        "out_beta": dec["out_beta"].to(device),
        "dec_out": _conv_to_jax(dec["dec_out"], device),
    }
    res = {"decoder": out}
    if "encoder" in codec:
        enc = codec["encoder"]
        res["encoder"] = {
            "in_conv": _conv_to_jax(enc["in_conv"], device),
            "stages": [{"alpha": st["alpha"].to(device), "beta": st["beta"].to(device),
                        "conv": _conv_to_jax(st["conv"], device)} for st in enc["stages"]],
            "proj": _to_jax_tree(enc["proj"], device),
            "transformer": _to_jax_tree(enc["transformer"], device),
            "codebooks": enc["codebooks"].to(device),
        }
    return res


def _speaker_to_jax(spk, device) -> Dict[str, Any]:
    return {
        "in_conv": _conv_to_jax(spk["in_conv"], device),
        "blocks": [{"conv": _conv_to_jax(b["conv"], device), "pw": _conv_to_jax(b["pw"], device)}
                   for b in spk["blocks"]],
        "cat_conv": _conv_to_jax(spk["cat_conv"], device),
        "att_w1": _conv_to_jax(spk["att_w1"], device),
        "att_w2": _conv_to_jax(spk["att_w2"], device),
        "out": _to_jax_tree(spk["out"], device),
    }


def bundle_to_jax_layout(params: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """The port's parameters -> the JAX pytree (tensors on ``device``, as
    views where the layout allows), the inverse of ``bundle_from_jax_numpy``.
    Talker and predictor leaves pass through (quantized ``{"q", "scale"}``
    and ``{"q8", "scale"}`` leaves too, int8 / float32);
    conv weights ``[Cout, Cin, K]`` become ``[K, Cin, Cout]``, transposed
    convs ``w.permute(2, 0, 1).flip(0)``; the codec keeps its encoder when
    it has one.  This is what ``save_checkpoint`` writes."""
    out: Dict[str, Any] = {}
    for part in ("talker", "predictor"):
        if part in params:
            out[part] = _to_jax_tree(params[part], device)
    if "codec" in params:
        out["codec"] = _codec_to_jax(params["codec"], device)
    if "speaker" in params:
        out["speaker"] = _speaker_to_jax(params["speaker"], device)
    return out


# ---------------------------------------------------------------------------
# flatten / unflatten
# ---------------------------------------------------------------------------


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}{SEP}"))
    else:
        out[prefix[: -len(SEP)]] = tree
    return out


def unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


# ---------------------------------------------------------------------------
# save / load (canonical format)
# ---------------------------------------------------------------------------


def save_checkpoint(path, cfg: TTSModelConfig, bundle: Dict[str, Any]) -> None:
    """Write a canonical checkpoint dir.  ``bundle``: the JAX pytree
    {"talker", "predictor", "codec", "speaker"} (``bundle_to_jax_layout``);
    each leaf keeps its dtype, so quantized ``q`` / ``q8`` stay int8 and
    ``scale`` float32."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg.to_dict(), indent=2))
    safetensors_io.save_file(flatten(bundle), path / "model.safetensors")


def _load_sharded_tensors(path: Path) -> Dict[str, torch.Tensor]:
    """Read all weight tensors from a checkpoint dir: single
    ``model.safetensors``, or HF multi-file shards resolved through
    ``model.safetensors.index.json`` (falling back to a glob)."""
    single = path / "model.safetensors"
    if single.exists():
        return safetensors_io.load_file(single)
    index = path / "model.safetensors.index.json"
    if index.exists():
        weight_map = json.loads(index.read_text())["weight_map"]
        shards = sorted(set(weight_map.values()))
    else:
        shards = sorted(p.name for p in path.glob("model-*-of-*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no safetensors weights found in {path}")
    out: Dict[str, torch.Tensor] = {}
    for shard in shards:
        out.update(safetensors_io.load_file(path / shard))
    return out


def load_checkpoint(path, dtype=None, strict: Optional[bool] = None, device=None
                    ) -> Tuple[TTSModelConfig, Dict[str, Any]]:
    """Load either layout (sniffed from config.json) onto ``device`` (the
    card unless named):

      - canonical (``save_checkpoint``): config.json carries the full nested
        dataclass dict under a top-level "talker" key;
      - upstream HF torch layout: "talker_config" key, torch tensor names in
        [out,in]/[Cout,Cin,K] layout, optionally sharded across
        ``model-XXXXX-of-YYYYY.safetensors`` files.

    ``strict`` (torch layout only) gates the conversion completeness check;
    default is strict ON (override with QWEN3TTS_LOADER_STRICT=0) so naming
    drift in real upstream weights fails with the exact tensor names instead
    of silently dropping them.

    Talker and predictor floating leaves are cast to ``dtype`` (default: the
    config's, which the returned config then names); quantized ``{"q",
    "scale"}`` / ``{"q8", "scale"}`` leaves keep int8 / float32 as stored (the JAX loader rounds ``scale`` to
    the model dtype).  The codec and speaker encoder load in float32, as the
    port computes them.  Each tensor goes from the file's mapping to
    ``device`` once, through the weight bridge."""
    device = resolve_device(device)
    path = Path(path)
    raw_cfg = json.loads((path / "config.json").read_text())
    named = _load_sharded_tensors(path)
    if "talker" in raw_cfg:  # canonical format: flat names match the JAX pytree
        cfg = _cfg_from_canonical(raw_cfg)
        bundle = unflatten(named)
    else:  # upstream torch layout -> convert
        if strict is None:
            strict = os.environ.get("QWEN3TTS_LOADER_STRICT", "1") != "0"
        cfg = TTSModelConfig.from_dict(raw_cfg)
        bundle = convert_torch_checkpoint(named, cfg, strict=strict)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype_name(dtype))
    return cfg, bundle_from_jax_numpy(bundle, cfg, cfg.torch_dtype, device)


def _cfg_from_canonical(raw: Dict[str, Any]) -> TTSModelConfig:
    def mk(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in d.items() if k in names})

    top = {k: v for k, v in raw.items()
           if k in {f.name for f in dataclasses.fields(TTSModelConfig)}
           and k not in ("talker", "predictor", "codec", "speaker_encoder")}
    return TTSModelConfig(
        talker=mk(TalkerConfig, raw["talker"]),
        predictor=mk(PredictorConfig, raw["predictor"]),
        codec=mk(CodecConfig, raw["codec"]),
        speaker_encoder=mk(SpeakerEncoderConfig, raw["speaker_encoder"]),
        **top,
    )


# ---------------------------------------------------------------------------
# upstream torch-layout conversion (the JAX package's name surface)
# ---------------------------------------------------------------------------

_BLOCK_KEY = {
    "self_attn.q_proj.weight": "q_proj",
    "self_attn.k_proj.weight": "k_proj",
    "self_attn.v_proj.weight": "v_proj",
    "self_attn.o_proj.weight": "o_proj",
    "self_attn.q_norm.weight": "q_norm",
    "self_attn.k_norm.weight": "k_norm",
    "input_layernorm.weight": "input_norm",
    "post_attention_layernorm.weight": "post_norm",
    "mlp.gate_proj.weight": "gate_proj",
    "mlp.up_proj.weight": "up_proj",
    "mlp.down_proj.weight": "down_proj",
}


def convert_torch_tree(named_tensors: Dict[str, torch.Tensor], num_layers: int,
                       prefix: str = "talker.model",
                       consumed: Optional[set] = None,
                       partial_out: Optional[list] = None) -> Dict[str, Any]:
    """Stack upstream per-layer decoder tensors into the layer-stacked layout.

    Linear weights are transposed (torch stores [out,in]; the stacks are
    [in,out]).  Each stack is one new tensor in the stored dtype, built from
    the sources' views.  ``consumed`` (if given) collects the source names
    that matched; ``partial_out`` collects the exact torch names of
    per-layer tensors that are MISSING from partially-populated stacks
    (strict-mode diagnostics)."""
    layer_re = re.compile(
        re.escape(prefix)
        + r"\.layers\.(\d+)\.(self_attn\.(?:q|k|v|o)_proj\.weight|"
        r"self_attn\.(?:q|k)_norm\.weight|input_layernorm\.weight|"
        r"post_attention_layernorm\.weight|mlp\.(?:gate|up|down)_proj\.weight)"
    )
    per_layer: Dict[str, list] = {v: [None] * num_layers for v in _BLOCK_KEY.values()}
    for name, tensor in named_tensors.items():
        m = layer_re.fullmatch(name)
        if not m:
            continue
        li = int(m.group(1))
        if li >= num_layers:
            continue  # extra layers stay "unmatched sources" in the report
        key = _BLOCK_KEY[m.group(2)]
        per_layer[key][li] = _rev(tensor) if key.endswith("_proj") else tensor
        if consumed is not None:
            consumed.add(name)
    if partial_out is not None:
        inv = {v: k for k, v in _BLOCK_KEY.items()}
        for key, vals in per_layer.items():
            holes = [i for i, x in enumerate(vals) if x is None]
            if holes and len(holes) < num_layers:
                partial_out.extend(f"{prefix}.layers.{i}.{inv[key]}" for i in holes)
    stacked = {k: torch.stack(v) for k, v in per_layer.items()
               if all(x is not None for x in v)}
    # checkpoints keep the upstream unfused names; the runtime uses fused
    # qkv/gateup matmuls (models/layers.py)
    if {"q_proj", "k_proj", "v_proj"} <= set(stacked):
        stacked["qkv_proj"] = torch.cat(
            [stacked.pop("q_proj"), stacked.pop("k_proj"), stacked.pop("v_proj")], dim=-1)
    if {"gate_proj", "up_proj"} <= set(stacked):
        stacked["gateup_proj"] = torch.cat(
            [stacked.pop("gate_proj"), stacked.pop("up_proj")], dim=-1)
    return stacked


# name -> (the JAX pytree path, transpose?) for the non-layer tensors
_TALKER_TOP = {
    "talker.model.codec_embedding.weight": ("codec_embedding", False),
    "talker.model.text_embedding.weight": ("text_embedding", False),
    "talker.text_projection.weight": ("text_projection/w", True),
    "talker.text_projection.bias": ("text_projection/b", False),
    "talker.model.norm.weight": ("final_norm", False),
    "talker.codec_head.weight": ("codec_head", True),
    "talker.spk_proj.weight": ("spk_proj/w", True),
    "talker.spk_proj.bias": ("spk_proj/b", False),
}
_PRED_TOP = {
    "talker.code_predictor.small_to_mtp_projection.weight": ("small_to_mtp/w", True),
    "talker.code_predictor.small_to_mtp_projection.bias": ("small_to_mtp/b", False),
    "talker.code_predictor.model.norm.weight": ("final_norm", False),
}


# The codec and speaker halves convert through one systematic bijection
# between the JAX pytree and torch naming/layout conventions ([out,in]
# linears, [Cout,Cin,K] convs, ModuleList indices), the JAX package's.


def export_aux_tree(tree: Any, prefix: str) -> Dict[str, torch.Tensor]:
    """JAX pytree -> torch-named tensors.  Leaf 'w' -> '.weight' (rank-2
    transposed to [out,in]; rank-3 conv to [Cout,Cin,K]); 'b' -> '.bias';
    every other leaf keeps its name and layout."""
    out: Dict[str, torch.Tensor] = {}
    for path, t in flatten(tree, prefix + SEP).items():
        parts = path.split(SEP)
        if parts[-1] == "w":
            parts[-1] = "weight"
            t = t.permute(2, 1, 0) if t.ndim == 3 else _rev(t)
        elif parts[-1] == "b":
            parts[-1] = "bias"
        out[".".join(parts)] = t
    return out


def convert_aux_tree(named_tensors: Dict[str, torch.Tensor], prefix: str,
                     consumed: Optional[set] = None) -> Any:
    """Inverse of ``export_aux_tree``: torch-named tensors under ``prefix`` ->
    the nested JAX pytree.  Returns None if no tensors carry the prefix."""
    flat: Dict[str, torch.Tensor] = {}
    pfx = prefix + "."
    for name, t in named_tensors.items():
        if not name.startswith(pfx):
            continue
        parts = name[len(pfx):].split(".")
        if parts[-1] == "weight":
            parts[-1] = "w"
            t = t.permute(2, 1, 0) if t.ndim == 3 else _rev(t)
        elif parts[-1] == "bias":
            parts[-1] = "b"
        flat[SEP.join(parts)] = t
        if consumed is not None:
            consumed.add(name)
    return unflatten(flat) if flat else None


# ---------------------------------------------------------------------------
# naming aliases for plausible upstream variants: each rule rewrites a name
# that matches NO conversion pattern into one that does (the JAX package's
# tables; RUNBOOK.md has the procedure for real weights)
# ---------------------------------------------------------------------------

# torch bookkeeping buffers that are never model weights: dropped before
# conversion (reported under report.ignored, not as errors)
_NONWEIGHT_RE = re.compile(
    r"\.(num_batches_tracked|attn\.masked_bias|rotary_emb\.inv_freq)$")

# (variant_prefix, canonical_prefix) — tried in order, first hit wins
_PREFIX_ALIASES = [
    ("model.", ""),                      # whole-model "model." wrapper
    ("tts_model.", ""),
    ("talker.language_model.model.", "talker.model."),
    ("talker.language_model.", "talker.model."),
    ("talker.transformer.", "talker.model."),
    ("talker.model.code_predictor.", "talker.code_predictor."),
    ("code_predictor.", "talker.code_predictor."),
    ("speech_tokenizer.model.", "speech_tokenizer."),
    ("codec.", "speech_tokenizer."),
    ("audio_tokenizer.", "speech_tokenizer."),
    ("spk_encoder.", "speaker_encoder."),
    ("speaker_model.", "speaker_encoder."),
    ("xvector_model.", "speaker_encoder."),
]

# exact-name variants (leaf-level renames)
_EXACT_ALIASES = {
    "talker.model.embed_tokens.weight": "talker.model.codec_embedding.weight",
    "talker.lm_head.weight": "talker.codec_head.weight",
    "talker.model.text_embed.weight": "talker.model.text_embedding.weight",
    "talker.text_proj.weight": "talker.text_projection.weight",
    "talker.text_proj.bias": "talker.text_projection.bias",
    "talker.speaker_projection.weight": "talker.spk_proj.weight",
    "talker.speaker_projection.bias": "talker.spk_proj.bias",
}

_LAYER_SUFFIX_RE = (
    r"\.layers\.\d+\.(self_attn\.(?:q|k|v|o)_proj\.weight|"
    r"self_attn\.(?:q|k)_norm\.weight|input_layernorm\.weight|"
    r"post_attention_layernorm\.weight|mlp\.(?:gate|up|down)_proj\.weight)"
)
_RECOGNIZED_RE = re.compile(
    "|".join([
        re.escape("talker.model") + _LAYER_SUFFIX_RE,
        re.escape("talker.code_predictor.model") + _LAYER_SUFFIX_RE,
        r"talker\.code_predictor\.lm_head\.\d+\.weight",
        r"talker\.code_predictor\.model\.codec_embedding\.\d+\.weight",
    ])
)

_AUX_PREFIX = {"codec": "speech_tokenizer", "speaker": "speaker_encoder"}


def _aux_torch_names(expected_paths) -> set:
    """Canonical torch names for the codec/speaker halves, derived from the
    expected pytree paths (the aux conversion is a mechanical bijection, so
    the full legal name set is computable — and alias rules can target it
    exactly instead of accepting any name under the prefix)."""
    names = set()
    for p in expected_paths:
        parts = p.split(SEP)
        prefix = _AUX_PREFIX.get(parts[0])
        if prefix is None:
            continue
        rest = parts[1:]
        if rest and rest[-1] == "w":
            rest[-1] = "weight"
        elif rest and rest[-1] == "b":
            rest[-1] = "bias"
        names.add(".".join([prefix] + rest))
    return names


def _recognized(name: str, aux_names: Optional[set] = None) -> bool:
    if (name in _TALKER_TOP or name in _PRED_TOP
            or _RECOGNIZED_RE.fullmatch(name) is not None):
        return True
    if aux_names is not None:
        return name in aux_names
    return name.startswith(("speech_tokenizer.", "speaker_encoder."))


def apply_name_aliases(named_tensors: Dict[str, torch.Tensor],
                       aux_names: Optional[set] = None
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """Rewrite unrecognized tensor names through the alias tables.  A rename
    only happens when the original name matches no conversion rule AND the
    rewritten name does (so canonical checkpoints pass through untouched).
    ``aux_names``: exact legal codec/speaker names (else prefix match).
    Returns (renamed_dict, {original: canonical} log)."""
    out: Dict[str, torch.Tensor] = {}
    renames: Dict[str, str] = {}
    for name, tensor in named_tensors.items():
        if _recognized(name, aux_names):
            out[name] = tensor
            continue
        cand = _EXACT_ALIASES.get(name)
        if cand is None or not _recognized(cand, aux_names) or cand in named_tensors:
            cand = None
            for variant, canon in _PREFIX_ALIASES:
                if name.startswith(variant):
                    rewritten = canon + name[len(variant):]
                    # one more exact-alias hop after the prefix strip
                    rewritten = _EXACT_ALIASES.get(rewritten, rewritten)
                    if _recognized(rewritten, aux_names) and rewritten not in named_tensors:
                        cand = rewritten
                        break
        if cand is not None and cand in out:
            # two variant names rewrote to the same canonical key — keep the
            # first, leave this one under its original (unrecognized) name so
            # strict mode reports it instead of silently overwriting
            cand = None
        if cand is not None:
            renames[name] = cand
            out[cand] = tensor
        else:
            out[name] = tensor
    return out, renames


# ---------------------------------------------------------------------------
# strict-mode conversion report
# ---------------------------------------------------------------------------


def expected_bundle_shapes(cfg: TTSModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat {JAX pytree path: shape} of a COMPLETE bundle for ``cfg``: the
    port's ``init_params`` on the meta device (shapes only, no weights
    drawn), mapped through ``bundle_to_jax_layout``."""
    from ..models import codec as codec_lib
    from ..models import predictor as predictor_lib
    from ..models import speaker as speaker_lib
    from ..models import talker as talker_lib

    meta, f32 = torch.device("meta"), torch.float32
    params = {
        "talker": talker_lib.init_params(None, cfg.talker, f32, meta),
        "predictor": predictor_lib.init_params(None, cfg.predictor, cfg.talker.hidden_size,
                                               f32, meta),
        "codec": codec_lib.init_params(None, cfg.codec, f32, meta),
        "speaker": speaker_lib.init_params(None, cfg.speaker_encoder, f32, meta),
    }
    return {k: tuple(v.shape) for k, v in flatten(bundle_to_jax_layout(params, meta)).items()}


class ConversionReport:
    """Diagnostics from a torch-checkpoint conversion: what matched, what was
    renamed, what's left over on either side.  ``raise_if_bad()`` is the
    strict mode — it fails with every exact name in the message, so a naming
    drift in real upstream weights is an alias-table fix, not a silent
    quality bug.  The wording is the JAX package's."""

    def __init__(self):
        self.matched = 0
        self.renamed: Dict[str, str] = {}
        self.unmatched_sources: list = []
        self.missing_targets: list = []
        self.missing_layer_tensors: list = []
        self.missing_groups: list = []
        self.shape_mismatches: list = []
        self.unexpected_targets: list = []
        self.ignored: list = []  # well-known non-weight buffers, dropped

    @property
    def ok(self) -> bool:
        return not (self.unmatched_sources or self.missing_targets
                    or self.missing_layer_tensors or self.missing_groups
                    or self.shape_mismatches or self.unexpected_targets)

    def _section(self, title, items, limit=30):
        if not items:
            return []
        lines = [f"  {title} ({len(items)}):"]
        for it in items[:limit]:
            lines.append(f"    - {it}")
        if len(items) > limit:
            lines.append(f"    ... and {len(items) - limit} more")
        return lines

    def summary(self, limit: int = 30) -> str:
        lines = [f"conversion report: {self.matched} tensors matched, "
                 f"{len(self.renamed)} renamed via aliases, "
                 f"{'OK' if self.ok else 'PROBLEMS FOUND'}"]
        lines += self._section(
            "renamed (variant → canonical)",
            [f"{a} → {b}" for a, b in sorted(self.renamed.items())], limit)
        lines += self._section(
            "MISSING tensor groups (no tensors at all for these sub-models)",
            sorted(self.missing_groups), limit)
        lines += self._section(
            "UNMATCHED source tensors (no conversion rule; add an alias "
            "in core/loader.py or ignore if non-weight)",
            sorted(self.unmatched_sources), limit)
        lines += self._section(
            "MISSING per-layer tensors (expected torch names)",
            sorted(self.missing_layer_tensors), limit)
        lines += self._section(
            "UNFILLED target leaves (our pytree paths the checkpoint "
            "never produced)", sorted(self.missing_targets), limit)
        lines += self._section(
            "SHAPE mismatches (path: got vs expected)",
            [f"{p}: {g} vs {e}" for p, g, e in self.shape_mismatches], limit)
        lines += self._section(
            "UNEXPECTED produced leaves (source tensors that converted into "
            "pytree paths the model does not define — e.g. EMA/statistics "
            "buffers under speech_tokenizer./speaker_encoder.)",
            sorted(self.unexpected_targets), limit)
        lines += self._section(
            "ignored non-weight buffers (dropped, not an error)",
            sorted(self.ignored), limit)
        return "\n".join(lines)

    def raise_if_bad(self):
        if not self.ok:
            raise ValueError(
                "torch-checkpoint conversion is incomplete — refusing to "
                "load a partial model (pass strict=False to force).\n"
                + self.summary()
                + "\nSee RUNBOOK.md for the weight-conversion procedure.")


def convert_torch_checkpoint(named_tensors: Dict[str, torch.Tensor], cfg: TTSModelConfig, *,
                             strict: bool = False,
                             report: Optional[ConversionReport] = None) -> Dict[str, Any]:
    """Conversion of an upstream torch-layout state dict into a full
    {'talker', 'predictor', 'codec', 'speaker'} JAX-layout bundle of CPU
    tensors: per-codebook ModuleLists become stacked tensors, per-layer
    decoder tensors become [L, ...] stacks, codec/speaker trees convert
    through the generic bijection above.

    Unrecognized names are first normalized through the alias tables.  With
    ``strict=True`` every unmatched source tensor, unfilled target leaf and
    shape mismatch is reported in one actionable error."""
    if report is None:
        report = ConversionReport()
    expected = expected_bundle_shapes(cfg)
    # drop well-known torch bookkeeping buffers up front: they are not
    # weights and must neither demand an alias entry nor leak into the aux
    # prefix conversion (convert_aux_tree consumes anything under its prefix)
    dropped = [n for n in named_tensors if _NONWEIGHT_RE.search(n)]
    if dropped:
        named_tensors = {n: t for n, t in named_tensors.items()
                         if not _NONWEIGHT_RE.search(n)}
        report.ignored = sorted(dropped)
    named_tensors, report.renamed = apply_name_aliases(named_tensors,
                                                       _aux_torch_names(expected))
    consumed: set = set()
    talker: Dict[str, Any] = {
        "blocks": convert_torch_tree(
            named_tensors, cfg.talker.num_hidden_layers, "talker.model",
            consumed=consumed, partial_out=report.missing_layer_tensors),
    }
    predictor: Dict[str, Any] = {
        "blocks": convert_torch_tree(
            named_tensors, cfg.predictor.num_hidden_layers, "talker.code_predictor.model",
            consumed=consumed, partial_out=report.missing_layer_tensors),
    }
    flat_t: Dict[str, torch.Tensor] = {}
    flat_p: Dict[str, torch.Tensor] = {}
    for name, t in named_tensors.items():
        if name in _TALKER_TOP:
            path, transpose = _TALKER_TOP[name]
            flat_t[path] = _rev(t) if transpose else t
            consumed.add(name)
        elif name in _PRED_TOP:
            path, transpose = _PRED_TOP[name]
            flat_p[path] = _rev(t) if transpose else t
            consumed.add(name)

    # per-codebook ModuleLists -> stacked tensors
    nc = cfg.predictor.num_codebooks
    head_names = [f"talker.code_predictor.lm_head.{i}.weight" for i in range(nc)]
    heads = [named_tensors.get(n) for n in head_names]
    if all(h is not None for h in heads):
        flat_p["lm_heads"] = torch.stack([_rev(h) for h in heads])
        consumed.update(head_names)
    else:
        report.missing_layer_tensors.extend(n for n, h in zip(head_names, heads) if h is None)
        consumed.update(n for n, h in zip(head_names, heads) if h is not None)
    embed_names = [f"talker.code_predictor.model.codec_embedding.{i}.weight"
                   for i in range(nc)]
    embeds = [named_tensors.get(n) for n in embed_names]
    if all(e is not None for e in embeds):
        flat_p["codec_embeddings"] = torch.stack(embeds)
        consumed.update(embed_names)
    else:
        report.missing_layer_tensors.extend(n for n, e in zip(embed_names, embeds) if e is None)
        consumed.update(n for n, e in zip(embed_names, embeds) if e is not None)

    talker.update(unflatten(flat_t))
    predictor.update(unflatten(flat_p))

    codec = convert_aux_tree(named_tensors, "speech_tokenizer", consumed=consumed)
    speaker = convert_aux_tree(named_tensors, "speaker_encoder", consumed=consumed)

    report.unmatched_sources = [n for n in named_tensors if n not in consumed]
    report.missing_groups = [
        n for n, half in (("speech_tokenizer (codec)", codec),
                          ("speaker_encoder", speaker)) if half is None]
    bundle = {"talker": talker, "predictor": predictor,
              "codec": codec if codec is not None else {},
              "speaker": speaker if speaker is not None else {}}
    produced = {k: tuple(v.shape) for k, v in flatten(bundle).items()}
    report.missing_targets = sorted(set(expected) - set(produced))
    report.shape_mismatches = [
        (k, produced[k], expected[k])
        for k in sorted(set(produced) & set(expected))
        if produced[k] != expected[k]
    ]
    # convert_aux_tree consumes ANY tensor under its prefix, so junk sources
    # (EMA buffers, num_batches_tracked, ...) become extra pytree leaves the
    # model never defined: report them, and prune so they are never loaded
    report.unexpected_targets = sorted(set(produced) - set(expected))
    if report.unexpected_targets:
        flat_all = flatten(bundle)
        for k in report.unexpected_targets:
            del flat_all[k]
        bundle = unflatten(flat_all)
    report.matched = len(consumed)

    if strict:
        report.raise_if_bad()
    elif not report.ok:
        logger.warning("torch-checkpoint conversion problems:\n%s", report.summary())
    missing = [n for n, half in (("speech_tokenizer", codec),
                                 ("speaker_encoder", speaker)) if half is None]
    if missing:
        raise ValueError(
            f"checkpoint is missing the {missing} tensor group(s); a partial "
            "model cannot synthesize audio. Convert/merge all four sub-models "
            "into one checkpoint dir (see core/loader.py docstring and "
            "RUNBOOK.md)."
        )
    return bundle


def export_torch_layout(bundle: Dict[str, Any], cfg: TTSModelConfig
                        ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_torch_checkpoint``: a JAX-layout bundle
    (``bundle_to_jax_layout``) -> torch-named tensors (views)."""
    out: Dict[str, torch.Tensor] = {}

    def put_blocks(blocks, prefix, q_dim, kv_dim, inter):
        inv = {v: k for k, v in _BLOCK_KEY.items()}
        qkv, gu = blocks["qkv_proj"], blocks["gateup_proj"]
        unfused = dict(blocks)
        unfused["q_proj"] = qkv[..., :q_dim]
        unfused["k_proj"] = qkv[..., q_dim: q_dim + kv_dim]
        unfused["v_proj"] = qkv[..., q_dim + kv_dim:]
        unfused["gate_proj"] = gu[..., :inter]
        unfused["up_proj"] = gu[..., inter:]
        for our, torch_key in inv.items():
            arr = unfused[our]
            for li in range(qkv.shape[0]):
                out[f"{prefix}.layers.{li}.{torch_key}"] = (
                    _rev(arr[li]) if our.endswith("_proj") else arr[li])

    tk, pd = cfg.talker, cfg.predictor
    put_blocks(bundle["talker"]["blocks"], "talker.model",
               tk.num_attention_heads * tk.head_dim,
               tk.num_key_value_heads * tk.head_dim, tk.intermediate_size)
    put_blocks(bundle["predictor"]["blocks"], "talker.code_predictor.model",
               pd.num_attention_heads * pd.head_dim,
               pd.num_key_value_heads * pd.head_dim, pd.intermediate_size)
    for part, table in (("talker", _TALKER_TOP), ("predictor", _PRED_TOP)):
        for name, (path, transpose) in table.items():
            leaf = bundle[part]
            for key in path.split(SEP):
                leaf = leaf[key]
            out[name] = _rev(leaf) if transpose else leaf
    lm, ce = bundle["predictor"]["lm_heads"], bundle["predictor"]["codec_embeddings"]
    for i in range(lm.shape[0]):
        out[f"talker.code_predictor.lm_head.{i}.weight"] = _rev(lm[i])
        out[f"talker.code_predictor.model.codec_embedding.{i}.weight"] = ce[i]
    if "codec" in bundle:
        out.update(export_aux_tree(bundle["codec"], "speech_tokenizer"))
    if "speaker" in bundle:
        out.update(export_aux_tree(bundle["speaker"], "speaker_encoder"))
    return out


def export_torch_checkpoint(path, cfg: TTSModelConfig, bundle: Dict[str, Any],
                            num_shards: int = 1, tokenizer_json: Optional[str] = None) -> None:
    """Write an upstream-HF-layout checkpoint dir from a JAX-layout bundle
    (``bundle_to_jax_layout(model.params)``): HF-style config.json,
    torch-named/[out,in]-layout tensors across ``num_shards`` safetensors
    files with an index.json, optional tokenizer.json.  The inverse of
    ``load_checkpoint``'s torch branch."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg.to_hf_dict(), indent=2))
    named = export_torch_layout(bundle, cfg)
    names = sorted(named)
    if num_shards <= 1:
        safetensors_io.save_file(named, path / "model.safetensors")
    else:
        per = -(-len(names) // num_shards)
        weight_map: Dict[str, str] = {}
        for si in range(num_shards):
            shard_names = names[si * per: (si + 1) * per]
            fname = f"model-{si + 1:05d}-of-{num_shards:05d}.safetensors"
            safetensors_io.save_file({n: named[n] for n in shard_names}, path / fname)
            weight_map.update({n: fname for n in shard_names})
        (path / "model.safetensors.index.json").write_text(
            json.dumps({"metadata": {}, "weight_map": weight_map}, indent=2))
    if tokenizer_json:
        (path / "tokenizer.json").write_text(Path(tokenizer_json).read_text())


def diagnose_torch_checkpoint(path) -> ConversionReport:
    """Dry-run the torch-layout conversion of a checkpoint dir on the CPU and
    return the full report (never raises on conversion problems).  CLI:
    ``qwen3tts-tpu-torch check-checkpoint <dir>``."""
    path = Path(path)
    raw_cfg = json.loads((path / "config.json").read_text())
    if "talker" in raw_cfg:
        raise ValueError(
            f"{path} is a canonical-format checkpoint (no conversion "
            "involved); diagnosis applies to upstream torch-layout dirs")
    cfg = TTSModelConfig.from_dict(raw_cfg)
    named = _load_sharded_tensors(path)
    report = ConversionReport()
    try:
        convert_torch_checkpoint(named, cfg, strict=False, report=report)
    except ValueError:
        pass  # missing-group raise — everything is already in the report
    return report
