"""The talker: a Qwen3-style decoder emitting codec codebook 0.

Port of ``qwen3tts_tpu/models/talker.py``: codec/text embeddings, the
speaker projection, the stacked decoder blocks with MRoPE-3 + GQA, and the
codec head.  Prefill writes straight into the static KV cache; decode masks
and RoPE positions derive from (pos, pad_count) device tensors.

Every function that reads parameters takes an optional tp ``group``
(``parallel/sharding.py``); with one, ``params`` is this rank's shard
(``talker_param_specs``): the codec embedding holds a slice of the hidden
axis (looked up, then all-gathered), the codec head a slice of its
vocabulary (the logits all-gathered), the blocks and the KV cache their kv
heads.  The text embedding, the text projection and the speaker projection
are sharded too, but nothing here reads them: the prompt is built on the
host from whole leaves (``api/prompt.py``).  With grad enabled the
collectives are the ones that carry gradients (``parallel/collectives.py``:
``copy_to_tp`` before the codec head, ``gather_from_tp`` after it and after
the embedding lookup).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.config import TalkerConfig
from ..ops.rope import mrope_cos_sin
from ..parallel.collectives import (all_gather, carries_grads, copy_to_tp, gather_from_tp,
                                   size)
from .layers import (
    BlockSpec,
    decode_mask,
    init_block_stack,
    init_kv_cache,
    prefill_mask,
    randn,
    rms_norm,
    stack_forward,
)

Params = Dict


def block_spec(cfg: TalkerConfig, tp: int = 1) -> BlockSpec:
    """The stack's geometry, one rank's share of it at ``tp``."""
    return BlockSpec(
        num_layers=cfg.num_hidden_layers,
        hidden_size=cfg.hidden_size,
        num_heads=cfg.num_attention_heads,
        num_kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim,
        intermediate_size=cfg.intermediate_size,
        rms_norm_eps=cfg.rms_norm_eps,
    ).shard(tp)


def layer_sliding_flags(cfg: TalkerConfig) -> List[bool]:
    return [cfg.layer_is_sliding(i) for i in range(cfg.num_hidden_layers)]


def init_params(gen: torch.Generator, cfg: TalkerConfig, dtype, device) -> Params:
    """Random talker parameters with the JAX initialisers' shapes and scales."""
    H, V = cfg.hidden_size, cfg.vocab_size
    zeros = dict(dtype=dtype, device=device)
    return {
        "codec_embedding": randn(gen, (V, H), 0.02, dtype, device),
        "text_embedding": randn(gen, (cfg.text_vocab_size, cfg.text_hidden_size),
                                0.02, dtype, device),
        "text_projection": {
            "w": randn(gen, (cfg.text_hidden_size, H), cfg.text_hidden_size ** -0.5,
                       dtype, device),
            "b": torch.zeros((H,), **zeros),
        },
        "blocks": init_block_stack(gen, block_spec(cfg), dtype, device),
        "final_norm": torch.ones((H,), **zeros),
        "codec_head": randn(gen, (H, V), H ** -0.5, dtype, device),
        "spk_proj": {
            "w": randn(gen, (cfg.speaker_embed_dim, H), cfg.speaker_embed_dim ** -0.5,
                       dtype, device),
            "b": torch.zeros((H,), **zeros),
        },
    }


def new_kv_cache(cfg: TalkerConfig, batch: int, max_len: int, dtype, device,
                 kv_quant: bool = False, tp: int = 1):
    """The static cache, of one rank's kv heads at ``tp``."""
    return init_kv_cache(block_spec(cfg, tp), batch, max_len, dtype, device, kv_quant=kv_quant)


def embed_codec(params: Params, ids: torch.Tensor, group=None) -> torch.Tensor:
    rows = params["codec_embedding"][ids]
    if group is None:
        return rows
    return gather_from_tp(rows, group) if carries_grads(group) else all_gather(rows, group)


def codec_head(params: Params, hidden: torch.Tensor, group=None) -> torch.Tensor:
    if carries_grads(group):
        hidden = copy_to_tp(hidden, group)
    logits = (hidden @ params["codec_head"]).float()
    if group is None:
        return logits
    return gather_from_tp(logits, group) if carries_grads(group) else all_gather(logits, group)


def _positions(cfg: TalkerConfig, pos_1d: torch.Tensor):
    """pos_1d: [B, T] effective (pad-corrected) positions -> MRoPE cos/sin."""
    pos3 = pos_1d.unsqueeze(0).expand(3, *pos_1d.shape)
    return mrope_cos_sin(pos3, cfg.head_dim, cfg.rope_theta, cfg.mrope_section)


def prefill(
    params: Params,
    cfg: TalkerConfig,
    inputs_embeds: torch.Tensor,  # [B, T, H]
    pad_count: torch.Tensor,  # [B] int32 left pads
    kv: Params,  # static cache [L, B, S, KVH, D], written in place from slot 0
    layers: Optional[Sequence[Params]] = None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """Full-sequence prefill.  Returns (last_hidden [B,1,H], logits [B,V], kv)."""
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    eff = torch.arange(T, device=dev)[None, :] - pad_count.reshape(-1, 1).long()
    cos, sin = _positions(cfg, eff.clamp_min(0))
    m_full = prefill_mask(T, T, pad_count)
    m_slide = (prefill_mask(T, T, pad_count, cfg.sliding_window)
               if cfg.sliding_window is not None else None)
    x, kv = stack_forward(
        layers if layers is not None else params["blocks"], inputs_embeds, cos, sin,
        kv, 0, m_full, block_spec(cfg, size(group)), mask_sliding=m_slide,
        layer_is_sliding=layer_sliding_flags(cfg) if m_slide is not None else None,
        group=group)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = x[:, -1:, :]
    return last, codec_head(params, last[:, 0, :], group), kv


def decode_step(
    params: Params,
    cfg: TalkerConfig,
    x: torch.Tensor,  # [B, 1, H]
    pos: torch.Tensor,  # int32 device tensor, one element: the slot to write
    pad_count: torch.Tensor,  # [B] int32
    kv: Params,
    use_flash: bool = False,
    layers: Optional[Sequence[Params]] = None,
    fused: bool = False,
    group=None,
) -> Tuple[torch.Tensor, Params]:
    """Single-token decode over the static cache.  Returns (hidden [B,1,H], kv).
    RoPE position is ``pos - pad_count``.  ``fused`` runs each block's two
    halves through the fused kernels (prefill never does)."""
    S = kv["k"].shape[2]
    eff = (pos.reshape(1) - pad_count).reshape(-1, 1)
    cos, sin = _positions(cfg, eff)
    flash_ctx = None
    m_full = m_slide = None
    if use_flash:
        flash_ctx = {"pos": pos, "pad": pad_count, "window": cfg.sliding_window}
    else:
        m_full = decode_mask(S, pos, pad_count)
        if cfg.sliding_window is not None:
            m_slide = decode_mask(S, pos, pad_count, cfg.sliding_window)
    sliding = layer_sliding_flags(cfg) if cfg.sliding_window is not None else None
    x, kv = stack_forward(
        layers if layers is not None else params["blocks"], x, cos, sin, kv, pos,
        m_full, block_spec(cfg, size(group)), mask_sliding=m_slide,
        layer_is_sliding=sliding, flash_ctx=flash_ctx, fused=fused, group=group)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), kv
