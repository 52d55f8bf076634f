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
from . import lfm2
from .layers import (
    BlockSpec,
    decode_mask,
    init_block_stack,
    init_kv_cache,
    prefill_mask,
    randn,
    rms_norm,
    stack_forward,
    unstack_layers,
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
    """Random talker parameters with the JAX initialisers' shapes and scales
    (a hybrid talker's: ``models/lfm2.py``)."""
    if cfg.is_hybrid:
        return lfm2.init_params(gen, cfg, dtype, device)
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
    """The static cache, of one rank's kv heads at ``tp`` (a hybrid talker's
    KV of its attention layers and convolution state: ``models/lfm2.py``)."""
    if cfg.is_hybrid:
        check_hybrid(cfg, kv_quant=kv_quant, tp=tp)
        return lfm2.new_cache(cfg, batch, max_len, dtype, device)
    return init_kv_cache(block_spec(cfg, tp), batch, max_len, dtype, device, kv_quant=kv_quant)


def roll_cache(kv: Dict[str, torch.Tensor], roll: int, Tb: int) -> None:
    """Roll the cache ``roll`` slots left along its position axis (2 of k/v
    [L, B, S, KVH, D], 3 of the int8 scales [L, B, KVH, S]), in place, as
    far as it is read: slots [roll, Tb) move to [0, Tb - roll).  Per-row
    state (``lfm2.ROW_STATE``: the hybrid talker's convolution state) has no
    position axis and stays."""
    for name, t in kv.items():
        if name in lfm2.ROW_STATE:
            continue
        axis = 2 if t.dim() == 5 else 3
        t.narrow(axis, 0, Tb - roll).copy_(t.narrow(axis, roll, Tb - roll).clone())


def splice_row(kv: Dict[str, torch.Tensor], row: int, one: Dict[str, torch.Tensor],
               slots: torch.Tensor) -> None:
    """Write ``one``, a one-row cache, into row ``row`` of ``kv``: each
    positional leaf at ``slots`` of its position axis, per-row state
    whole."""
    for name, t in one.items():
        if name in lfm2.ROW_STATE:
            kv[name][:, row].copy_(t[:, 0])
        else:
            axis = 1 if t.dim() == 5 else 2  # of the row's view: position axis
            kv[name][:, row].index_copy_(axis, slots, t[:, 0])


def with_row_state_copied(kv: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``kv`` with its per-row state cloned: what a step rewrites beyond
    its position's slot, so that a step run on the result leaves ``kv``'s
    state as it was."""
    return {name: t.clone() if name in lfm2.ROW_STATE else t for name, t in kv.items()}


def check_hybrid(cfg: TalkerConfig, kv_quant: bool = False, tp: int = 1, group=None,
                 fused: bool = False) -> None:
    """Raise for what the hybrid (LFM2) talker does not run: an int8 KV
    cache, tensor parallelism, the fused block kernels."""
    if kv_quant or tp != 1 or group is not None or fused:
        raise ValueError("the hybrid LFM2 talker runs with a float KV cache, unsharded and "
                         "without the fused block kernels")


def layer_views(params: Params, cfg: TalkerConfig, stats=None) -> List[Params]:
    """Per-layer views of the blocks, built once for the decode loop (a
    hybrid talker's carry their kinds and, with ``stats``, its routed
    layers' counters)."""
    if cfg.is_hybrid:
        return lfm2.layer_views(params["blocks"], cfg, stats)
    return unstack_layers(params["blocks"])


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
    if cfg.is_hybrid:
        check_hybrid(cfg, group=group)
        x = lfm2.prefill(params, cfg, inputs_embeds, pad_count, kv, cos, sin, layers)
        last = x[:, -1:, :]
        return last, codec_head(params, last[:, 0, :]), kv
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
    if cfg.is_hybrid:
        check_hybrid(cfg, group=group, fused=fused)
        return lfm2.decode_step(params, cfg, x, cos, sin, pos, pad_count, kv, use_flash,
                                layers), kv
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
