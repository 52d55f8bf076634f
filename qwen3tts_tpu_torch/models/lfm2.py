"""The hybrid talker: LFM2's backbone (gated short convolutions, GQA
attention, dense and routed-expert FFNs) in place of the Qwen3 decoder
stack, with the same embeddings, speaker projection and codec head
(``models/talker.py`` dispatches here when ``TalkerConfig.is_hybrid``).

Each layer is ``h = x + Op(rms(x, input_norm))``, then ``out = h +
FFN(rms(h, post_norm))``; after the last, the final norm.  ``Op`` is, per
``layer_types``:

- ``conv`` (``conv_L_cache`` = 3 taps, no bias): ``[b, c, u] = split3(z @
  in_proj)``, ``v_t = sum_j w_j * (b * u)_{t-2+j}`` (a depthwise causal
  convolution: terms before the first real position, and at left-pad
  positions, are zero), ``y = (c * v) @ out_proj``.  In decode the state
  holds each row's last 3 values of ``b * u``;
- ``full_attention``: ``models/layers.py:attend`` (GQA with per-head q/k
  RMSNorm and rotate-half RoPE) and ``o_proj``.

The FFN is a SwiGLU (``layers.swiglu``) in the first ``num_dense_layers``
layers and the routed experts (``ops/routed_experts.py``) in the rest.

Parameters (matrices ``[in, out]``, a leading axis per kind of layer):
``blocks`` = ``{"moe": {experts_gateup [Lm, E, H, 2I], experts_down [Lm, E,
I, H], router [Lm, H, E], expert_bias [Lm, E], post_norm}, "dense":
{gateup_proj, down_proj, post_norm}, "conv": {in_proj [Lc, H, 3H], conv_w
[Lc, 3, H], out_proj, input_norm}, "attn": {qkv_proj, o_proj, q_norm,
k_norm, input_norm}}``.  The cache is ``{"k", "v"}`` [La, B, S, KVH, D] for
the attention layers only and ``"conv"`` [Lc, B, H, 3] beside it: per-row
state (``ROW_STATE``), never rolled along its taps and copied whole when a
row joins (``models/talker.py:roll_cache`` / ``splice_row``).  The stack runs unsharded, without the fused block
kernels and with a float cache; those raise.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.config import TalkerConfig
from ..ops.quant import maybe_matmul
from ..ops.routed_experts import RouteStats, routed_experts
from ..utils.timing import TRACE
from .layers import BlockSpec, attend, decode_mask, prefill_mask, randn, rms_norm, swiglu

Params = Dict
# the cache leaves that hold per-row state, with no position axis
ROW_STATE = ("conv",)


def layer_plan(cfg: TalkerConfig) -> List[Tuple[str, int, str, int]]:
    """(operator "conv" | "attn", its index among its kind, FFN "dense" |
    "moe", its index among its kind) of each layer."""
    plan, n = [], {"conv": 0, "attn": 0, "dense": 0, "moe": 0}
    for i, kind in enumerate(cfg.layer_types):
        op = "conv" if kind == "conv" else "attn"
        if kind not in ("conv", "full_attention"):
            raise ValueError(f"hybrid talker layer {i}: {kind!r} (conv or full_attention)")
        ffn = "dense" if i < cfg.num_dense_layers else "moe"
        plan.append((op, n[op], ffn, n[ffn]))
        n[op] += 1
        n[ffn] += 1
    return plan


def counts(cfg: TalkerConfig) -> Dict[str, int]:
    """Layers of each kind."""
    plan = layer_plan(cfg)
    return {k: sum(1 for p in plan if k in (p[0], p[2])) for k in ("conv", "attn", "dense", "moe")}


def attn_spec(cfg: TalkerConfig) -> BlockSpec:
    return BlockSpec(num_layers=counts(cfg)["attn"], hidden_size=cfg.hidden_size,
                     num_heads=cfg.num_attention_heads, num_kv_heads=cfg.num_key_value_heads,
                     head_dim=cfg.head_dim, intermediate_size=cfg.intermediate_size,
                     rms_norm_eps=cfg.rms_norm_eps)


def check(cfg: TalkerConfig) -> None:
    if cfg.conv_L_cache != 3 or cfg.conv_bias:
        raise ValueError(f"hybrid talker: conv_L_cache {cfg.conv_L_cache}, conv_bias "
                         f"{cfg.conv_bias} (3 taps without bias are implemented)")
    if cfg.sliding_window is not None:
        raise ValueError("hybrid talker: no sliding window")


def init_params(gen: Optional[torch.Generator], cfg: TalkerConfig, dtype, device) -> Params:
    """Random parameters (normal, scaled by the fan-in; norms at 1, the
    expert bias at 0).  The experts come first and are drawn a layer at a
    time.  On the meta device nothing is drawn."""
    check(cfg)
    H, V, D = cfg.hidden_size, cfg.vocab_size, cfg.head_dim
    E, Ie, I = cfg.num_experts, cfg.moe_intermediate_size, cfg.intermediate_size
    n = counts(cfg)
    q_dim, kv_dim = cfg.num_attention_heads * D, cfg.num_key_value_heads * D
    ones = dict(dtype=dtype, device=device)
    meta = torch.device(device).type == "meta"

    def normal(shape, scale):
        if meta:
            return torch.empty(shape, **ones)
        if len(shape) == 4:  # the experts: a layer at a time
            return torch.stack([randn(gen, shape[1:], scale, dtype, device)
                                for _ in range(shape[0])])
        return randn(gen, shape, scale, dtype, device)

    def w(shape, fan_in):
        return normal(shape, fan_in ** -0.5)

    blocks = {
        "moe": {
            "experts_gateup": w((n["moe"], E, H, 2 * Ie), H),
            "experts_down": w((n["moe"], E, Ie, H), Ie),
            "router": w((n["moe"], H, E), H),
            "expert_bias": torch.zeros((n["moe"], E), **ones),
            "post_norm": torch.ones((n["moe"], H), **ones),
        },
        "dense": {
            "gateup_proj": w((n["dense"], H, 2 * I), H),
            "down_proj": w((n["dense"], I, H), I),
            "post_norm": torch.ones((n["dense"], H), **ones),
        },
        "conv": {
            "in_proj": w((n["conv"], H, 3 * H), H),
            "conv_w": w((n["conv"], cfg.conv_L_cache, H), cfg.conv_L_cache),
            "out_proj": w((n["conv"], H, H), H),
            "input_norm": torch.ones((n["conv"], H), **ones),
        },
        "attn": {
            "qkv_proj": w((n["attn"], H, q_dim + 2 * kv_dim), H),
            "o_proj": w((n["attn"], q_dim, H), q_dim),
            "q_norm": torch.ones((n["attn"], D), **ones),
            "k_norm": torch.ones((n["attn"], D), **ones),
            "input_norm": torch.ones((n["attn"], H), **ones),
        },
    }
    return {
        "blocks": blocks,
        "codec_embedding": normal((V, H), 0.02),
        "text_embedding": normal((cfg.text_vocab_size, cfg.text_hidden_size), 0.02),
        "text_projection": {"w": w((cfg.text_hidden_size, H), cfg.text_hidden_size),
                            "b": torch.zeros((H,), **ones)},
        "final_norm": torch.ones((H,), **ones),
        "codec_head": w((H, V), H),
        "spk_proj": {"w": w((cfg.speaker_embed_dim, H), cfg.speaker_embed_dim),
                     "b": torch.zeros((H,), **ones)},
    }


def new_cache(cfg: TalkerConfig, batch: int, max_len: int, dtype, device) -> Params:
    """{"k", "v"} [La, B, S, KVH, D] of the attention layers, zeros, and
    the convolution state "conv" [Lc, B, H, taps], zeros."""
    n = counts(cfg)
    shape = (n["attn"], batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "conv": torch.zeros((n["conv"], batch, cfg.hidden_size, cfg.conv_L_cache),
                                dtype=dtype, device=device)}


def _views(group: Params) -> List[Params]:
    """Per-layer views of a group of stacked leaves (by ``unbind``; a
    quantized leaf becomes a per-layer dict of views)."""
    def layers(v):
        if isinstance(v, dict):
            return [dict(zip(v, parts)) for parts in zip(*(t.unbind(0) for t in v.values()))]
        return v.unbind(0)

    parts = {k: layers(v) for k, v in group.items()}
    L = len(next(iter(parts.values())))
    return [{k: parts[k][i] for k in group} for i in range(L)]


def layer_views(blocks: Params, cfg: TalkerConfig,
                stats: Optional[RouteStats] = None) -> List[Params]:
    """One dict a layer: its operator's and its FFN's leaves, their kinds
    and indices (``op``, ``op_i``, ``ffn``, ``ffn_i``) and, in a routed
    layer with ``stats``, its counters (``stats``)."""
    views = {k: _views(v) for k, v in blocks.items()}
    out = []
    for op, oi, ffn, fi in layer_plan(cfg):
        layer = {**views[op][oi], **views[ffn][fi], "op": op, "op_i": oi, "ffn": ffn,
                 "ffn_i": fi}
        if ffn == "moe" and stats is not None:
            layer["stats"] = stats.layer(fi)
        out.append(layer)
    return out


def _conv(p: Params, x: torch.Tensor, state: torch.Tensor, pad_count: torch.Tensor,
          eps: float, decode: bool) -> torch.Tensor:
    """x + the gated short convolution of rms(x); ``state`` [B, H, taps]
    (this layer's) is written in place: the last taps values of b * u."""
    B, T, H = x.shape
    taps = p["conv_w"].shape[0]
    bcu = maybe_matmul(rms_norm(x, p["input_norm"], eps), p["in_proj"])
    b, c, u = bcu[..., :H], bcu[..., H: 2 * H], bcu[..., 2 * H:]
    bu = b * u
    w = p["conv_w"]
    if decode:  # T == 1: shift the state by one and convolve it
        new = torch.cat([state[..., 1:], bu[:, 0, :, None]], dim=-1)
        state.copy_(new)
        v = (new * w.t()).sum(-1)[:, None, :]
    else:
        live = torch.arange(T, device=x.device)[None, :] >= pad_count.reshape(B, 1).long()
        bu = bu * live[..., None].to(bu.dtype)  # left pads contribute nothing
        padded = torch.cat([bu.new_zeros((B, taps - 1, H)), bu], dim=1)
        v = sum(w[j] * padded[:, j: j + T] for j in range(taps))
        tail = torch.cat([bu.new_zeros((B, taps, H)), bu], dim=1)[:, -taps:]
        state.copy_(tail.transpose(1, 2))
    return x + maybe_matmul(c * v, p["out_proj"])


def _ffn(p: Params, x: torch.Tensor, cfg: TalkerConfig, decode: bool) -> torch.Tensor:
    B, T, H = x.shape
    h = rms_norm(x, p["post_norm"], cfg.rms_norm_eps)
    if p["ffn"] == "dense":
        return x + swiglu(p, h, cfg.intermediate_size)
    bias = p["expert_bias"] if cfg.use_expert_bias else None
    with TRACE.span("experts") if not decode else contextlib.nullcontext():
        y = routed_experts(x.reshape(B * T, H), h.reshape(B * T, H), p["router"], bias,
                           p["experts_gateup"], p["experts_down"], cfg.num_experts_per_tok,
                           cfg.norm_topk_prob, cfg.routed_scaling_factor,
                           p.get("stats") if decode else None, decode=decode)
    return y.reshape(B, T, H)


def stack_forward(layers: Sequence[Params], cfg: TalkerConfig, x: torch.Tensor, cos, sin,
                  kv: Params, write_pos, mask: Optional[torch.Tensor], pad_count: torch.Tensor,
                  flash_ctx: Optional[Dict] = None, decode: bool = False) -> torch.Tensor:
    """Every layer over x [B, T, H] (the prefill, or one decode step with
    ``decode``), writing the caches in place; before the final norm."""
    spec = attn_spec(cfg)
    for p in layers:
        if p["op"] == "conv":
            x = _conv(p, x, kv["conv"][p["op_i"]], pad_count, cfg.rms_norm_eps, decode)
        else:
            attn = attend(p, x, cos, sin, kv, p["op_i"], write_pos, mask, spec,
                          flash_ctx=flash_ctx)
            B, T, _ = x.shape
            x = x + maybe_matmul(attn.reshape(B, T, spec.q_dim), p["o_proj"])
        x = _ffn(p, x, cfg, decode)
    return x


def prefill(params: Params, cfg: TalkerConfig, embeds: torch.Tensor, pad_count: torch.Tensor,
            kv: Params, cos, sin, layers: Optional[Sequence[Params]] = None) -> torch.Tensor:
    """The prompt [B, T, H] into the caches from slot 0; the final-normed
    hidden [B, T, H]."""
    T = embeds.shape[1]
    layers = layers if layers is not None else layer_views(params["blocks"], cfg)
    x = stack_forward(layers, cfg, embeds, cos, sin, kv, 0, prefill_mask(T, T, pad_count),
                      pad_count)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def decode_step(params: Params, cfg: TalkerConfig, x: torch.Tensor, cos, sin,
                pos: torch.Tensor, pad_count: torch.Tensor, kv: Params, use_flash: bool,
                layers: Optional[Sequence[Params]] = None) -> torch.Tensor:
    """One token a row [B, 1, H] at slot ``pos``; the final-normed hidden."""
    layers = layers if layers is not None else layer_views(params["blocks"], cfg)
    flash_ctx = mask = None
    if use_flash:
        flash_ctx = {"pos": pos, "pad": pad_count, "window": None}
    else:
        mask = decode_mask(kv["k"].shape[2], pos, pad_count)
    x = stack_forward(layers, cfg, x, cos, sin, kv, pos, mask, pad_count, flash_ctx,
                      decode=True)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
