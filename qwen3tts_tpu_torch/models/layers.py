"""Shared Qwen3-style decoder-layer primitives, port of
``qwen3tts_tpu/models/layers.py``.

Both the talker and the code predictor are stacks of identical blocks:
RMSNorm -> GQA attention with per-head q/k norm + RoPE -> RMSNorm -> SwiGLU.
Parameters keep the JAX package's layer-stacked layout (leading ``L`` axis,
fused ``qkv_proj`` and ``gateup_proj``, matmul weights ``[in, out]``) and
the KV cache its ``[L, B, S, KVH, D]`` layout.  The stack runs as a Python
loop over layers that writes the stacked cache in place (the JAX package
threads it through ``lax.scan`` with donation instead).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops.flash_decode import flash_decode
from ..ops.rope import apply_rope

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Static geometry of a decoder-layer stack."""

    num_layers: int
    hidden_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rms_norm_eps: float = 1e-6

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def randn(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """Normal(0, scale) in float32 from ``gen``, cast to ``dtype``."""
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            * scale).to(dtype)


def init_block_stack(gen: torch.Generator, spec: BlockSpec, dtype, device) -> Params:
    """Random layer-stacked block parameters with the JAX package's scales."""
    L, H, I, D = spec.num_layers, spec.hidden_size, spec.intermediate_size, spec.head_dim

    def w(shape, fan_in):
        return randn(gen, shape, fan_in ** -0.5, dtype, device)

    ones = dict(dtype=dtype, device=device)
    return {
        "input_norm": torch.ones((L, H), **ones),
        "qkv_proj": w((L, H, spec.q_dim + 2 * spec.kv_dim), H),
        "o_proj": w((L, spec.q_dim, H), spec.q_dim),
        "q_norm": torch.ones((L, D), **ones),
        "k_norm": torch.ones((L, D), **ones),
        "post_norm": torch.ones((L, H), **ones),
        "gateup_proj": w((L, H, 2 * I), H),
        "down_proj": w((L, I, H), I),
    }


def unstack_layers(stack: Params) -> List[Params]:
    """Per-layer views of a layer-stacked parameter dict (built once, so the
    decode loop does not re-index the stack every step)."""
    L = next(iter(stack.values())).shape[0]
    return [{k: v[i] for k, v in stack.items()} for i in range(L)]


def init_kv_cache(spec: BlockSpec, batch: int, max_len: int, dtype, device) -> Params:
    """Zeroed float KV cache {"k","v"}: [L, B, S, KVH, D]."""
    shape = (spec.num_layers, batch, max_len, spec.num_kv_heads, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in float32, cast to x's dtype, then scale by ``w``."""
    xf = x.float()
    var = xf.pow(2).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def masked_attention(
    q: torch.Tensor,  # [B, Tq, NH, D]
    k: torch.Tensor,  # [B, S, KVH, D]
    v: torch.Tensor,  # [B, S, KVH, D]
    mask: torch.Tensor,  # [B, Tq, S] bool (True = attend)
) -> torch.Tensor:
    """Masked softmax attention: scores in float32, probabilities rounded to
    v's dtype, the value product accumulated in float32."""
    B, Tq, NH, D = q.shape
    KVH = k.shape[2]
    G = NH // KVH
    qg = q.reshape(B, Tq, KVH, G, D).permute(0, 2, 3, 1, 4).float()  # [B,KVH,G,Tq,D]
    kk = k.permute(0, 2, 1, 3).unsqueeze(2).float()  # [B, KVH, 1, S, D]
    vv = v.permute(0, 2, 1, 3).unsqueeze(2)
    scores = torch.matmul(qg, kk.transpose(-1, -2)) * (D ** -0.5)  # [B,KVH,G,Tq,S]
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs.float(), vv.float())  # [B, KVH, G, Tq, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, NH, D).to(v.dtype)


def block_forward(
    p: Params,  # one layer (no leading L axis)
    x: torch.Tensor,  # [B, Tq, H]
    cos: torch.Tensor,  # [B, Tq, D]
    sin: torch.Tensor,
    kv: Params,  # FULL stacked cache {"k","v"}: written in place
    layer_idx: int,
    write_pos: Union[int, torch.Tensor],  # slot of the first new row
    mask: Optional[torch.Tensor],  # [B, Tq, S] or local [B, Tq, Tq] bool
    spec: BlockSpec,
    flash_ctx: Optional[Dict] = None,  # {"pos","pad","window"} -> flash decode
    sliding: bool = False,  # THIS layer slides (selects the window)
) -> Tuple[torch.Tensor, Params]:
    """One decoder block.  Returns (x_out, kv) with kv updated in place.

    Attention paths, as in the JAX package: single-token decode with
    ``flash_ctx`` -> ``ops.flash_decode`` (the CUDA kernel on the card);
    prefill with a local ``[B, T, T]`` mask -> attention over the fresh
    prompt K/V; otherwise masked attention over the cache layer."""
    B, Tq, H = x.shape
    eps = spec.rms_norm_eps
    h = rms_norm(x, p["input_norm"], eps)
    qkv = h @ p["qkv_proj"]
    q = qkv[..., : spec.q_dim].reshape(B, Tq, spec.num_heads, spec.head_dim)
    k = qkv[..., spec.q_dim: spec.q_dim + spec.kv_dim].reshape(
        B, Tq, spec.num_kv_heads, spec.head_dim)
    v = qkv[..., spec.q_dim + spec.kv_dim:].reshape(
        B, Tq, spec.num_kv_heads, spec.head_dim)
    q = rms_norm(q, p["q_norm"], eps)
    k = rms_norm(k, p["k_norm"], eps)
    q, k = apply_rope(q, k, cos, sin)  # rope in f32 for precision...
    q = q.to(x.dtype)
    k = k.to(x.dtype)  # ...but K/V are cached in the model dtype

    rows = torch.arange(Tq, device=x.device) + write_pos  # device add: no sync
    kv["k"][layer_idx].index_copy_(1, rows, k)
    kv["v"][layer_idx].index_copy_(1, rows, v)

    if flash_ctx is not None and Tq == 1:
        window = flash_ctx.get("window") if sliding else None
        attn = flash_decode(q[:, 0].contiguous(), kv["k"], kv["v"], layer_idx,
                            flash_ctx["pos"], flash_ctx["pad"], window)[:, None]
    elif Tq > 1 and mask.shape[-1] == Tq:
        attn = masked_attention(q, k, v, mask)
    else:
        attn = masked_attention(q, kv["k"][layer_idx], kv["v"][layer_idx], mask)

    x = x + attn.reshape(B, Tq, spec.q_dim) @ p["o_proj"]
    h = rms_norm(x, p["post_norm"], eps)
    gu = h @ p["gateup_proj"]
    I = spec.intermediate_size
    x = x + (F.silu(gu[..., :I]) * gu[..., I:]) @ p["down_proj"]
    return x, kv


def stack_forward(
    layers: Union[Params, Sequence[Params]],  # stacked dict or unstack_layers()
    x: torch.Tensor,  # [B, Tq, H]
    cos: torch.Tensor,
    sin: torch.Tensor,
    kv: Params,
    write_pos: Union[int, torch.Tensor],
    mask_full: Optional[torch.Tensor],
    spec: BlockSpec,
    mask_sliding: Optional[torch.Tensor] = None,
    layer_is_sliding: Optional[Sequence[bool]] = None,
    flash_ctx: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Params]:
    """Run the whole layer stack.  Returns (x_out, kv) — kv written in place."""
    if isinstance(layers, dict):
        layers = unstack_layers(layers)
    if layer_is_sliding is None:
        layer_is_sliding = [False] * len(layers)
    if mask_sliding is None:  # also the flash path, which takes no mask
        mask_sliding = mask_full
    for li, lp in enumerate(layers):
        sl = bool(layer_is_sliding[li])
        x, kv = block_forward(lp, x, cos, sin, kv, li, write_pos,
                              mask_sliding if sl else mask_full, spec,
                              flash_ctx=flash_ctx, sliding=sl)
    return x, kv


def decode_mask(
    max_len: int,
    pos: Union[int, torch.Tensor],  # current absolute cache position
    pad_count: torch.Tensor,  # [B] int32
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """[B, 1, max_len] bool mask for a single-token decode step."""
    idx = torch.arange(max_len, device=pad_count.device)[None, None, :]
    p = pos.reshape(1, 1, 1) if isinstance(pos, torch.Tensor) else pos
    m = (idx <= p) & (idx >= pad_count.reshape(-1, 1, 1))
    if sliding_window is not None:
        m = m & (idx > p - sliding_window)
    return m


def prefill_mask(
    seq_len: int,
    max_len: int,
    pad_count: torch.Tensor,  # [B]
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """[B, seq_len, max_len] causal + left-pad mask.  Key slots >= seq_len
    are masked out."""
    dev = pad_count.device
    qi = torch.arange(seq_len, device=dev)[None, :, None]
    ki = torch.arange(max_len, device=dev)[None, None, :]
    m = (ki <= qi) & (ki >= pad_count.reshape(-1, 1, 1)) & (ki < seq_len)
    if sliding_window is not None:
        m = m & (ki > qi - sliding_window)
    return m
