"""Shared Qwen3-style decoder-layer primitives, port of
``qwen3tts_tpu/models/layers.py``.

Both the talker and the code predictor are stacks of identical blocks:
RMSNorm -> GQA attention with per-head q/k norm + RoPE -> RMSNorm -> SwiGLU.
Parameters keep the JAX package's layer-stacked layout (leading ``L`` axis,
fused ``qkv_proj`` and ``gateup_proj``, matmul weights ``[in, out]``, or
the quantized dicts of ``ops/quant.py``: int8 weight-only ``{"q", "scale"}``,
w8a8 ``{"q8", "scale"}``) and the KV
cache its ``[L, B, S, KVH, D]`` layout; an int8 cache adds f32 scales
``"ks"``/``"vs"`` ``[L, B, KVH, S]``.  The stack runs as a Python loop over
layers that writes the stacked cache in place (the JAX package threads it
through ``lax.scan`` with donation instead).

Under tensor parallelism (``parallel/sharding.py``) each rank holds the
columns of ``qkv_proj`` for its q, k and v heads, the gate and up columns
of ``gateup_proj`` for its share of the intermediate width, the matching
input rows of ``o_proj`` and ``down_proj``, and its kv heads of the cache:
the stack runs at ``BlockSpec.shard(tp)``, and with a ``group`` the two
row-parallel products are summed over it
(``parallel/collectives.py:all_reduce``) before their residual adds.  With
grad enabled (training, ``parallel/sharding.py:make_train_step``) the sums
are ``reduce_from_tp`` and the inputs of the column-parallel products pass
``copy_to_tp``, so that autograd sums their gradients over the group.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops.flash_decode import flash_decode
from ..ops.fused_block import fused_norm_matmul, fused_o_mlp
from ..ops.quant import maybe_matmul
from ..ops.rope import apply_rope
from ..parallel.collectives import all_reduce, carries_grads, copy_to_tp, reduce_from_tp

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

    def shard(self, tp: int) -> "BlockSpec":
        """One rank's share of the stack under ``tp``-way tensor
        parallelism: heads, kv heads and the MLP's intermediate width
        divided by ``tp``."""
        if tp == 1:
            return self
        for name in ("num_heads", "num_kv_heads", "intermediate_size"):
            if getattr(self, name) % tp:
                raise ValueError(f"{name} {getattr(self, name)} does not split {tp} ways")
        return dataclasses.replace(self, num_heads=self.num_heads // tp,
                                   num_kv_heads=self.num_kv_heads // tp,
                                   intermediate_size=self.intermediate_size // tp)


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
    decode loop does not re-index the stack every step).  A quantized leaf
    (``{"q", "scale"}`` or ``{"q8", "scale"}``) becomes a per-layer dict of
    views.  The views come from ``unbind``, whose backward stacks the
    layers' gradients once (an index per layer would give each a zeroed
    copy of the whole stack, and their sum L - 1 full-stack adds)."""
    def layers(v):
        if isinstance(v, dict):
            return [dict(zip(v, parts)) for parts in zip(*(t.unbind(0) for t in v.values()))]
        return v.unbind(0)

    per_leaf = {k: layers(v) for k, v in stack.items()}
    L = stack["input_norm"].shape[0]
    return [{k: per_leaf[k][i] for k in stack} for i in range(L)]


def init_kv_cache(spec: BlockSpec, batch: int, max_len: int, dtype, device,
                  kv_quant: bool = False) -> Params:
    """Zeroed static KV cache {"k","v"}: [L, B, S, KVH, D] in ``dtype``; with
    ``kv_quant`` int8 rows plus f32 per-(slot, head) scales {"ks","vs"}:
    [L, B, KVH, S]."""
    shape = (spec.num_layers, batch, max_len, spec.num_kv_heads, spec.head_dim)
    if not kv_quant:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    sshape = (spec.num_layers, batch, spec.num_kv_heads, max_len)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(sshape, dtype=torch.float32, device=device),
            "vs": torch.zeros(sshape, dtype=torch.float32, device=device)}


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T, KVH, D] float -> (int8 rows, f32 per-(b, t, head) scales)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


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
    fused: bool = False,  # the fused weight-streaming kernels (ops/fused_block.py)
    group=None,  # the tp process group: p, kv and spec are this rank's shard
) -> Tuple[torch.Tensor, Params]:
    """One decoder block.  Returns (x_out, kv) with kv updated in place.

    Attention paths, as in the JAX package: single-token decode with
    ``flash_ctx`` -> ``ops.flash_decode`` (the CUDA kernel on the card);
    prefill with a local ``[B, T, T]`` mask -> attention over the fresh
    prompt K/V (exact, even with an int8 cache); otherwise masked attention
    over the cache layer, dequantized to x's dtype for an int8 cache.

    ``fused`` takes the qkv half and the o + MLP half through
    ``fused_norm_matmul`` and ``fused_o_mlp`` for decode-shaped activations
    (B * Tq <= 32) with plain or int8 weight-only weights, as the JAX
    package gates them (``layers.py:182-185``); a w8a8 ``q8`` weight stays
    on ``maybe_matmul``.  With a ``group`` the o- and down-projections'
    partial sums are all-reduced before their residual adds, which
    ``fused_o_mlp`` makes inside the kernel: ``fused`` raises there."""
    if fused and group is not None:
        raise ValueError("fused=True adds the residual inside fused_o_mlp, before the "
                         "row-parallel all-reduce: no fused kernels with a tp group")
    B, Tq, H = x.shape
    eps = spec.rms_norm_eps
    w_qkv = p["qkv_proj"]
    fused = fused and B * Tq <= 32 and (not isinstance(w_qkv, dict) or "q" in w_qkv)
    if carries_grads(group):
        copy, reduce = (lambda t: copy_to_tp(t, group)), (lambda t: reduce_from_tp(t, group))
    else:
        copy = lambda t: t  # noqa: E731
        reduce = (lambda t: t) if group is None else (lambda t: all_reduce(t, group))
    attn = attend(p, x, cos, sin, kv, layer_idx, write_pos, mask, spec, flash_ctx=flash_ctx,
                  sliding=sliding, fused=fused, copy=copy)
    if fused:
        return fused_o_mlp(x.reshape(B * Tq, H), attn.reshape(B * Tq, spec.q_dim),
                           p["o_proj"], p["post_norm"], p["gateup_proj"], p["down_proj"],
                           eps=eps).reshape(B, Tq, H), kv
    o = maybe_matmul(attn.reshape(B, Tq, spec.q_dim), p["o_proj"])
    x = x + reduce(o)
    h = copy(rms_norm(x, p["post_norm"], eps))
    x = x + reduce(swiglu(p, h, spec.intermediate_size))
    return x, kv


def swiglu(p: Params, h: torch.Tensor, intermediate: int) -> torch.Tensor:
    """The block's MLP on normalised ``h``: down(silu(gate) * up)."""
    gu = maybe_matmul(h, p["gateup_proj"])
    return maybe_matmul(F.silu(gu[..., :intermediate]) * gu[..., intermediate:],
                        p["down_proj"])


def attend(
    p: Params,
    x: torch.Tensor,  # [B, Tq, H], before the input norm
    cos: torch.Tensor,
    sin: torch.Tensor,
    kv: Params,
    layer_idx: int,
    write_pos: Union[int, torch.Tensor],
    mask: Optional[torch.Tensor],
    spec: BlockSpec,
    flash_ctx: Optional[Dict] = None,
    sliding: bool = False,
    fused: bool = False,
    copy=lambda t: t,
) -> torch.Tensor:
    """The attention half of a block up to the o-projection: the input
    norm and qkv (``fused``: through ``fused_norm_matmul``), per-head q/k
    norms and RoPE, the new rows written into cache layer ``layer_idx``, and
    the attention output [B, Tq, q_dim] (``block_forward``'s paths)."""
    B, Tq, H = x.shape
    eps = spec.rms_norm_eps
    kv_quant = "ks" in kv
    w_qkv = p["qkv_proj"]
    if fused:
        qkv = fused_norm_matmul(x.reshape(B * Tq, H), p["input_norm"], w_qkv,
                                eps=eps).reshape(B, Tq, -1)
    else:
        qkv = maybe_matmul(copy(rms_norm(x, p["input_norm"], eps)), w_qkv)
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
    if kv_quant:
        k_row, ks = _quantize_rows(k)
        v_row, vs = _quantize_rows(v)
        # scales [B, Tq, KVH] -> cache layout [L, B, KVH, S]
        kv["ks"][layer_idx].index_copy_(2, rows, ks.transpose(1, 2))
        kv["vs"][layer_idx].index_copy_(2, rows, vs.transpose(1, 2))
    else:
        k_row, v_row = k, v
    kv["k"][layer_idx].index_copy_(1, rows, k_row)
    kv["v"][layer_idx].index_copy_(1, rows, v_row)

    if flash_ctx is not None and Tq == 1:
        window = flash_ctx.get("window") if sliding else None
        return flash_decode(q[:, 0].contiguous(), kv["k"], kv["v"], layer_idx,
                            flash_ctx["pos"], flash_ctx["pad"], window,
                            kv.get("ks"), kv.get("vs"))[:, None]
    if Tq > 1 and mask.shape[-1] == Tq:
        return masked_attention(q, k, v, mask)
    k_l, v_l = kv["k"][layer_idx], kv["v"][layer_idx]
    if kv_quant:
        # scales [B, KVH, S] -> [B, S, KVH, 1] against k_l [B, S, KVH, D]
        k_l = (k_l.float() * kv["ks"][layer_idx].transpose(1, 2)[..., None]).to(x.dtype)
        v_l = (v_l.float() * kv["vs"][layer_idx].transpose(1, 2)[..., None]).to(x.dtype)
    return masked_attention(q, k_l, v_l, mask)


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
    fused: bool = False,
    group=None,
) -> Tuple[torch.Tensor, Params]:
    """Run the whole layer stack.  Returns (x_out, kv) — kv written in place.
    With a tp ``group``, ``layers``, ``kv`` and ``spec`` are this rank's
    shard (``block_forward``)."""
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
                              flash_ctx=flash_ctx, sliding=sl, fused=fused, group=group)
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
