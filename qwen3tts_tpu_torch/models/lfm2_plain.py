"""Plain float32 reference of the hybrid (LFM2) talker's decoder stack,
written from LFM2's layer equations: no kernel, no cache, no batching,
no padding.

    h   = x + Op(rms(x, input_norm))
    out = h + FFN(rms(h, post_norm))

``Op`` of a ``conv`` layer: ``[b, c, u] = split3(z @ in_proj)``, ``v_t =
sum_{j=0..2} w_j * (b * u)_{t-2+j}`` (zero before the first position), ``(c
* v) @ out_proj``; of a ``full_attention`` layer: causal GQA with per-head
q/k RMSNorm and rotate-half RoPE over one position axis, then ``o_proj``.
``FFN``: SwiGLU in the first ``num_dense_layers`` layers; else the routed
experts: ``s = sigmoid(h @ router)``, ``idx = top_k(s + expert_bias)``, ``g
= s[idx] / (sum s[idx] + 1e-6) * routed_scaling_factor``, ``sum_k g_k
down_k(silu(gate_k h) * up_k h)``.

It imports torch alone.  ``blocks`` is the talker's ``blocks`` in the
program's layout (``models/lfm2.py``), ``cfg`` the talker configuration (a
``TalkerConfig`` or its dict).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * _f(w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [N, T, heads, D] rotated by positions ``pos`` [T] (rotate-half)."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half))
    ang = pos.double()[:, None] * inv[None]
    emb = torch.cat([ang, ang], dim=-1)
    cos, sin = emb.cos().float()[:, None, :], emb.sin().float()[:, None, :]
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def attention(q, k, v) -> torch.Tensor:
    """Causal GQA: q [N, T, NH, D], k / v [N, T, KVH, D] -> [N, T, NH * D]."""
    N, T, NH, D = q.shape
    G = NH // k.shape[2]
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    s = torch.einsum("nthd,nshd->nhts", q, k) / math.sqrt(D)
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("nhts,nshd->nthd", torch.softmax(s, -1), v).reshape(N, T, NH * D)


def short_conv(z: torch.Tensor, in_proj, taps, out_proj) -> torch.Tensor:
    """The gated short convolution of z [N, T, H]; ``taps`` [L, H]."""
    H = z.shape[-1]
    bcu = z @ _f(in_proj)
    bu = bcu[..., :H] * bcu[..., 2 * H:]
    L, T = taps.shape[0], z.shape[1]
    padded = F.pad(bu, (0, 0, L - 1, 0))
    v = sum(_f(taps[j]) * padded[:, j: j + T] for j in range(L))
    return (bcu[..., H: 2 * H] * v) @ _f(out_proj)


def routed(h: torch.Tensor, router, bias, w13, w2, top_k: int, norm: bool,
           scale: float) -> torch.Tensor:
    """The routed experts' sum over h [M, H], an expert at a time."""
    s = torch.sigmoid(h @ _f(router))
    choice = s + _f(bias) if bias is not None else s
    idx = torch.topk(choice, top_k, dim=-1).indices
    g = s.gather(-1, idx)
    if norm:
        g = g / (g.sum(-1, keepdim=True) + 1e-6)
    g = g * scale
    out = torch.zeros_like(h)
    I = w2.shape[1]
    for e in range(w13.shape[0]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        gu = h[rows] @ _f(w13[e])
        y = (F.silu(gu[:, :I]) * gu[:, I:]) @ _f(w2[e])
        out.index_add_(0, rows, y * g[rows, slot, None])
    return out


def _cfg(cfg) -> dict:
    return cfg if isinstance(cfg, dict) else vars(cfg)


def talker_stack(blocks, cfg, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Every layer over x [N, T, H] at positions ``pos`` [T], in float32;
    before the final norm."""
    c = _cfg(cfg)
    NH, KVH, D = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    eps, I = c["rms_norm_eps"], c["intermediate_size"]
    N, T, H = x.shape
    x = x.float()
    n = {"conv": 0, "attn": 0, "dense": 0, "moe": 0}
    for i, kind in enumerate(c["layer_types"]):
        op = "conv" if kind == "conv" else "attn"
        p, j = blocks[op], n[op]
        n[op] += 1
        z = rms(x, p["input_norm"][j], eps)
        if op == "conv":
            x = x + short_conv(z, p["in_proj"][j], p["conv_w"][j], p["out_proj"][j])
        else:
            qkv = z @ _f(p["qkv_proj"][j])
            q = qkv[..., : NH * D].reshape(N, T, NH, D)
            k = qkv[..., NH * D: (NH + KVH) * D].reshape(N, T, KVH, D)
            v = qkv[..., (NH + KVH) * D:].reshape(N, T, KVH, D)
            q = rope(rms(q, p["q_norm"][j], eps), pos, c["rope_theta"])
            k = rope(rms(k, p["k_norm"][j], eps), pos, c["rope_theta"])
            x = x + attention(q, k, v) @ _f(p["o_proj"][j])
        ffn = "dense" if i < c["num_dense_layers"] else "moe"
        p, j = blocks[ffn], n[ffn]
        n[ffn] += 1
        h = rms(x, p["post_norm"][j], eps)
        if ffn == "dense":
            gu = h @ _f(p["gateup_proj"][j])
            x = x + (F.silu(gu[..., :I]) * gu[..., I:]) @ _f(p["down_proj"][j])
        else:
            bias = p["expert_bias"][j] if c["use_expert_bias"] else None
            y = routed(h.reshape(N * T, H), p["router"][j], bias, p["experts_gateup"][j],
                       p["experts_down"][j], c["num_experts_per_tok"], c["norm_topk_prob"],
                       c["routed_scaling_factor"])
            x = x + y.reshape(N, T, H)
    return x


def logits(params, cfg, embeds: torch.Tensor) -> torch.Tensor:
    """The codec head's logits [N, T, V] over prompt embeddings [N, T, H]."""
    c = _cfg(cfg)
    pos = torch.arange(embeds.shape[1], device=embeds.device)
    x = rms(talker_stack(params["blocks"], c, embeds, pos), params["final_norm"],
            c["rms_norm_eps"])
    return x @ _f(params["codec_head"])
