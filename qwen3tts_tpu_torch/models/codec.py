"""The 12 Hz neural codec: decoder (codes -> waveform, full and streaming)
and encoder (waveform -> codes).

Port of ``qwen3tts_tpu/models/codec.py``: ``decode``, ``stream_init``,
``decode_stream`` and ``encode``.  Decoder: summed RVQ code embeddings ->
sliding-window causal pre-transformer -> transposed-conv + ConvNeXt
upsampling -> SnakeBeta conv stack.  Encoder (the ICL voice clone's
reference codes): a causal input conv, strided SnakeBeta + causal-conv
stages at the decoder's rates reversed, a projection, the same
sliding-window transformer, then residual vector quantization in float32.

Layout: the transformer runs ``[B, T, H]``; the conv stack runs
channels-first ``[B, C, T]`` for ``F.conv1d``.  Conv weights are stored
``[Cout, Cin, K]``; transposed-conv weights ``[Cin, Cout, K]`` already
flipped along K, because ``jax.lax.conv_transpose`` (transpose_kernel=False)
equals ``F.conv_transpose1d`` only with the kernel reversed.

Streaming carries, across chunks, each transformer layer's last
``sliding_window - 1`` post-RoPE K/V rows, each causal conv's trailing
inputs, and each transposed conv's overlap-add tail (float32), so chained
``decode_stream`` calls equal one ``decode`` of the concatenated codes.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..core.config import CodecConfig
from ..ops.rope import apply_rope, mrope_cos_sin
from .layers import masked_attention, randn, rms_norm

Params = Dict

_DILATIONS = (1, 3, 9)


# ---------------------------------------------------------------------------
# primitives (channels-first [B, C, T] unless noted)
# ---------------------------------------------------------------------------


def causal_conv(x, w, b, *, dilation: int = 1, stride: int = 1):
    """1-D causal conv, w [Cout, Cin, K]: left-pads (K-1)*dilation zeros."""
    pad = (w.shape[-1] - 1) * dilation
    return F.conv1d(F.pad(x, (pad, 0)), w, b, stride=stride, dilation=dilation)


def causal_trans_conv(x, w, b, *, stride: int):
    """1-D causal transposed conv, w [Cin, Cout, K] (flipped): output length
    T*stride (the VALID output's tail is trimmed)."""
    T = x.shape[-1]
    out = F.conv_transpose1d(x, w, stride=stride)
    return out[..., : T * stride] + b[:, None]


def snake_beta(x, alpha, beta):
    """SnakeBeta: x + 1/(e^beta) * sin^2(x * e^alpha), per channel, in f32."""
    a = torch.exp(alpha.float())[:, None]
    bsc = torch.exp(beta.float())[:, None]
    xf = x.float()
    s = torch.sin(xf * a)
    return (xf + (1.0 / (bsc + 1e-9)) * s * s).to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-6):
    """LayerNorm over the last axis, statistics in f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).pow(2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _lin(p, x):
    return x @ p["w"] + p["b"]


# ---------------------------------------------------------------------------
# init (port layout)
# ---------------------------------------------------------------------------


def _conv_init(gen, K, cin, cout, dtype, device):
    return {"w": randn(gen, (cout, cin, K), (K * cin) ** -0.5, dtype, device),
            "b": torch.zeros((cout,), dtype=dtype, device=device)}


def _tconv_init(gen, K, cin, cout, dtype, device):
    return {"w": randn(gen, (cin, cout, K), (K * cin) ** -0.5, dtype, device),
            "b": torch.zeros((cout,), dtype=dtype, device=device)}


def _lin_init(gen, cin, cout, dtype, device):
    return {"w": randn(gen, (cin, cout), cin ** -0.5, dtype, device),
            "b": torch.zeros((cout,), dtype=dtype, device=device)}


def _down_rates(cfg: CodecConfig) -> List[int]:
    """The encoder's strides: the decoder's upsampling, reversed."""
    return list(cfg.upsampling_ratios)[::-1] + list(cfg.upsample_rates)[::-1]


def init_params(gen: torch.Generator, cfg: CodecConfig, dtype, device) -> Params:
    """Random decoder and encoder parameters with the JAX initialisers'
    shapes and scales: ``{"decoder": ..., "encoder": ...}``."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    NH, KVH, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)

    def full(n, val):
        return torch.full((n,), val, **kw)

    def xf_layer():
        return {
            "ln1": full(H, 1.0),
            "q": _lin_init(gen, H, NH * D, dtype, device),
            "k": _lin_init(gen, H, KVH * D, dtype, device),
            "v": _lin_init(gen, H, KVH * D, dtype, device),
            "o": _lin_init(gen, NH * D, H, dtype, device),
            "scale1": full(H, cfg.layer_scale_initial_scale),
            "ln2": full(H, 1.0),
            "up": _lin_init(gen, H, I, dtype, device),
            "gate": _lin_init(gen, H, I, dtype, device),
            "down": _lin_init(gen, I, H, dtype, device),
            "scale2": full(H, cfg.layer_scale_initial_scale),
        }

    def convnext(dim):
        return {
            "dw": _conv_init(gen, 7, 1, dim, dtype, device),  # [dim, 1, 7] depthwise
            "norm_w": full(dim, 1.0), "norm_b": full(dim, 0.0),
            "pw1": _lin_init(gen, dim, 4 * dim, dtype, device),
            "pw2": _lin_init(gen, 4 * dim, dim, dtype, device),
            "scale": full(dim, 0.01),
        }

    def resunit(dim):
        return {
            "alpha1": full(dim, 0.0), "beta1": full(dim, 0.0),
            "conv1": _conv_init(gen, 7, dim, dim, dtype, device),
            "alpha2": full(dim, 0.0), "beta2": full(dim, 0.0),
            "conv2": _conv_init(gen, 1, dim, dim, dtype, device),
        }

    dec: Dict = {
        "code_embedding": randn(gen, (cfg.codebook_size * cfg.num_quantizers, H),
                                0.02, dtype, device),
        "pre_transformer": [xf_layer() for _ in range(cfg.num_hidden_layers)],
        "upsample": [{"tconv": _tconv_init(gen, r, H, H, dtype, device),
                      "convnext": convnext(H)} for r in cfg.upsampling_ratios],
        "dec_in": _conv_init(gen, 7, H, cfg.decoder_dim, dtype, device),
        "blocks": [],
    }
    dim = cfg.decoder_dim
    for rate in cfg.upsample_rates:
        out_dim = dim // 2
        dec["blocks"].append({
            "alpha": full(dim, 0.0), "beta": full(dim, 0.0),
            "tconv": _tconv_init(gen, 2 * rate, dim, out_dim, dtype, device),
            "units": [resunit(out_dim) for _ in _DILATIONS],
        })
        dim = out_dim
    dec["out_alpha"] = full(dim, 0.0)
    dec["out_beta"] = full(dim, 0.0)
    dec["dec_out"] = _conv_init(gen, 7, dim, 1, dtype, device)

    enc: Dict = {"in_conv": _conv_init(gen, 7, 1, 32, dtype, device), "stages": []}
    ch = 32
    for r in _down_rates(cfg):
        out_ch = min(ch * 2, H)
        enc["stages"].append({"alpha": full(ch, 0.0), "beta": full(ch, 0.0),
                              "conv": _conv_init(gen, 2 * r, ch, out_ch, dtype, device)})
        ch = out_ch
    enc["proj"] = _lin_init(gen, ch, H, dtype, device)
    enc["transformer"] = [xf_layer() for _ in range(cfg.num_hidden_layers)]
    enc["codebooks"] = randn(gen, (cfg.num_quantizers, cfg.codebook_size, H), 0.05,
                             dtype, device)
    return {"decoder": dec, "encoder": enc}


# ---------------------------------------------------------------------------
# pre-transformer (sliding-window causal attention + LayerScale), [B, T, H]
# ---------------------------------------------------------------------------


def _xf_qkv(p, x, cfg: CodecConfig, cos, sin):
    B, T, _ = x.shape
    D, NH, KVH = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
    q = _lin(p["q"], h).reshape(B, T, NH, D)
    k = _lin(p["k"], h).reshape(B, T, KVH, D)
    v = _lin(p["v"], h).reshape(B, T, KVH, D)
    q, k = apply_rope(q, k, cos, sin)
    return q.to(x.dtype), k.to(x.dtype), v


def _xf_out(p, x, attn, cfg: CodecConfig):
    """attn [B, T, NH, D] -> output projection, LayerScale, SwiGLU MLP."""
    x = x + _lin(p["o"], attn.reshape(*x.shape[:2], -1).to(x.dtype)) * p["scale1"]
    h = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
    h = F.silu(_lin(p["gate"], h)) * _lin(p["up"], h)
    return x + _lin(p["down"], h) * p["scale2"]


def _pre_transformer(layers, x, cfg: CodecConfig):
    B, T, _ = x.shape
    dev = x.device
    qi = torch.arange(T, device=dev)[None, :, None]
    ki = torch.arange(T, device=dev)[None, None, :]
    mask = ((ki <= qi) & (ki > qi - cfg.sliding_window)).expand(B, T, T)
    cos, sin = mrope_cos_sin(torch.arange(T, device=dev).expand(B, T),
                             cfg.head_dim, cfg.rope_theta, None)
    for p in layers:
        q, k, v = _xf_qkv(p, x, cfg, cos, sin)
        x = _xf_out(p, x, masked_attention(q, k, v, mask), cfg)
    return x


def _embed_codes(dec, cfg: CodecConfig, codes):
    offsets = torch.arange(cfg.num_quantizers, device=codes.device) * cfg.codebook_size
    return dec["code_embedding"][codes.long() + offsets].mean(dim=2)  # [B, T, H]


def _convnext(p, x, xin):
    """ConvNeXt block; ``xin`` is x with its causal left context prepended."""
    h = F.conv1d(xin, p["dw"]["w"], p["dw"]["b"], groups=x.shape[1])
    h = layer_norm(h.transpose(1, 2), p["norm_w"], p["norm_b"])
    h = _lin(p["pw2"], F.gelu(_lin(p["pw1"], h), approximate="tanh"))
    return x + (h * p["scale"]).transpose(1, 2)


def _resunit(p, x, dilation):
    h = snake_beta(x, p["alpha1"], p["beta1"])
    h = causal_conv(h, p["conv1"]["w"], p["conv1"]["b"], dilation=dilation)
    h = snake_beta(h, p["alpha2"], p["beta2"])
    return x + causal_conv(h, p["conv2"]["w"], p["conv2"]["b"])


# ---------------------------------------------------------------------------
# decode: codes -> waveform
# ---------------------------------------------------------------------------


def decode(params: Params, cfg: CodecConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, T, num_quantizers] -> waveform [B, T*total_upsample] float32
    in [-1, 1]."""
    dec = params["decoder"]
    h = _pre_transformer(dec["pre_transformer"], _embed_codes(dec, cfg, codes), cfg)
    h = h.transpose(1, 2)  # [B, H, T]
    for st, ratio in zip(dec["upsample"], cfg.upsampling_ratios):
        h = causal_trans_conv(h, st["tconv"]["w"], st["tconv"]["b"], stride=ratio)
        K = st["convnext"]["dw"]["w"].shape[-1]
        h = _convnext(st["convnext"], h, F.pad(h, (K - 1, 0)))
    w = causal_conv(h, dec["dec_in"]["w"], dec["dec_in"]["b"])
    for blk, rate in zip(dec["blocks"], cfg.upsample_rates):
        w = snake_beta(w, blk["alpha"], blk["beta"])
        w = causal_trans_conv(w, blk["tconv"]["w"], blk["tconv"]["b"], stride=rate)
        for unit, dilation in zip(blk["units"], _DILATIONS):
            w = _resunit(unit, w, dilation)
    w = snake_beta(w, dec["out_alpha"], dec["out_beta"])
    w = causal_conv(w, dec["dec_out"]["w"], dec["dec_out"]["b"])
    return torch.clamp(w[:, 0].float(), -1.0, 1.0)


# ---------------------------------------------------------------------------
# encode: waveform -> codes (RVQ)
# ---------------------------------------------------------------------------


def encode_hidden(params: Params, cfg: CodecConfig, wav: torch.Tensor) -> torch.Tensor:
    """waveform [B, N] -> the encoder's pre-RVQ hidden [B, T, H] in the
    weights' dtype, T = N // total_upsample (the trailing partial frame is
    dropped).  The stride-``r`` convs have kernels ``2r`` wide, left-padded
    ``2r - 1``, so each stage divides the length exactly."""
    enc = params["encoder"]
    T = wav.shape[1] // cfg.total_upsample
    h = wav[:, None, : T * cfg.total_upsample].to(enc["in_conv"]["w"].dtype)
    h = causal_conv(h, enc["in_conv"]["w"], enc["in_conv"]["b"])
    for st, rate in zip(enc["stages"], _down_rates(cfg)):
        h = snake_beta(h, st["alpha"], st["beta"])
        h = causal_conv(h, st["conv"]["w"], st["conv"]["b"], stride=rate)
    h = _lin(enc["proj"], h.transpose(1, 2))
    return _pre_transformer(enc["transformer"], h, cfg)


def rvq(hidden: torch.Tensor, codebooks: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual vector quantization in float32, one codebook [CB, H] after
    another: distance ``|r|^2 - 2 r.c + |c|^2``, argmin, subtract the chosen
    code.  Returns (codes [B, T, Q] int32, margins [B, T, Q]): each choice's
    gap from the best to the second-best distance over ``|r|^2 + |c_best|^2``,
    the size of the terms the distance cancels (where summation order can
    flip a choice, the margin is small)."""
    residual = hidden.float()
    codes, margins = [], []
    for cb in codebooks.float():
        cb_sq = (cb * cb).sum(-1)
        r_sq = (residual * residual).sum(-1, keepdim=True)
        d = r_sq - 2.0 * (residual @ cb.t()) + cb_sq
        idx = d.argmin(-1)
        best = d.gather(-1, idx[..., None])
        second = d.scatter(-1, idx[..., None], float("inf")).min(-1, keepdim=True).values
        margins.append(((second - best) / (r_sq + cb_sq[idx][..., None]))[..., 0])
        codes.append(idx)
        residual = residual - cb[idx]
    return torch.stack(codes, -1).to(torch.int32), torch.stack(margins, -1)


def encode(params: Params, cfg: CodecConfig, wav: torch.Tensor) -> torch.Tensor:
    """waveform [B, N] at ``cfg.sample_rate`` -> codes [B, T, num_quantizers]
    int32, T = N // total_upsample."""
    return rvq(encode_hidden(params, cfg, wav), params["encoder"]["codebooks"])[0]


# ---------------------------------------------------------------------------
# stateful streaming decode
# ---------------------------------------------------------------------------


def _stream_conv(x, carry, w, b, *, dilation: int = 1):
    """Causal conv with carried left context, carry [B, Cin, (K-1)*d]."""
    xin = torch.cat([carry.to(x.dtype), x], dim=-1)
    out = F.conv1d(xin, w, b, dilation=dilation)
    pad = carry.shape[-1]
    return out, (xin[..., xin.shape[-1] - pad:] if pad else carry)


def _stream_tconv(x, tail, w, b, *, stride: int):
    """Causal transposed conv with a carried float32 overlap-add tail
    [B, Cout, K - stride] of pre-bias contributions."""
    T = x.shape[-1]
    full = F.conv_transpose1d(x, w, stride=stride)  # [B, Cout, (T-1)*s + K]
    out = full[..., : T * stride].float()
    ts = tail.shape[-1]
    if ts:
        out[..., :ts] += tail
        tail = full[..., T * stride:].float()
    return out.to(x.dtype) + b[:, None], tail


def _stream_xf(layers, x, kwins, vwins, frame0, cfg: CodecConfig):
    """Pre-transformer over n new frames with per-layer rolling K/V windows
    of the last W-1 frames (post-RoPE at absolute positions)."""
    B, n, _ = x.shape
    W = cfg.sliding_window
    dev = x.device
    f0 = frame0.reshape(-1, 1).long()  # [B, 1]
    qi = f0 + torch.arange(n, device=dev)[None]  # [B, n] absolute
    cos, sin = mrope_cos_sin(qi.expand(B, n), cfg.head_dim, cfg.rope_theta, None)
    ki = torch.cat([f0 - (W - 1) + torch.arange(W - 1, device=dev)[None], qi], dim=1)
    mask = ((ki[:, None, :] <= qi[:, :, None]) & (ki[:, None, :] > qi[:, :, None] - W)
            & (ki[:, None, :] >= 0)).expand(B, n, W - 1 + n)
    new_k, new_v = [], []
    for li, p in enumerate(layers):
        q, k, v = _xf_qkv(p, x, cfg, cos, sin)
        k_all = torch.cat([kwins[li].to(x.dtype), k], dim=1)
        v_all = torch.cat([vwins[li].to(x.dtype), v], dim=1)
        x = _xf_out(p, x, masked_attention(q, k_all, v_all, mask), cfg)
        new_k.append(k_all[:, k_all.shape[1] - (W - 1):])
        new_v.append(v_all[:, v_all.shape[1] - (W - 1):])
    return x, new_k, new_v


def stream_init(params: Params, cfg: CodecConfig, batch: int = 1) -> Dict:
    """Zero streaming state for decode_stream.  Carry lengths derive from the
    actual weight shapes."""
    dec = params["decoder"]
    dt = dec["dec_in"]["w"].dtype
    dev = dec["dec_in"]["w"].device
    H, W = cfg.hidden_size, cfg.sliding_window
    KVH, D = cfg.num_key_value_heads, cfg.head_dim

    def z(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    L = len(dec["pre_transformer"])
    st: Dict = {
        "frame0": z(batch, dtype=torch.int32),
        "xf_k": [z(batch, W - 1, KVH, D) for _ in range(L)],
        "xf_v": [z(batch, W - 1, KVH, D) for _ in range(L)],
        "up": [],
        "dec_in": z(batch, H, dec["dec_in"]["w"].shape[-1] - 1),
        "blocks": [],
    }
    for stg, r in zip(dec["upsample"], cfg.upsampling_ratios):
        K = stg["tconv"]["w"].shape[-1]
        st["up"].append({
            "tail": z(batch, H, K - r, dtype=torch.float32),
            "cnx": z(batch, H, stg["convnext"]["dw"]["w"].shape[-1] - 1),
        })
    dim = cfg.decoder_dim
    for blk, rate in zip(dec["blocks"], cfg.upsample_rates):
        out_dim = dim // 2
        st["blocks"].append({
            "tail": z(batch, out_dim, blk["tconv"]["w"].shape[-1] - rate,
                      dtype=torch.float32),
            "units": [z(batch, out_dim, (u["conv1"]["w"].shape[-1] - 1) * d)
                      for u, d in zip(blk["units"], _DILATIONS)],
        })
        dim = out_dim
    st["out"] = z(batch, dim, dec["dec_out"]["w"].shape[-1] - 1)
    return st


def decode_stream(params: Params, cfg: CodecConfig, state: Dict,
                  codes: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Streaming decode of ``n`` new frames [B, n, Q].  Returns
    (wav [B, n*up] float32, state').  Chained calls equal ``decode`` on the
    concatenated codes."""
    dec = params["decoder"]
    n = codes.shape[1]
    st = dict(state)
    h, st["xf_k"], st["xf_v"] = _stream_xf(
        dec["pre_transformer"], _embed_codes(dec, cfg, codes), st["xf_k"],
        st["xf_v"], st["frame0"], cfg)
    st["frame0"] = st["frame0"] + n
    h = h.transpose(1, 2)

    new_up = []
    for stg, u_st, ratio in zip(dec["upsample"], st["up"], cfg.upsampling_ratios):
        h, tail = _stream_tconv(h, u_st["tail"], stg["tconv"]["w"], stg["tconv"]["b"],
                                stride=ratio)
        xin = torch.cat([u_st["cnx"].to(h.dtype), h], dim=-1)
        cnx = xin[..., xin.shape[-1] - u_st["cnx"].shape[-1]:]
        h = _convnext(stg["convnext"], h, xin)
        new_up.append({"tail": tail, "cnx": cnx})
    st["up"] = new_up

    w, st["dec_in"] = _stream_conv(h, st["dec_in"], dec["dec_in"]["w"], dec["dec_in"]["b"])
    new_blocks = []
    for blk, b_st, rate in zip(dec["blocks"], st["blocks"], cfg.upsample_rates):
        w = snake_beta(w, blk["alpha"], blk["beta"])
        w, tail = _stream_tconv(w, b_st["tail"], blk["tconv"]["w"], blk["tconv"]["b"],
                                stride=rate)
        carries: List[torch.Tensor] = []
        for unit, carry, dilation in zip(blk["units"], b_st["units"], _DILATIONS):
            h2 = snake_beta(w, unit["alpha1"], unit["beta1"])
            h2, carry = _stream_conv(h2, carry, unit["conv1"]["w"], unit["conv1"]["b"],
                                     dilation=dilation)
            h2 = snake_beta(h2, unit["alpha2"], unit["beta2"])
            w = w + causal_conv(h2, unit["conv2"]["w"], unit["conv2"]["b"])
            carries.append(carry)
        new_blocks.append({"tail": tail, "units": carries})
    st["blocks"] = new_blocks

    w = snake_beta(w, dec["out_alpha"], dec["out_beta"])
    w, st["out"] = _stream_conv(w, st["out"], dec["dec_out"]["w"], dec["dec_out"]["b"])
    return torch.clamp(w[:, 0].float(), -1.0, 1.0), st
