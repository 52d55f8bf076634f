"""x-vector speaker encoder (ECAPA-TDNN style) -> speaker embedding.

Port of ``qwen3tts_tpu/models/speaker.py``: log-mel (25 ms / 10 ms at
16 kHz) -> dilated TDNN blocks -> attentive statistics pooling -> linear ->
L2-normalised ``emb_dim`` vector.  Activations run channels-first
``[1, C, T]`` for ``F.conv1d``; conv weights are stored ``[Cout, Cin, K]``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import SpeakerEncoderConfig
from .layers import randn

Params = Dict

_N_FFT = 512
_WIN = 400
_HOP = 160


def _mel_filterbank(n_mels: int, sr: int, n_fft: int = _N_FFT) -> np.ndarray:
    """[n_fft//2+1, n_mels] triangular mel filter matrix (host constant)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2)
    bins = np.floor((n_fft + 1) * mel_to_hz(mels) / sr).astype(int)
    fb = np.zeros((n_fft // 2 + 1, n_mels), np.float32)
    for m in range(1, n_mels + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, c):
            fb[k, m - 1] = (k - lo) / (c - lo)
        for k in range(c, hi):
            fb[k, m - 1] = (hi - k) / (hi - c)
    return fb


def log_mel(wav: torch.Tensor, n_mels: int, sr: int) -> torch.Tensor:
    """wav [N] float32 at 16 kHz -> log-mel [frames, n_mels]."""
    if wav.shape[0] < _WIN:
        wav = F.pad(wav, (0, _WIN - wav.shape[0]))
    frames = wav.unfold(0, _WIN, _HOP)  # [n, WIN]
    window = torch.from_numpy(np.hanning(_WIN).astype(np.float32)).to(wav.device)
    spec = torch.fft.rfft(frames * window, n=_N_FFT, dim=-1).abs().pow(2)
    fb = torch.from_numpy(_mel_filterbank(n_mels, sr)).to(wav.device)
    return torch.log(torch.clamp_min(spec @ fb, 1e-10))


def init_params(gen: torch.Generator, cfg: SpeakerEncoderConfig, dtype, device) -> Params:
    C = cfg.channels

    def conv(K, cin, cout):
        return {"w": randn(gen, (cout, cin, K), (K * cin) ** -0.5, dtype, device),
                "b": torch.zeros(cout, dtype=dtype, device=device)}

    ks = cfg.kernel_sizes
    blocks = [{"conv": conv(ks[min(i + 1, len(ks) - 1)], C, C), "pw": conv(1, C, C)}
              for i in range(cfg.num_blocks)]
    return {
        "in_conv": conv(ks[0], cfg.mel_bins, C),
        "blocks": blocks,
        "cat_conv": conv(1, C * (cfg.num_blocks + 1), C),
        "att_w1": conv(1, C, cfg.attention_channels),
        "att_w2": conv(1, cfg.attention_channels, C),
        "out": {"w": randn(gen, (2 * C, cfg.emb_dim), (2 * C) ** -0.5, dtype, device),
                "b": torch.zeros((cfg.emb_dim,), dtype=dtype, device=device)},
    }


def _conv1d(x: torch.Tensor, p: Params, dilation: int = 1) -> torch.Tensor:
    """'Same' conv with the JAX package's asymmetric padding: (K-1)d//2 on the
    left, the rest on the right."""
    K = p["w"].shape[-1]
    total = (K - 1) * dilation
    x = F.pad(x, (total // 2, total - total // 2))
    return F.conv1d(x, p["w"], p["b"], dilation=dilation)


def embed(params: Params, cfg: SpeakerEncoderConfig, wav16k: torch.Tensor) -> torch.Tensor:
    """wav [N] float32 at 16 kHz -> speaker embedding [emb_dim]."""
    mel = log_mel(wav16k.float(), cfg.mel_bins, cfg.sample_rate)
    mel = mel - mel.mean(dim=0, keepdim=True)  # CMN
    x = mel.t()[None].to(params["in_conv"]["w"].dtype)  # [1, mel, T]

    x = F.relu(_conv1d(x, params["in_conv"]))
    feats = [x]
    dil = cfg.dilations
    for i, blk in enumerate(params["blocks"]):
        h = F.relu(_conv1d(x, blk["conv"], dilation=dil[min(i + 1, len(dil) - 1)]))
        h = F.relu(_conv1d(h, blk["pw"]))
        x = x + h
        feats.append(x)
    x = F.relu(_conv1d(torch.cat(feats, dim=1), params["cat_conv"]))  # [1, C, T]

    # attentive statistics pooling over time
    a = _conv1d(torch.tanh(_conv1d(x, params["att_w1"])), params["att_w2"])
    a = torch.softmax(a.float(), dim=-1)
    xf = x.float()
    mean = (a * xf).sum(dim=-1)  # [1, C]
    var = (a * xf * xf).sum(dim=-1) - mean ** 2
    std = torch.sqrt(torch.clamp_min(var, 1e-9))
    stats = torch.cat([mean, std], dim=-1).to(x.dtype)  # [1, 2C]

    emb = (stats @ params["out"]["w"] + params["out"]["b"])[0]
    return emb / torch.clamp_min(torch.linalg.vector_norm(emb.float()), 1e-9).to(emb.dtype)
