"""Multi-axis rotary position embeddings (MRoPE), port of
``qwen3tts_tpu/ops/rope.py``.

cos/sin are computed from position tensors on the positions' device, so a
decode step whose position lives in device memory never syncs with the host.
RoPE runs in float32; callers cast q/k back to the model dtype afterwards.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def mrope_cos_sin(
    positions: torch.Tensor,  # [3, B, T] (or [B, T] for single-axis RoPE)
    head_dim: int,
    theta: float,
    sections: Sequence[int] | None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (cos, sin) each of shape [B, T, head_dim]."""
    half = head_dim // 2
    dev = positions.device
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, half, dtype=torch.float32, device=dev) / float(half))
    )  # [half]
    if positions.dim() == 2:
        positions = positions.unsqueeze(0).expand(3, *positions.shape)
    freqs = positions.unsqueeze(-1).to(torch.float32) * inv_freq  # [3, B, T, half]

    if sections is None:
        freqs = freqs[0]
    else:
        if sum(sections) != half:
            raise ValueError(f"mrope sections {tuple(sections)} must sum to {half}")
        axis_of_dim = torch.cat([
            torch.full((s,), i, dtype=torch.int64, device=dev)
            for i, s in enumerate(sections)])  # [half]
        idx = axis_of_dim.view(1, 1, 1, half).expand(1, *freqs.shape[1:])
        freqs = torch.gather(freqs, 0, idx)[0]  # [B, T, half]

    emb = torch.cat([freqs, freqs], dim=-1)  # [B, T, head_dim]
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor,  # [B, T, NH, D]
    k: torch.Tensor,  # [B, T, KVH, D]
    cos: torch.Tensor,  # [B, T, D] float32
    sin: torch.Tensor,  # [B, T, D]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns float32 (q, k): the products promote to cos/sin's dtype."""
    cos = cos.unsqueeze(2)
    sin = sin.unsqueeze(2)
    q = q * cos + rotate_half(q) * sin
    k = k * cos + rotate_half(k) * sin
    return q, k
