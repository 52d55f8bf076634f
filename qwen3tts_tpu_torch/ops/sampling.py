"""Sampling: suppress -> temperature -> top-k -> top-p -> categorical.

Port of ``qwen3tts_tpu/ops/sampling.py`` with the same threshold semantics:
top-k keeps every logit >= the k-th largest (ties at the k-th value
survive), top-p keeps ids whose inclusive cumulative probability is <= top_p
and always the top-1, the constant suppress mask and the per-row
``suppress_eos`` push logits to ``NEG_INF``.

The numeric knobs (temperature, top_p, the repetition penalty) are Python
numbers or 0-d float32 tensors on the logits' device, as the JAX package
takes traced scalars: a captured CUDA graph reads a tensor knob at every
replay instead of freezing its value.  A number becomes such a tensor (a
fill, no host copy) before it is used, so the two forms run the same kernels
and give the same bits; on the card, dividing by a Python number would
instead multiply by its float32 reciprocal.  The structure stays static:
``do_sample``, ``top_k`` and ``use_top_p`` (whether top-p applies, which a
tensor ``top_p`` cannot say without a host read).

The categorical draw is Gumbel-max from an explicit ``torch.Generator``:
``argmax(logits + Gumbel noise)`` runs entirely on the logits' device, so a
decode step never waits for the host.  Philox noise is not JAX's threefry,
so only greedy (``do_sample=False``) decoding is token-comparable with the
JAX package.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

NEG_INF = -1e30
Knob = Union[float, torch.Tensor]


def knob(x: Knob, like: torch.Tensor) -> torch.Tensor:
    """A knob as a 0-d float32 tensor on ``like``'s device."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), x, dtype=torch.float32, device=like.device)


def build_suppress_mask(vocab_size: int, eos_id: int, zone: int = 1024) -> np.ndarray:
    """Boolean [V]: True = suppress.  The top `zone` ids are control tokens and
    must never be sampled, except EOS."""
    mask = np.zeros(vocab_size, dtype=bool)
    mask[max(0, vocab_size - zone):] = True
    mask[eos_id] = False
    return mask


def apply_repetition_penalty(
    logits: torch.Tensor,  # [..., V]
    seen: torch.Tensor,  # [..., V] bool — ids generated so far
    penalty: Knob,
) -> torch.Tensor:
    if not isinstance(penalty, torch.Tensor) and penalty == 1.0:
        return logits
    lf = logits.float()
    penalty = knob(penalty, lf)
    penalized = torch.where(lf > 0, lf / penalty, lf * penalty)
    return torch.where(seen, penalized, lf)


def filter_logits(
    logits: torch.Tensor,  # [B, V]
    *,
    temperature: Knob,
    top_k: int,
    top_p: Knob,
    use_top_p: Optional[bool] = None,  # default: top_p < 1 (a number's)
    suppress_mask: Optional[torch.Tensor] = None,  # [V] bool
    suppress_eos: Optional[torch.Tensor] = None,  # [] or [B] bool
    eos_id: int = -1,
    scale: bool = True,
) -> torch.Tensor:
    """float32 logits with every excluded id at ``NEG_INF``.  ``scale=False``
    applies only the suppress masks (the greedy path)."""
    if use_top_p is None:
        if isinstance(top_p, torch.Tensor):
            raise ValueError("a tensor top_p needs use_top_p")
        use_top_p = top_p < 1.0
    logits = logits.float()
    if suppress_mask is not None:
        logits = logits.masked_fill(suppress_mask, NEG_INF)
    if suppress_eos is not None and eos_id >= 0:
        se = suppress_eos.reshape(-1, 1)  # scalar -> [1, 1], per-row -> [B, 1]
        eos_col = torch.zeros_like(logits, dtype=torch.bool)
        eos_col[:, eos_id] = True
        logits = logits.masked_fill(se & eos_col, NEG_INF)
    if not scale:
        return logits

    logits = logits / knob(temperature, logits)
    V = logits.shape[-1]
    if 0 < top_k < V:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)

    if use_top_p:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        keep = cum <= knob(top_p, cum)
        keep[..., 0] = True
        thresh = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf")))
        thresh = thresh.min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < thresh, NEG_INF)
    return logits


def sample_logits(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,  # [B, V]
    *,
    temperature: Knob,
    top_k: int,
    top_p: Knob,
    do_sample: bool,
    use_top_p: Optional[bool] = None,
    suppress_mask: Optional[torch.Tensor] = None,
    suppress_eos: Optional[torch.Tensor] = None,
    eos_id: int = -1,
) -> torch.Tensor:
    """Returns sampled token ids [B] (int64) on the logits' device."""
    if not do_sample:
        use_top_p = False  # the greedy path reads no knob
    logits = filter_logits(
        logits, temperature=temperature, top_k=top_k, top_p=top_p, use_top_p=use_top_p,
        suppress_mask=suppress_mask,
        suppress_eos=suppress_eos, eos_id=eos_id, scale=do_sample)
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)
