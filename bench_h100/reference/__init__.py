"""Plain references, one module a talker architecture (``<name>.py``, named
by a configuration's ``bench.reference``), and what the check takes from
every one of them alike: TF32 off, and the talker's logits as its sampler
sees them.

A module's ``Reference(params, cfg)`` gives the x-vector, the prompt, the
talker's logits and final hidden along served frames, the code predictor's
logits and the codec decoder's waveform (``qwen3tts.py``).  Another talker
subclasses ``qwen3tts.Reference`` and replaces its ``talker_stack``.
"""
from __future__ import annotations

import torch


def no_tf32() -> None:
    """float32 products stay float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def logits_processed(logits: torch.Tensor, codes0: torch.Tensor, vocab: int,
                     penalty: float, zone: int = 1024) -> torch.Tensor:
    """The talker's codebook-0 logits as its sampler sees them, in float64:
    the repetition penalty on every id emitted before the frame (divided
    where positive, multiplied where not) and the control ids (the top
    ``zone`` of the vocabulary) out, EOS included, as it is while a request
    is below its minimum length."""
    out = logits.double().clone()
    F_ = out.shape[0]
    seen = torch.zeros((F_, vocab), dtype=torch.bool, device=out.device)
    for f in range(1, F_):
        seen[f] = seen[f - 1]
        seen[f, codes0[f - 1]] = True
    if penalty != 1.0:
        pen = torch.where(out > 0, out / penalty, out * penalty)
        out = torch.where(seen, pen, out)
    out[:, vocab - zone:] = float("-inf")
    return out
