"""Long-form synthesis: sentence chunking over the bounded context window.

Copy of ``qwen3tts_tpu/api/longform.py`` for the PyTorch port (the JAX
package cannot be imported without JAX; the module itself is plain Python).
The engine's cache holds at most ``max_seq_len`` slots and refuses longer
prompts, so long text is split into sentence groups that fit, each
synthesized with the same voice prompt (the voice-prompt cache makes repeat
prompts free) and joined with a short silence.  With
``condition_on_previous=True`` each group after the first is an ICL clone of
the previous group's audio and text.
"""
from __future__ import annotations

import re
from typing import Generator, List, Optional, Tuple

import numpy as np

_SENT_RE = re.compile(r"([^.!?。！？]*[.!?。！？]+|[^.!?。！？]+$)", re.S)


def split_sentences(text: str, max_chars: int = 300) -> List[str]:
    """Split into sentence groups of at most ``max_chars`` characters
    (long sentences are hard-split)."""
    sents = [s.strip() for s in _SENT_RE.findall(text) if s.strip()]
    groups: List[str] = []
    cur = ""
    for s in sents:
        if len(s) > max_chars and cur:  # flush before hard-splitting
            groups.append(cur)
            cur = ""
        while len(s) > max_chars:  # pathological sentence: hard split
            groups.append(s[:max_chars])
            s = s[max_chars:]
        if len(cur) + len(s) + 1 <= max_chars:
            cur = (cur + " " + s).strip()
        else:
            if cur:
                groups.append(cur)
            cur = s
    if cur:
        groups.append(cur)
    return groups


def _segment_refs(model, ref_audio, ref_text, prev_audio, prev_text,
                  condition_on_previous, max_condition_s, sr, gen_kwargs):
    """Reference pair for the next segment: the PREVIOUS segment's full
    (audio, transcript) as an ICL prompt when conditioning — a correctly
    aligned pair, so the talker continues the established prosody across
    sentence-group boundaries; falls back to the original reference when the
    previous segment is too long to spend prefill budget on."""
    if (condition_on_previous and prev_audio is not None
            and len(prev_audio) <= max_condition_s * sr):
        kw = dict(gen_kwargs, xvec_only=False)
        return (prev_audio, sr), prev_text, kw
    return ref_audio, ref_text, gen_kwargs


def generate_longform(
    model,
    text: str,
    language: str,
    ref_audio,
    ref_text: str,
    *,
    max_chars: int = 300,
    gap_ms: int = 120,
    condition_on_previous: bool = False,
    max_condition_s: float = 12.0,
    **gen_kwargs,
) -> Tuple[np.ndarray, int]:
    """Synthesize arbitrarily long text as concatenated sentence groups.

    ``condition_on_previous=True``: each segment after the first uses the
    previous segment's (audio, transcript) as a full-ICL reference for
    cross-sentence prosody continuity (same voice — it is the same speaker's
    generated audio).  Returns (waveform, sample_rate)."""
    sr = model.sample_rate
    gap = np.zeros(int(gap_ms / 1000 * sr), np.float32)
    parts: List[np.ndarray] = []
    prev_audio: Optional[np.ndarray] = None
    prev_text = ""
    for i, group in enumerate(split_sentences(text, max_chars)):
        ra, rt, kw = _segment_refs(model, ref_audio, ref_text, prev_audio,
                                   prev_text, condition_on_previous and i > 0,
                                   max_condition_s, sr, gen_kwargs)
        audio_list, sr = model.generate_voice_clone(group, language, ra, rt, **kw)
        if i:
            parts.append(gap)
        parts.append(audio_list[0])
        prev_audio, prev_text = audio_list[0], group
    if not parts:
        return np.zeros(1, np.float32), sr
    return np.concatenate(parts), sr


def generate_longform_streaming(
    model,
    text: str,
    language: str,
    ref_audio,
    ref_text: str,
    *,
    max_chars: int = 300,
    gap_ms: int = 120,
    chunk_size: int = 8,
    condition_on_previous: bool = False,
    max_condition_s: float = 12.0,
    **gen_kwargs,
) -> Generator[Tuple[np.ndarray, int, dict], None, None]:
    """Streaming long-form synthesis: chunks flow continuously across
    sentence-group boundaries (cross-segment ICL conditioning as in
    ``generate_longform``)."""
    sr = model.sample_rate
    gap = np.zeros(int(gap_ms / 1000 * sr), np.float32)
    prev_audio: Optional[np.ndarray] = None
    prev_text = ""
    for i, group in enumerate(split_sentences(text, max_chars)):
        if i:
            yield gap, sr, {"segment": i, "is_gap": True}
        ra, rt, kw = _segment_refs(model, ref_audio, ref_text, prev_audio,
                                   prev_text, condition_on_previous and i > 0,
                                   max_condition_s, sr, gen_kwargs)
        seg_parts: List[np.ndarray] = []
        for audio, sr, timing in model.generate_voice_clone_streaming(
            group, language, ra, rt, chunk_size=chunk_size, **kw,
        ):
            seg_parts.append(audio)
            timing = dict(timing, segment=i, is_gap=False)
            yield audio, sr, timing
        prev_audio = np.concatenate(seg_parts) if seg_parts else None
        prev_text = group
