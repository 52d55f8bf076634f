"""Decode loops: non-streaming and streaming with audio.

Port of ``qwen3tts_tpu/runtime/loops.py`` (``fast_generate`` and
``fast_generate_streaming_audio``) with the same timing-dict keys.  Each
chunk runs on the device without a host sync; the host reads the chunk's
frames, valid lengths and done flags once per chunk.  Timings bracket work
that ends in a device synchronize, so they are wall times of finished work.
"""
from __future__ import annotations

import time
from typing import Dict, Generator, Optional, Tuple

import numpy as np
import torch

from ..models.predictor import SamplingPolicy
from .engine import Engine, GenerationPolicy

Frames = np.ndarray  # [steps, 16] int32


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(engine: Engine, *arrays):
    return tuple(torch.as_tensor(a).to(engine.device, engine.dtype) for a in arrays)


def _chunks(engine: Engine, state: Dict, tth, tth_len: int, tpe, chunk_size: int,
            max_new_tokens: int, first_chunks: Tuple[int, ...] = (), vocoder=None,
            voc_state=None):
    """Yields (frames [n,16] int32, audio float32 [n*spf] or None, done) per
    chunk; ``n`` counts row 0's valid frames, capped at the token budget."""
    sizes = list(first_chunks) + [chunk_size]
    emitted = 0
    i = 0
    while emitted < max_new_tokens:
        size = min(sizes[min(i, len(sizes) - 1)], max_new_tokens - emitted)
        if vocoder is None:
            state, frames, n, lens, done = engine.decode_chunk(
                state, tth, tth_len, tpe, size)
            audio = None
        else:
            state, frames, n, lens, done, audio, voc_state = engine.chunk_vocode(
                vocoder, state, tth, tth_len, tpe, size, voc_state)
        # the one host read of this chunk
        n_val = int(lens[0])
        frames_np = frames[0, :n_val].to(torch.int32).cpu().numpy()
        audio_np = audio[: n_val * vocoder.spf].float().cpu().numpy() if audio is not None else None
        done_val = bool(done.all()) or engine.at_limit(state)
        emitted += n_val
        finished = done_val or n == 0 or emitted >= max_new_tokens
        yield frames_np, audio_np, finished
        if finished:
            return
        i += 1


def fast_generate(
    engine: Engine,
    talker_input_embeds,  # [1, T, H]
    trailing_text_hiddens,  # [1, Ttth, H]
    tts_pad_embed,  # [1, 1, H]
    *,
    generator: Optional[torch.Generator],
    max_new_tokens: int = 2048,
    policy: GenerationPolicy = GenerationPolicy(),
    pred_policy: SamplingPolicy = SamplingPolicy(),
    device_chunk: int = 16,
) -> Tuple[Optional[Frames], Dict]:
    """Non-streaming generation.  Returns ([steps,16] codec ids, timing)."""
    t0 = time.time()
    tth, tpe = _to_device(engine, trailing_text_hiddens, tts_pad_embed)
    state = engine.prefill(talker_input_embeds, generator, policy, pred_policy)
    _sync(engine.device)
    t_prefill = time.time() - t0

    t1 = time.time()
    try:
        chunks = [f for f, _, _ in _chunks(engine, state, tth, tth.shape[1], tpe,
                                           device_chunk, max_new_tokens) if len(f)]
    finally:
        engine.release(state)
    t_decode = time.time() - t1
    steps = sum(c.shape[0] for c in chunks)
    timing = {
        "prefill_ms": t_prefill * 1000,
        "decode_s": t_decode,
        "steps": steps,
        "ms_per_step": (t_decode / steps * 1000) if steps else 0.0,
        "steps_per_s": (steps / t_decode) if t_decode > 0 else 0.0,
    }
    if not chunks:
        return None, timing
    return np.concatenate(chunks, axis=0), timing


def fast_generate_streaming_audio(
    engine: Engine,
    vocoder,
    talker_input_embeds,
    trailing_text_hiddens,
    tts_pad_embed,
    *,
    generator: Optional[torch.Generator],
    max_new_tokens: int = 2048,
    policy: GenerationPolicy = GenerationPolicy(),
    pred_policy: SamplingPolicy = SamplingPolicy(),
    chunk_size: int = 8,
    first_chunks: Tuple[int, ...] = (),
) -> Generator[Tuple[Frames, np.ndarray, Dict], None, None]:
    """Streaming generation with the streaming codec: yields
    (codec_chunk [n,16], audio [n*spf] float32, timing) per chunk.  The KV
    cache goes back to the engine when the stream ends, also when the
    generator is closed early."""
    t0 = time.time()
    tth, tpe = _to_device(engine, trailing_text_hiddens, tts_pad_embed)
    state = engine.prefill(talker_input_embeds, generator, policy, pred_policy)
    _sync(engine.device)
    t_prefill = time.time() - t0

    voc_state = vocoder.stream_state()
    emitted = 0
    chunk_count = 0
    chunk_start = time.time()
    try:
        for frames_np, audio_np, finished in _chunks(
                engine, state, tth, tth.shape[1], tpe, chunk_size, max_new_tokens,
                first_chunks, vocoder, voc_state):
            n = frames_np.shape[0]
            if n == 0:
                break
            emitted += n
            yield frames_np, audio_np, {
                "chunk_index": chunk_count,
                "chunk_steps": n,
                "prefill_ms": t_prefill * 1000 if chunk_count == 0 else 0,
                "decode_ms": (time.time() - chunk_start) * 1000,
                "total_steps_so_far": emitted,
                "is_final": finished,
            }
            chunk_count += 1
            chunk_start = time.time()
    finally:
        engine.release(state)
