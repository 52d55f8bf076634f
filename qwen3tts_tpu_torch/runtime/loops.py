"""Decode loops: non-streaming, streaming frames, streaming with audio,
batched, and the per-step parity loops.

Port of ``qwen3tts_tpu/runtime/loops.py`` (``fast_generate``,
``fast_generate_streaming``, ``fast_generate_streaming_audio``,
``fast_generate_batch``, ``parity_generate`` and
``parity_generate_streaming``) with the same timing-dict keys.  The
trailing text is padded to a ``TTH_BUCKETS`` length (``bucketed=True``), so
that a few captured chunks serve every text.  The parity loops leave it
unpadded and run ``Engine.decode_step`` eagerly, one
step at a time with a host read of the token after each, as the reference's
slow parity mode does: the same steps as the fast path, so their greedy
tokens are equal.

The loops are pipelined: chunk k+1 is dispatched before chunk k is read
(``pipeline_depth`` chunks ahead in the audio stream), and each chunk's
frames, steps run, valid lengths, done flags and audio are copied to pinned
host buffers as soon as the chunk is dispatched, before any later chunk can
overwrite its graph's buffers; the host waits on the copies' event, never
on a device value.  A chunk dispatched after the one in which every row
ended runs no step (its steps' conditions fail on the card).
When the stream ends the newest state's cache goes back to the engine, also
when a streaming generator is closed early.  Timings bracket work that ends
in a device synchronize, so they are wall times of finished work, except
the audio stream's ``prefill_ms``, which is the host's dispatch of the
prompt (its device time lands in the first chunk, as in the JAX loop).
They are ``time.perf_counter`` intervals, and while the tracer is on
(``utils/timing.py:TRACE``) the same intervals are its spans: ``prefill``,
``decode`` (a streaming chunk, or the whole chunk loop), and inside it
``dispatch`` (a chunk enqueued) and ``read_wait`` (``HostCopy.get``).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Generator, Optional, Tuple

import numpy as np
import torch

from ..models.predictor import SamplingPolicy
from ..utils.timing import TRACE
from .engine import TTH_BUCKETS, Engine, GenerationPolicy, bucket_for, upload

Frames = np.ndarray  # [steps, 16] int32

# Chunks dispatched ahead of the one the audio stream reads.  One is enough
# on the H100: a replayed chunk of 8 steps keeps the card busy for longer
# than the host takes to read the one before it and dispatch the next
# (PERF.md, chip_smoke.py's slice-graph depth sweep).
PIPELINE_DEPTH = 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(engine: Engine, *arrays):
    return tuple(upload(a, engine.device, engine.dtype) for a in arrays)


def _pad_tth(tth: torch.Tensor, tpe: torch.Tensor, bucketed: bool
             ) -> Tuple[torch.Tensor, int]:
    """Pad the trailing text [B, T, H] with the tts_pad embedding to a
    ``TTH_BUCKETS`` length (or to at least 1).  Returns (padded, T)."""
    B, T, H = tth.shape
    Tb = bucket_for(max(T, 1), TTH_BUCKETS) if bucketed else max(T, 1)
    if Tb > T:
        tth = torch.cat([tth, tpe.expand(B, Tb - T, H)], dim=1)
    return tth, T


class HostCopy:
    """A chunk's device outputs on their way to the host: copied into
    host buffers (pinned, asynchronously, on the card) when the chunk is
    dispatched; ``get`` waits for the copies alone."""

    def __init__(self, tensors):
        self.host, self.event = list(tensors), None
        if tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self):
        with TRACE.span("read_wait"):
            if self.event is not None:
                self.event.synchronize()
            return [h.numpy() for h in self.host]


def _chunk_iter(engine: Engine, state: Dict, tth, tth_len, tpe, chunk_size: int,
                max_new_tokens: int, first_chunks: Tuple[int, ...] = (), depth: int = 1,
                vocoder=None, voc_state=None, full_batch: bool = False):
    """Yields (frames [B, c, 16] int32, lens [B], audio or None, finished)
    per chunk: ``c`` the chunk's steps within the token budget, ``lens[b]``
    row b's valid frames among them (a row freezes at its EOS), ``audio`` as
    the chunk returned it (row 0's or, with ``full_batch``, every row's).
    Up to ``depth`` chunks are dispatched ahead of the one read, growing by
    at most two between reads (the first read is not held up by a burst).
    ``first_chunks`` ramps up the first chunk sizes.  Each chunk read hands
    its steps to ``Engine.settle``.  Releases the state's cache when it
    stops, also when closed early."""
    sizes = list(first_chunks) + [chunk_size]
    q: deque = deque()
    planned = 0

    def dispatch():
        nonlocal planned, voc_state
        with TRACE.span("dispatch"):
            size = sizes[min(len(q) + n_read, len(sizes) - 1)]
            before = state["pos_host"]
            if vocoder is None:
                _, *outs = engine.decode_chunk(state, tth, tth_len, tpe, size)
            else:
                chunk = engine.chunk_vocode_batched if full_batch else engine.chunk_vocode
                _, *outs, voc_state = chunk(vocoder, state, tth, tth_len, tpe, size, voc_state)
            q.append(HostCopy(outs))
            planned += state["pos_host"] - before

    n_read = emitted = 0
    try:
        dispatch()
        while q:
            grown = 0
            while (planned < max_new_tokens and len(q) <= depth and grown < 2
                   and not engine.at_limit(state)):
                dispatch()
                grown += 1
            frames, n, lens, done, *audio = q.popleft().get()
            n_read += 1
            engine.settle(state, int(n))
            c = min(int(n), max_new_tokens - emitted)
            emitted += c
            finished = (bool(done.all()) or emitted >= max_new_tokens or c == 0
                        or (not q and engine.at_limit(state)))
            yield (frames[:, :c].astype(np.int32), np.minimum(lens, c),
                   audio[0] if audio else None, finished)
            if finished:
                return
    finally:
        engine.release(state)


def _row0(chunks, spf: int):
    """The first row of ``_chunk_iter``'s chunks: (frames [n, 16], audio
    float32 [n*spf] or None, finished), ``n`` its valid frames.  Closes
    ``chunks`` when it stops."""
    try:
        for frames, lens, audio, finished in chunks:
            n = int(lens[0])
            yield (frames[0, :n], audio[: n * spf].astype(np.float32) if audio is not None
                   else None, finished)
    finally:
        chunks.close()


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
    bucketed: bool = True,
) -> Tuple[Optional[Frames], Dict]:
    """Non-streaming generation.  Returns ([steps,16] codec ids, timing)."""
    with TRACE.timed("prefill") as prefill:
        tth, tpe = _to_device(engine, trailing_text_hiddens, tts_pad_embed)
        tth, tth_len = _pad_tth(tth, tpe, bucketed)
        state = engine.prefill(talker_input_embeds, generator, policy, pred_policy)
        _sync(engine.device)
    t_prefill = prefill.seconds

    with TRACE.timed("decode") as decode:
        chunks = [f for f, _, _ in _row0(_chunk_iter(engine, state, tth, tth_len, tpe,
                                                     device_chunk, max_new_tokens), 0) if len(f)]
    t_decode = decode.seconds
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


def fast_generate_streaming(
    engine: Engine,
    talker_input_embeds,
    trailing_text_hiddens,
    tts_pad_embed,
    *,
    generator: Optional[torch.Generator],
    max_new_tokens: int = 2048,
    policy: GenerationPolicy = GenerationPolicy(),
    pred_policy: SamplingPolicy = SamplingPolicy(),
    chunk_size: int = 8,
    bucketed: bool = True,
    first_chunks: Tuple[int, ...] = (),
) -> Generator[Tuple[Frames, Dict], None, None]:
    """Streaming generation of codec frames: yields ([chunk_steps, 16],
    timing) per chunk, chunk k+1 running on the device while the caller
    handles chunk k."""
    with TRACE.timed("prefill") as prefill:
        tth, tpe = _to_device(engine, trailing_text_hiddens, tts_pad_embed)
        tth, tth_len = _pad_tth(tth, tpe, bucketed)
        state = engine.prefill(talker_input_embeds, generator, policy, pred_policy)
        _sync(engine.device)
    yield from _timed(_row0(_chunk_iter(engine, state, tth, tth_len, tpe, chunk_size,
                                        max_new_tokens, first_chunks), 0),
                      prefill.seconds, audio=False)


def _timed(chunks, t_prefill: float, audio: bool):
    """The chunks with the JAX loops' timing dicts (a chunk's ``decode_ms``
    is its ``decode`` span: from the request for it to its arrival); closes
    ``chunks`` (and so releases its cache) when it stops."""
    emitted = chunk_count = 0
    try:
        while True:
            with TRACE.timed("decode") as decode:
                item = next(chunks, None)
                if item is None:
                    decode.discard()  # the stream ended: no chunk came
            if item is None:
                break
            frames, wav, finished = item
            n = frames.shape[0]
            if n == 0:
                break
            emitted += n
            timing = {
                "chunk_index": chunk_count,
                "chunk_steps": n,
                "prefill_ms": t_prefill * 1000 if chunk_count == 0 else 0,
                "decode_ms": decode.seconds * 1000,
                "total_steps_so_far": emitted,
                "is_final": finished,
            }
            yield (frames, wav, timing) if audio else (frames, timing)
            chunk_count += 1
    finally:
        chunks.close()


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
    bucketed: bool = True,
    first_chunks: Tuple[int, ...] = (),
    ref_codes: Optional[np.ndarray] = None,
    pipeline_depth: Optional[int] = None,
) -> Generator[Tuple[Frames, np.ndarray, Dict], None, None]:
    """Streaming generation with the streaming codec: yields
    (codec_chunk [n,16], audio [n*spf] float32, timing) per chunk, each
    chunk one decode + vocode program (``Engine.chunk_vocode``).
    ``ref_codes`` (ICL voice clone) primes the codec's stream state before
    chunk 0, their audio discarded (``Engine.vocode_prime``).
    ``pipeline_depth`` chunks (``PIPELINE_DEPTH`` by default) are
    dispatched ahead of the one read.  The prefill is not synced: it flows
    into the first chunk, so ``prefill_ms`` is the host's dispatch time.
    The KV cache goes back to the engine when the stream ends, also when the
    generator is closed early."""
    with TRACE.timed("prefill") as prefill:
        tth, tpe = _to_device(engine, trailing_text_hiddens, tts_pad_embed)
        tth, tth_len = _pad_tth(tth, tpe, bucketed)
        state = engine.prefill(talker_input_embeds, generator, policy, pred_policy)
    voc_state = vocoder.stream_state()
    if ref_codes is not None and len(ref_codes):
        voc_state = engine.vocode_prime(vocoder, voc_state, ref_codes)
    yield from _timed(_row0(_chunk_iter(
        engine, state, tth, tth_len, tpe, chunk_size, max_new_tokens, first_chunks,
        depth=PIPELINE_DEPTH if pipeline_depth is None else max(1, pipeline_depth),
        vocoder=vocoder, voc_state=voc_state), vocoder.spf), prefill.seconds, audio=True)


def fast_generate_batch(
    engine: Engine,
    talker_input_embeds,  # [B, T, H], each row left-padded by pad_count[b]
    trailing_text_hiddens,  # [B, Ttth, H], each row padded with its tts_pad embedding
    tts_pad_embed,  # [B, 1, H]
    *,
    generator: Optional[torch.Generator],
    pad_count=None,  # [B] each row's left pad
    tth_lens=None,  # [B] each row's trailing-text length
    max_new_tokens: int = 2048,
    policy: GenerationPolicy = GenerationPolicy(),
    pred_policy: SamplingPolicy = SamplingPolicy(),
    device_chunk: int = 16,
) -> Tuple[list, Dict]:
    """Batched generation: B prompts decode together on ``Engine(batch=B)``,
    each row ending at its own EOS (its frames after it are dropped) and
    the batch when every row has ended or the budget is spent.  Returns
    ([B] list of [steps_b, 16] int32 arrays, timing); the timing's
    ``steps`` counts every row's frames, ``batch`` the rows."""
    B = talker_input_embeds.shape[0]
    if engine.batch != B:
        raise ValueError(f"Engine(batch={engine.batch}) got {B} rows")
    with TRACE.timed("prefill") as prefill:
        tth, tpe = _to_device(engine, trailing_text_hiddens, tts_pad_embed)
        tth, tth_len = _pad_tth(tth, tpe, bucketed=True)
        if tth_lens is not None:
            tth_len = upload(np.asarray(tth_lens), engine.device, torch.int64)
        state = engine.prefill(talker_input_embeds, generator, policy, pred_policy,
                               pad_count=pad_count)
        _sync(engine.device)
    t_prefill = prefill.seconds

    rows = [[] for _ in range(B)]
    with TRACE.timed("decode") as decode:
        for frames, lens, _, _ in _chunk_iter(engine, state, tth, tth_len, tpe, device_chunk,
                                              max_new_tokens):
            for b in range(B):
                if lens[b]:
                    rows[b].append(frames[b, : lens[b]])
    t_decode = decode.seconds
    out = [np.concatenate(r, axis=0) if r else np.zeros((0, 16), np.int32) for r in rows]
    steps = sum(o.shape[0] for o in out)
    timing = {
        "prefill_ms": t_prefill * 1000,
        "decode_s": t_decode,
        "steps": steps,
        "ms_per_step": (t_decode / steps * 1000) if steps else 0.0,
        "steps_per_s": (steps / t_decode) if t_decode > 0 else 0.0,
        "batch": B,
    }
    return out, timing


def _parity_steps(engine: Engine, talker_input_embeds, trailing_text_hiddens,
                  tts_pad_embed, generator, max_new_tokens: int, policy, pred_policy):
    """The parity loops' prefill (unbucketed trailing text, synchronised)
    and their steps: yields (prefill seconds), then per step (frame [1, 16]
    int32, done), ``done`` once the step leaves an EOS token or a full cache
    behind, or the budget is spent.  Releases the cache when it stops."""
    with TRACE.timed("prefill") as prefill:
        tth, tpe = _to_device(engine, trailing_text_hiddens, tts_pad_embed)
        tth, tth_len = _pad_tth(tth, tpe, bucketed=False)
        state = engine.prefill(talker_input_embeds, generator, policy, pred_policy)
        try:
            _sync(engine.device)
        except BaseException:
            engine.release(state)
            raise

    def stop() -> bool:
        return (int(state["token"][0]) == engine.eos_id
                or state["pos_host"] >= engine.max_seq_len - 1)

    try:
        yield prefill.seconds
        for step in range(max_new_tokens):
            if stop():
                return
            state, frame = engine.decode_step(state, tth, tth_len, tpe)
            frame = frame.cpu().numpy().astype(np.int32)
            yield frame, step + 1 >= max_new_tokens or stop()
    finally:
        engine.release(state)


def parity_generate(
    engine: Engine,
    talker_input_embeds,
    trailing_text_hiddens,
    tts_pad_embed,
    *,
    generator: Optional[torch.Generator],
    max_new_tokens: int = 2048,
    policy: GenerationPolicy = GenerationPolicy(),
    pred_policy: SamplingPolicy = SamplingPolicy(),
) -> Tuple[Optional[Frames], Dict]:
    """Parity path: unbucketed prompt and trailing text, one eager
    ``decode_step`` per frame with a host read of the token after each.
    Returns ([steps,16] codec ids, timing) as ``fast_generate``."""
    steps_iter = _parity_steps(engine, talker_input_embeds, trailing_text_hiddens,
                               tts_pad_embed, generator, max_new_tokens, policy, pred_policy)
    t_prefill = next(steps_iter)
    with TRACE.timed("decode") as decode:
        frames = [f for f, _ in steps_iter]
    t_decode = decode.seconds
    steps = len(frames)
    timing = {
        "prefill_ms": t_prefill * 1000,
        "decode_s": t_decode,
        "steps": steps,
        "ms_per_step": (t_decode / steps * 1000) if steps else 0.0,
        "steps_per_s": (steps / t_decode) if t_decode > 0 else 0.0,
    }
    if not frames:
        return None, timing
    return np.concatenate(frames, axis=0), timing


def parity_generate_streaming(
    engine: Engine,
    talker_input_embeds,
    trailing_text_hiddens,
    tts_pad_embed,
    *,
    generator: Optional[torch.Generator],
    max_new_tokens: int = 2048,
    policy: GenerationPolicy = GenerationPolicy(),
    pred_policy: SamplingPolicy = SamplingPolicy(),
    chunk_size: int = 8,
) -> Generator[Tuple[Frames, Dict], None, None]:
    """Streaming parity path: the steps of ``parity_generate``, yielded every
    ``chunk_size`` frames as they are produced (the last chunk may be
    shorter), with the streaming loops' timing dicts."""
    steps_iter = _parity_steps(engine, talker_input_embeds, trailing_text_hiddens,
                               tts_pad_embed, generator, max_new_tokens, policy, pred_policy)
    t_prefill = next(steps_iter)

    def chunks():
        buf = []  # the last step is flagged done, so no frame is left over
        try:
            for frame, done in steps_iter:
                buf.append(frame)
                if len(buf) == chunk_size or done:
                    yield np.concatenate(buf, axis=0), None, done
                    buf = []
        finally:
            steps_iter.close()

    yield from _timed(chunks(), t_prefill, audio=False)
