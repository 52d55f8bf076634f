"""What the benchmark reads from the program without changing what it does.

The program's outputs to a user are audio; the check needs the codec
frames behind that audio.  Each tap takes them where the program already
has them and hands them on untouched:

- ``StreamCodes``: the frames that ``loops.fast_generate_streaming_audio``
  yields beside each audio chunk (the streaming API drops them);
- ``BatchCodes``: the rows and timing dict ``loops.fast_generate_batch``
  returns (the batch API keeps only the waveforms);
- ``ServeCodes``: the frames of each chunk the continuous batcher replays,
  copied to the host behind the chunk's own outputs (the batcher copies
  ``n``, ``lens``, audio and ``done`` only), matched to the row whose audio
  it delivers.

``DeviceSpans`` puts CUDA events around eager device work (prefills, joins,
full codec decodes) for the device's busy time in a traced run.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List

import numpy as np
import torch


class _Patch:
    """Set ``obj.name`` to a wrapper until ``close``."""

    def __init__(self):
        self._undo: List = []

    def patch(self, obj, name: str, new) -> None:
        had = name in vars(obj)
        old = vars(obj).get(name)
        setattr(obj, name, new)
        self._undo.append((obj, name, had, old))

    def close(self) -> None:
        for obj, name, had, old in reversed(self._undo):
            if had:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self._undo = []


class StreamCodes(_Patch):
    """The frames of each streamed request: ``calls[i]`` the [n, 16] frames
    of the i-th stream, in order."""

    def __init__(self):
        super().__init__()
        from qwen3tts_tpu_torch.runtime import loops

        self.calls: List[np.ndarray] = []
        orig = loops.fast_generate_streaming_audio

        def tapped(*a, **k):
            got: List[np.ndarray] = []
            self.calls.append(got)
            for codes, audio, timing in orig(*a, **k):
                got.append(np.asarray(codes))
                yield codes, audio, timing

        self.patch(loops, "fast_generate_streaming_audio", tapped)

    def frames(self, i: int) -> np.ndarray:
        return np.concatenate(self.calls[i]) if self.calls[i] else np.zeros((0, 16), np.int64)


class BatchCodes(_Patch):
    """Each batch call's ([B] rows of frames, timing dict)."""

    def __init__(self):
        super().__init__()
        from qwen3tts_tpu_torch.runtime import loops

        self.calls: List = []
        orig = loops.fast_generate_batch

        def tapped(*a, **k):
            rows, timing = orig(*a, **k)
            self.calls.append(([np.asarray(r) for r in rows], dict(timing)))
            return rows, timing

        self.patch(loops, "fast_generate_batch", tapped)


class ServeCodes(_Patch):
    """Frames of each served request, by the id of the batcher's request.

    The engine's ``chunk_vocode_batched`` is wrapped to start a copy of the
    chunk's frames to pinned host memory right after the replay, on the
    same stream; the scheduler's ``HostCopy`` then takes that copy with the
    chunk's other outputs (its event covers both), and its ``get`` makes
    the frames current when the scheduler reads the chunk.  The batcher's
    ``_deliver`` is wrapped to take row b's frames, b found from where the
    delivered audio lies in the chunk's host buffer."""

    def __init__(self, batcher):
        super().__init__()
        from qwen3tts_tpu_torch.runtime import scheduler

        self.frames: Dict[int, tuple] = {}  # id(request) -> (request, [frames])
        self._pending: collections.deque = collections.deque()
        self._current = None
        self._lock = threading.Lock()
        self.max_pos = 0  # the furthest a batch's shared position got
        eng = batcher.engine
        orig_chunk = eng.chunk_vocode_batched

        def chunk(*a, **k):
            out = orig_chunk(*a, **k)
            self.max_pos = max(self.max_pos, out[0]["pos_host"])
            frames = out[1]
            host = torch.empty(frames.shape, dtype=frames.dtype,
                               pin_memory=frames.is_cuda)
            host.copy_(frames, non_blocking=frames.is_cuda)
            self._pending.append(host)
            return out

        tap = self
        base = scheduler.HostCopy

        class HostCopy(base):
            def __init__(self, tensors):
                self.frames = tap._pending.pop() if tap._pending else None
                tap._pending.clear()
                super().__init__(tensors)

            def get(self):
                got = super().get()
                tap._current = (got[2], None if self.frames is None else self.frames.numpy())
                return got

        orig_deliver = batcher._deliver

        def deliver(req, audio, n_frames):
            chunk_audio, chunk_frames = tap._current
            off = (audio.__array_interface__["data"][0]
                   - chunk_audio.__array_interface__["data"][0])
            b = off // chunk_audio.strides[0]
            with tap._lock:
                held = self.frames.get(id(req))
                if held is None or held[0] is not req:  # ids of freed requests recur
                    held = self.frames[id(req)] = (req, [])
                held[1].append(np.array(chunk_frames[b, :n_frames]))
            return orig_deliver(req, audio, n_frames)

        self.patch(eng, "chunk_vocode_batched", chunk)
        self.patch(scheduler, "HostCopy", HostCopy)
        self.patch(batcher, "_deliver", deliver)

    def of(self, req) -> np.ndarray:
        with self._lock:
            held = self.frames.get(id(req))
            got = held[1] if held is not None and held[0] is req else []
            return np.concatenate(got) if got else np.zeros((0, 16), np.int64)


class DeviceSpans(_Patch):
    """CUDA events around each call of the wrapped methods: ``spans`` is a
    list of (name, start event, end event)."""

    def __init__(self):
        super().__init__()
        self.spans: List = []

    def wrap(self, obj, name: str) -> None:
        orig = getattr(obj, name)

        def timed(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            try:
                return orig(*a, **k)
            finally:
                end.record()
                self.spans.append((name, start, end))

        self.patch(obj, name, timed)
