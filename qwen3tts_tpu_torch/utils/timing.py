"""Timing and optional device profiling.

Port of ``qwen3tts_tpu/utils/timing.py``.  The loops return per-call timing
dicts bracketed by device synchronises; this module adds a stopwatch with
named laps, a ``torch.profiler`` trace around a generation
(``QWEN3TTS_PROFILE_DIR``, see ``device_trace``) and per-card memory
numbers for status endpoints.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

import torch

logger = logging.getLogger(__name__)


class Stopwatch:
    """Accumulating stopwatch with named laps."""

    def __init__(self):
        self.laps = {}
        self._t0 = time.time()

    def lap(self, name: str) -> float:
        now = time.time()
        dt = now - self._t0
        self.laps[name] = self.laps.get(name, 0.0) + dt
        self._t0 = now
        return dt

    def summary(self) -> str:
        total = sum(self.laps.values())
        parts = [f"{k}={v*1000:.1f}ms" for k, v in self.laps.items()]
        return f"{' '.join(parts)} total={total*1000:.1f}ms"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Wrap a generation in a ``torch.profiler`` trace (host and, on the
    card, CUDA activity) written to ``log_dir`` as a Chrome trace; a no-op
    when ``log_dir`` is empty.

    Trace eager runs only.  On the H100 the profiler lost kernel records of
    replayed CUDA graphs whose steps sit in conditional nodes (the captured
    chunks, ``runtime/graphs.py``), and a replay after such traces faulted
    with an illegal address (``python -m
    qwen3tts_tpu_torch.tools.graph_trace_probe --profile``).  So run the
    traced work inside ``Engine.eager()``, as ``FasterQwen3TTS`` does for
    ``QWEN3TTS_PROFILE_DIR``, or on an engine built with
    ``use_cuda_graphs=False``."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        logger.info("device trace written to %s", path)


def device_memory_stats() -> dict:
    """Per-card memory numbers for status endpoints, keyed by device
    (``cuda:0``, ...): the bytes the caching allocator holds for tensors
    now and at its peak, the card's free and total bytes.  Empty without a
    card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_free": free,
            "bytes_limit": total,
        }
    return out
