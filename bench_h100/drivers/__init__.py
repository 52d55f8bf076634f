"""How a cell drives the program: one driver a file, found by the name in the
mix file's ``driver`` key (``bench_h100/drivers/<name>.py``, whose
``DRIVER`` is the class).

- ``serve``: an in-process ``ContinuousBatcher`` at the mix's settings,
  requests submitted on their due times (open loop) by one thread, each
  stream drained by a thread of its own; TTFA and chunk gaps from each
  request's due time.
- ``stream``: one client in a closed loop on
  ``FasterQwen3TTS.generate_voice_clone_streaming``.
- ``batch``: a closed loop of ``generate_voice_clone_batch`` calls.

A driver is built on the model, the mix, the voices, whether the run is
traced and the seed; ``rows(mix)`` is the rows its engine runs, known
before the model is built.  ``setup(plan)`` captures and warms only what
that plan replays (its batch, its sampling policies); ``window(plan, t0,
seconds)`` runs the plan and returns one record a request (a batch row is a
request) with its host times, frames, audio, codes and the program's
timing dicts.  A closed loop starts requests while the window lasts, then
those that complete the cycle of sizes in flight, and lets the last one
finish: its window holds whole cycles, the same work a cycle at any speed.
Times are ``time.perf_counter`` seconds.
"""
from __future__ import annotations

import importlib
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

HOLD_EOS = 1 << 20  # min_new_tokens that keeps EOS off for any pinned length
DRAIN_S = 120.0


def load(name: str):
    """The driver class of ``drivers/<name>.py``."""
    if not (Path(__file__).parent / f"{name}.py").is_file() or name.startswith("_"):
        raise ValueError(f"no driver {name!r} in bench_h100/drivers/")
    return importlib.import_module(f"drivers.{name}").DRIVER


def policies(greedy: bool, min_new: int):
    """The talker's policy (codebook 0 greedy or sampled with the API's
    defaults) and the predictor's (always the API's sampler)."""
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy

    return (GenerationPolicy(do_sample=not greedy, min_new_tokens=min_new),
            SamplingPolicy(do_sample=True, top_k=50, top_p=1.0, temperature=0.9))


class Driver:
    @staticmethod
    def rows(mix: Dict) -> int:
        return 1

    def __init__(self, model, mix: Dict, voices: List[np.ndarray], trace: bool, seed: int):
        from taps import DeviceSpans

        self.model, self.mix, self.voices, self.trace, self.seed = model, mix, voices, trace, seed
        self.batch = self.rows(mix)
        self.sr = mix["voices"]["sample_rate"]
        self.lang = mix.get("language", "English")
        self.spans = DeviceSpans() if trace else None
        self.engine = None

    def _record_graphs(self, engine) -> None:
        """A traced run replays graphs of its own that log every replay."""
        from qwen3tts_tpu_torch.runtime.graphs import ChunkGraphs

        self.engine = engine
        if self.trace and engine.graphs is not None:
            engine.graphs = ChunkGraphs(engine, record=True)

    def _time_eager(self, engine) -> None:
        if self.spans is not None and engine.device.type == "cuda":
            self.spans.wrap(engine, "prefill")
            self.spans.wrap(engine, "join_row")
            self.spans.wrap(self.model.vocoder, "decode")

    def ref(self, voice: int):
        return (self.voices[voice], self.sr)

    def captures(self):
        """Chunk graphs captured so far, or None without graphs."""
        graphs = self.engine.graphs if self.engine is not None else None
        return None if graphs is None else graphs.captures

    def close(self) -> None:
        if self.spans is not None:
            self.spans.close()


class ClosedLoop(Driver):
    """A client that sends its next request when the last one ends, while
    the window lasts and then to the end of the plan's cycle in flight (the
    mix's ``frames.cycle`` sizes, ``traffic.plan``); ``_call`` serves one
    plan item and returns its request records.  A window that ended on the
    first request after its time would hold a share of a cycle that hangs
    on the speed: batch16's read 10 or 11 batches of sizes that differ
    threefold, and its rate parted by 5 % between them."""

    def _warm(self, plan: List[Dict], item: Dict) -> None:
        """``item`` once with each sampling policy the plan uses (each has
        chunk graphs of its own)."""
        for greedy in sorted({r["greedy"] for r in plan}, reverse=True):
            self._call(dict(item, greedy=greedy), time.perf_counter())

    def window(self, plan: List[Dict], t0: float, seconds: float) -> List[Dict]:
        cycle = self.mix["frames"]["cycle"]
        recs = []
        for i, item in enumerate(plan):
            now = time.perf_counter()
            if now - t0 >= seconds and i % cycle == 0:
                break
            recs.extend(self._call(item, now))
        return recs

    def close(self) -> None:
        super().close()
        self.codes.close()
