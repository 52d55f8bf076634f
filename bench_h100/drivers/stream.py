"""One client in a closed loop on
``FasterQwen3TTS.generate_voice_clone_streaming`` at the mix's
``chunk_size``."""
from __future__ import annotations

import time
from typing import Dict, List

from drivers import ClosedLoop
from taps import StreamCodes


class StreamDriver(ClosedLoop):
    def setup(self, plan: List[Dict]) -> None:
        self._record_graphs(self.model.engine)
        self.codes = StreamCodes()
        self._warm(plan, {"text": "warm up", "voice": 0, "frames": 16})
        self._time_eager(self.engine)

    def _call(self, item: Dict, due: float) -> List[Dict]:
        rec = dict(item, due=due, chunks=[], audio=[], error=None, end=None)
        n0 = len(self.codes.calls)
        try:
            for audio, _sr, timing in self.model.generate_voice_clone_streaming(
                    item["text"], self.lang, self.ref(item["voice"]), "",
                    max_new_tokens=item["frames"], min_new_tokens=item["frames"],
                    do_sample=not item["greedy"], chunk_size=self.mix["chunk_size"]):
                rec["chunks"].append((time.perf_counter(), timing["chunk_steps"], timing))
                rec["audio"].append(audio)
        except Exception as exc:  # noqa: BLE001
            rec["error"] = repr(exc)
        rec["end"] = time.perf_counter()
        rec["codes"] = self.codes.frames(n0) if len(self.codes.calls) > n0 else None
        return [rec]


DRIVER = StreamDriver
