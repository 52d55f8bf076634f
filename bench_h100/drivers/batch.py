"""A closed loop of ``generate_voice_clone_batch`` calls of the mix's
``batch`` texts, non-streamed."""
from __future__ import annotations

import time
from typing import Dict, List

from drivers import ClosedLoop
from taps import BatchCodes


class BatchDriver(ClosedLoop):
    @staticmethod
    def rows(mix: Dict) -> int:
        return mix["batch"]

    def setup(self, plan: List[Dict]) -> None:
        self._record_graphs(self.model._batch_engine(self.batch))
        self.codes = BatchCodes()
        self._warm(plan, {"texts": ["warm up"] * self.batch, "voice": 0, "frames": 32})
        self._time_eager(self.engine)

    def _call(self, item: Dict, due: float) -> List[Dict]:
        n0 = len(self.codes.calls)
        err = None
        try:
            wavs, _sr = self.model.generate_voice_clone_batch(
                item["texts"], self.lang, self.ref(item["voice"]), "",
                max_new_tokens=item["frames"], min_new_tokens=item["frames"],
                do_sample=not item["greedy"])
        except Exception as exc:  # noqa: BLE001
            wavs, err = [None] * len(item["texts"]), repr(exc)
        end = time.perf_counter()
        rows, timing = self.codes.calls[n0] if len(self.codes.calls) > n0 else (None, None)
        return [{"text": t, "voice": item["voice"], "frames": item["frames"],
                 "greedy": item["greedy"], "due": due, "end": end, "error": err,
                 "chunks": [] if w is None else [(end, item["frames"], timing)],
                 "audio": [] if w is None else [w],
                 "codes": None if rows is None else rows[b], "batch_timing": timing}
                for b, (t, w) in enumerate(zip(item["texts"], wavs))]


DRIVER = BatchDriver
