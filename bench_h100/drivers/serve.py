"""Open loop through an in-process ``ContinuousBatcher`` at the mix's
``batcher`` settings; the mix's ``greedy_share`` is 0 or 1 (a batcher has
one sampling policy)."""
from __future__ import annotations

import threading
import time
from typing import Dict, List

from drivers import DRAIN_S, HOLD_EOS, Driver, policies
from taps import ServeCodes
from traffic import plan as make_plan


class ServeDriver(Driver):
    @staticmethod
    def rows(mix: Dict) -> int:
        return mix["batcher"]["max_batch"]

    def setup(self, plan: List[Dict]) -> None:
        from qwen3tts_tpu_torch.runtime.scheduler import ContinuousBatcher

        b = self.mix["batcher"]
        share = self.mix["greedy_share"]
        if share not in (0, 1):
            raise ValueError("a batcher has one sampling policy: greedy_share is 0 or 1")
        pol, ppol = policies(share == 1, HOLD_EOS)
        self._record_graphs(self.model._batch_engine(b["max_batch"]))
        self.batcher = ContinuousBatcher(
            self.model, max_batch=b["max_batch"], chunk_size=b["chunk_size"],
            max_new_tokens=self.mix["frames"]["max"], policy=pol, pred_policy=ppol,
            first_chunks=tuple(b["first_chunks"]))
        self.batcher.warmup(prefill_buckets=tuple(b["prefill_buckets"]), max_tth=b["max_tth"])
        self.codes = ServeCodes(self.batcher)
        # one full batch of short requests through every part of the path
        warm = [self.batcher.submit("warm up", self.lang, self.ref(i % len(self.voices)), "",
                                    max_new_tokens=self.mix["frames"]["min"])
                for i in range(b["max_batch"])]
        for h in warm:
            for _ in h.chunks():
                pass
        # then a few seconds of the cell's own traffic: the first window after
        # a set-up read 15-19 % apart across processes on chunk-gap p95, later
        # windows of one process 3.5 % (PERF.md)
        self.window(make_plan(self.mix, self.seed, self.mix["warm_s"]), time.perf_counter(),
                    self.mix["warm_s"])
        self._time_eager(self.engine)

    def window(self, plan: List[Dict], t0: float, seconds: float) -> List[Dict]:
        recs, threads = [], []
        spf = self.model.vocoder.spf

        def drain(handle, rec):
            try:
                for audio, _sr, timing in handle.chunks():
                    rec["chunks"].append((time.perf_counter(), len(audio) // spf, timing))
                    rec["audio"].append(audio)
            except Exception as exc:  # noqa: BLE001 -- a failed stream is counted
                rec["error"] = repr(exc)
            rec["end"] = time.perf_counter()

        for item in plan:
            due = t0 + item["due"]
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            rec = dict(item, due=due, chunks=[], audio=[], error=None, end=None)
            recs.append(rec)
            rec["submit0"] = time.perf_counter()
            try:
                handle = self.batcher.submit(item["text"], self.lang, self.ref(item["voice"]),
                                             "", max_new_tokens=item["frames"])
            except Exception as exc:  # noqa: BLE001
                rec["error"] = repr(exc)
                continue
            rec["submit1"] = time.perf_counter()
            rec["_req"] = handle._req
            th = threading.Thread(target=drain, args=(handle, rec), daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=max(1.0, t0 + seconds + DRAIN_S - time.perf_counter()))
        for rec in recs:
            req = rec.pop("_req", None)
            rec["codes"] = self.codes.of(req) if req is not None else None
        return recs

    def close(self) -> None:
        super().close()
        self.codes.close()
        self.batcher.close()


DRIVER = ServeDriver
