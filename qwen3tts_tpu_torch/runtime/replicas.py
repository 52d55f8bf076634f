"""Data-parallel serving: one model replica per device behind one
``submit()``.

Port of ``qwen3tts_tpu/runtime/replicas.py`` over torch devices:

  * the weights are copied once per device (``FasterQwen3TTS.replicate_to``:
    host-side helpers are shared, device state is the replica's own);
  * each replica runs its own ContinuousBatcher (``runtime/scheduler.py``);
  * ``submit()`` routes each request to the live replica with the fewest
    requests in flight (round-robin on a tie), counted from submits and
    ``served``: no coordination between devices;
  * a replica whose worker died is seen through ``ContinuousBatcher.alive``
    and routed around; the pool fails only when none is left.

On a one-card machine the pool holds one replica.  The source model serves
the first entry of ``devices`` that is its own device; every other entry
gets a replica, so two entries naming one device are two replicas (two
batchers never share an engine: its captured graphs are one thread's).
"""
from __future__ import annotations

import contextlib
import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..models.predictor import SamplingPolicy
from .engine import GenerationPolicy
from .scheduler import ContinuousBatcher, StreamHandle

logger = logging.getLogger(__name__)


def local_devices() -> List[torch.device]:
    """The cards of this host (``cuda:0``, ...); none without one."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class ReplicaPool:
    """N independent (model, ContinuousBatcher) replicas with least-loaded
    routing.  Has the batcher surface the server uses (``submit``,
    ``arriving``, ``stats``, ``warmup``, ``close``)."""

    def __init__(
        self,
        model,
        devices: Optional[Sequence] = None,
        *,
        max_batch: int = 4,
        chunk_size: int = 8,
        max_new_tokens: int = 2048,
        policy: Optional[GenerationPolicy] = None,
        pred_policy: Optional[SamplingPolicy] = None,
        first_chunks: Tuple[int, ...] = (),
    ):
        self.devices = [torch.device(d) for d in
                        (devices if devices is not None else local_devices())]
        if not self.devices:
            raise ValueError("ReplicaPool needs at least one device")
        self.models = []
        for i, dev in enumerate(self.devices):
            if _same_device(dev, model.device) and all(m is not model for m in self.models):
                self.models.append(model)  # the weights already live there
            else:
                logger.info("replicating model to %s", dev)
                self.models.append(model.replicate_to(dev, seed=i + 1))
        self.batchers: List[ContinuousBatcher] = [
            ContinuousBatcher(
                m, max_batch=max_batch, chunk_size=chunk_size,
                max_new_tokens=max_new_tokens, policy=policy,
                pred_policy=pred_policy, first_chunks=first_chunks)
            for m in self.models
        ]
        self._submits = [0] * len(self.batchers)
        self._rr = 0
        self._lock = threading.Lock()
        self._reported_dead: set = set()

    # ------------------------------------------------------------------

    def _inflight(self, i: int) -> int:
        st = self.batchers[i]._stats
        return max(0, self._submits[i] - st["served"])

    def _live(self) -> List[int]:
        """Indices of replicas whose worker is serving.  A dead worker is
        reported once and routed around; its requests in flight fail
        through their stream handles."""
        live = []
        for i, b in enumerate(self.batchers):
            if b.alive:
                live.append(i)
            elif i not in self._reported_dead:
                self._reported_dead.add(i)
                logger.error("replica %d (%s) is dead; routing around it", i, self.devices[i])
        return live

    @contextlib.contextmanager
    def arriving(self):
        """Advertise a request to every replica's burst collector
        (``ContinuousBatcher.arriving``): routing happens at submit, so
        until then any replica may receive it."""
        with contextlib.ExitStack() as stack:
            for b in list(self.batchers):
                stack.enter_context(b.arriving())
            yield

    def submit(self, *args, **kwargs) -> StreamHandle:
        """Route to the least-loaded live replica (``ContinuousBatcher.submit``'s
        signature)."""
        n = len(self.batchers)
        for _ in range(n):  # again if a replica dies while routing
            with self._lock:
                live = self._live()
                if not live:
                    raise RuntimeError(f"all {n} replicas are dead (see earlier logs)")
                order = [(self._inflight(i), (i - self._rr) % n, i) for i in live]
                i = min(order)[2]
                self._submits[i] += 1
                self._rr = (i + 1) % n
            try:
                return self.batchers[i].submit(*args, **kwargs)
            except RuntimeError:
                if self.batchers[i].alive:
                    raise  # a genuine submit error, not a dead replica
                with self._lock:  # died between routing and submit: reroute
                    self._submits[i] -= 1
        raise RuntimeError(f"all {n} replicas are dead (see earlier logs)")

    @property
    def stats(self) -> Dict:
        per = [b.stats for b in self.batchers]
        agg = {k: sum(s[k] for s in per)
               for k in ("served", "joined_mid_batch", "batches", "cancelled",
                         "active_rows", "queue_depth", "retired_predictively")}
        agg["replicas"] = [
            dict(s, device=str(d), inflight=self._inflight(i), alive=self.batchers[i].alive)
            for i, (s, d) in enumerate(zip(per, self.devices))
        ]
        return agg

    def warmup(self, prefill_buckets=(128,), max_tth: Optional[int] = None):
        """Capture every replica's batch graphs, one replica after another."""
        for i, b in enumerate(self.batchers):
            logger.info("warming replica %d/%d (%s)", i + 1, len(self.batchers),
                        self.devices[i])
            b.warmup(prefill_buckets=prefill_buckets, max_tth=max_tth)

    def close(self, timeout: float = 30.0):
        for b in self.batchers:
            b.close(timeout=timeout)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name one card when 0 is the current one."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == (b.index if b.index is not None else cur)
