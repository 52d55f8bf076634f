"""Continuous batching: requests admitted into one batched Engine while it
runs.

Port of ``qwen3tts_tpu/runtime/scheduler.py``.  A worker thread owns the
card and runs ONE batched engine (``FasterQwen3TTS._batch_engine``);
requests are admitted into free batch rows *while the batch is running*
(``Engine.join_row`` splices a one-row prefill into the shared KV cache at a
chunk boundary), stream their audio independently, and retire at their own
EOS.  Aggregate frames/s grows with occupancy while a request's latency
stays near that of the batch.

Each chunk is one captured decode + batched vocode graph
(``Engine.chunk_vocode_batched``, ``runtime/graphs.py``), replayed on the
batch's KV cache; the state is updated in place, so joins, a row forced
done and the joiner's trailing text and tts_pad embedding are written into
the one live state (and the batch's input tensors, whose version counters
tell the graphs to copy them in again) before the next dispatch.  Up to
``QWEN3TTS_BATCH_PIPELINE`` chunks are in flight; each chunk's outputs
(``n``, ``lens``, the audio and the ``done`` flags) are copied to pinned
host memory right after its replay, before a later replay of the same graph
overwrites them (``loops.HostCopy``).  The host tracks the position from
the chunks it has read (``pos_lb``) and books the dispatched ones
(``Engine.settle``); a join is checked against ``pos_lb``.  ``warmup``
captures every graph the batcher replays, so that no request waits on a
capture; a capture is thread-local, so a server thread running the speaker
encoder meanwhile neither breaks it nor is refused.

Sampling knobs (temperature/top-k/penalty) and greedy/sampled are fixed per
batcher; the batcher samples from its own generator, seeded from the
model's.  Per-request texts, voices, prompt lengths and EOS times are
independent.  Joins are eager, so no join waits for a program to be built
(the JAX batcher's background join compiles have no counterpart).

A request's clock (``time.perf_counter``) starts when ``submit`` is entered,
before its prompt is built, so ``queue_ms`` and ``ttfa_ms`` count the
prompt.  While the tracer is on (``utils/timing.py:TRACE``) a served
request's spans carry its own request id: ``prompt`` (in ``submit``) and
``join`` (a mid-batch admission); a batch's carry the batch's:
``batch_setup`` (children ``embeds``, ``prefill``, ``tth``, ``vocinit``,
``prime``), and per chunk ``dispatch``, ``fetch`` (the read of the oldest
chunk in flight) and ``emit`` (its audio handed to the rows' queues, the
retirements and the admissions decided).  ``stats`` counts the joins into
running batches (``joined_mid_batch``) and gives the batch's shared cache
position through the last chunk read (``batch_pos``) and the furthest any
batch got (``max_batch_pos``): at ``max_seq_len - 1`` a batch ends with its
rows cut short.
"""
from __future__ import annotations

import contextlib
import hashlib
import logging
import os
import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, Generator, List, Optional, Tuple

import numpy as np
import torch

from ..models.predictor import SamplingPolicy
from ..utils.timing import TRACE
from .engine import PREFILL_BUCKETS, TTH_BUCKETS, Engine, GenerationPolicy, bucket_for, upload
from .loops import HostCopy

logger = logging.getLogger(__name__)

_SENTINEL = object()

# per-request audio queue depth and how long a full queue may stall the
# worker before the stream is failed (module-level so tests can shrink them)
OUT_QUEUE_SIZE = 64
EMIT_TIMEOUT_S = 5.0

# Out-of-order admission scan depth: how many waiting requests are
# considered for a free row.  FIFO order is preferred, but a request whose
# prompt bucket exceeds the batch's current position must not block the
# admissible requests behind it.
ADMIT_SCAN = 16

# Batch-start burst collection: when >= 2 requests are already waiting as a
# batch forms (a concurrent burst), the worker keeps collecting briefly: a
# batch that starts full prefills every row at once and skips the
# position-gated join path.  The refresh window scales with the number
# waiting (n waiting: n + 1 windows), capped overall; a single waiting
# request with no arrival advertised (``arriving()``) starts at once.
START_WINDOW_S = float(os.environ.get("QWEN3TTS_BATCH_START_WINDOW", "0.02"))
START_WINDOW_CAP_S = float(os.environ.get("QWEN3TTS_BATCH_START_CAP", "0.6"))

# Post-join TTFA ramp: after a join the ``first_chunks`` ramp runs again only
# when some joiner waited less than this in the queue.  A joiner that queued
# longer is saturated traffic: the ramp saves it a few steps of a TTFA that
# queueing already made long, while every small chunk slows every row.
RAMP_FRESH_S = float(os.environ.get("QWEN3TTS_RAMP_FRESH", "0.25"))

# Chunks in flight by default (QWEN3TTS_BATCH_PIPELINE overrides it per
# batch).  On the H100 depths 1 and 3 served 8 saturating 96-step requests
# at B 4 alike, the card 94-96 % busy either way (chip_smoke.py's
# slice-serve depth sweep, PERF.md): one chunk ahead covers the host's read
# and dispatch, and a row forced done overshoots by at most one chunk.
PIPELINE_DEPTH = 1


@dataclass
class _Request:
    embeds: np.ndarray  # [1, T, H]
    trailing: np.ndarray  # [1, Tt, H]
    tpe: np.ndarray  # [1, 1, H]
    ref_codes: Optional[np.ndarray]
    max_new_tokens: int
    out_q: "queue.Queue" = field(
        default_factory=lambda: queue.Queue(maxsize=OUT_QUEUE_SIZE))
    submitted_at: float = field(default_factory=time.perf_counter)  # submit entered
    started_at: float = 0.0
    rid: Optional[int] = None  # the tracer's request id
    steps: int = 0
    chunk_index: int = 0
    cancelled: bool = False
    # predictive budget retirement: dispatched-step upper bound and the
    # "this row is certainly retiring by its in-flight chunk's fetch" flag
    planned: int = 0
    retiring: bool = False
    # uploads started at admission (pinned, asynchronous), so the join at
    # the tail finds them on the card: the prompt left-padded on the host to
    # its bucket (``join_pad`` the inner pad) and the trailing-text row at
    # the batch's width
    embeds_dev: Optional[torch.Tensor] = None
    join_pad: int = 0
    tth_row_dev: Optional[torch.Tensor] = None


class StreamHandle:
    """Client-side handle: iterate ``chunks()`` for (audio, sr, timing)."""

    def __init__(self, req: _Request, sr: int):
        self._req = req
        self._sr = sr

    def chunks(self) -> Generator[Tuple[np.ndarray, int, dict], None, None]:
        while True:
            item = self._req.out_q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, Exception):
                raise item
            audio, timing = item
            if audio.dtype == np.int16:  # pcm16 wire: restore f32 here,
                audio = audio.astype(np.float32) / 32767.0  # off the hot loop
            yield audio, self._sr, timing

    def cancel(self):
        """Best-effort: the row finishes its current chunk then is retired."""
        self._req.cancelled = True


class ContinuousBatcher:
    """Worker-thread scheduler over one batched Engine.

    ``submit`` builds the prompt on the caller's thread (host numpy), then
    enqueues; the worker starts a batch when idle, joins requests into free
    rows at chunk boundaries while running, and pushes per-row audio chunks
    to each request's queue.
    """

    def __init__(
        self,
        model,
        max_batch: int = 4,
        chunk_size: int = 8,
        max_new_tokens: int = 2048,
        policy: Optional[GenerationPolicy] = None,
        pred_policy: Optional[SamplingPolicy] = None,
        first_chunks: Tuple[int, ...] = (),
    ):
        self.model = model
        self.B = max_batch
        self.chunk_size = chunk_size
        # TTFA ramp (the loops' first_chunks): after a batch starts and
        # after a mid-batch join the next dispatches use these smaller chunk
        # sizes before settling at ``chunk_size``; all rows share each
        # dispatch's size
        self.first_chunks = tuple(first_chunks)
        self.max_new_tokens = max_new_tokens
        self.policy = policy or GenerationPolicy()
        self.pred_policy = pred_policy or SamplingPolicy()
        self.engine: Engine = model._batch_engine(max_batch)
        dev = self.engine.device
        # the batcher's own generator, seeded from the model's (a draw, so
        # two batchers of one model differ): the API's requests on other
        # threads keep theirs
        seed = int(torch.randint(2**62, (1,), generator=model._gen, device=dev).item())
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        # fetch audio as PCM16 made on the card (QWEN3TTS_SERVE_PCM16=0 to
        # disable): half the bytes to the host, every endpoint ships 16-bit,
        # and StreamHandle restores float32 on the consumer's thread
        self._pcm16 = os.environ.get("QWEN3TTS_SERVE_PCM16", "1") == "1"
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        # primed single-row codec stream states keyed by voice (ref codes
        # content): admitting a repeat voice is a device-side row copy
        self._voice_states: "OrderedDict[object, object]" = OrderedDict()
        self._voice_cache_cap = 8
        self._stop = threading.Event()
        self._stats = {"served": 0, "joined_mid_batch": 0, "batches": 0,
                       "cancelled": 0, "active_rows": 0,
                       "retired_predictively": 0, "batch_pos": 0, "max_batch_pos": 0}
        # arrivals advertised via ``arriving()`` but not yet submitted
        self._incoming = 0
        self._incoming_lock = threading.Lock()
        # popped from _pending, not yet admitted (worker thread only)
        self._waiting: List[_Request] = []
        self._warmed_buckets: set = set()
        self._warned: set = set()
        self._tth_floor = 0
        self._worker = threading.Thread(
            target=self._run, name="continuous-batcher", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    # client side
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def arriving(self):
        """Advertise a request BEFORE its host-side prompt prep, so that the
        batch-start collector keeps collecting (up to START_WINDOW_CAP_S)
        while any advertised arrival has not submitted yet: a concurrent
        flood then starts its batch full instead of paying one
        position-gated join per straggler.  Costs nothing at light load."""
        with self._incoming_lock:
            self._incoming += 1
        try:
            yield
        finally:
            with self._incoming_lock:
                self._incoming -= 1

    def submit(
        self,
        text: str,
        language: str,
        ref_audio,
        ref_text: str,
        *,
        xvec_only: bool = True,
        non_streaming_mode: bool = True,
        append_silence: bool = True,
        instruct: Optional[str] = None,
        max_new_tokens: Optional[int] = None,
    ) -> StreamHandle:
        submitted_at = time.perf_counter()
        if self._stop.is_set():
            raise RuntimeError("batcher is closed")
        if not self._worker.is_alive():
            # the worker died (logged by _run): nothing would ever drain
            # _pending again (ReplicaPool routes around a dead batcher)
            raise RuntimeError("batcher worker is dead (see earlier log)")
        rid = TRACE.new_request()
        with TRACE.scope(rid):
            embeds, trailing, tpe, ref_codes = self.model._prepare_clone(
                text, ref_audio, ref_text, language, xvec_only,
                non_streaming_mode, append_silence, instruct)
        req = _Request(
            embeds=np.asarray(embeds, np.float32),
            trailing=np.asarray(trailing, np.float32),
            tpe=np.asarray(tpe, np.float32),
            ref_codes=np.asarray(ref_codes) if ref_codes is not None and len(ref_codes) else None,
            max_new_tokens=min(max_new_tokens or self.max_new_tokens,
                               self.max_new_tokens),
            submitted_at=submitted_at, rid=rid,
        )
        self._pending.put(req)
        if not self._worker.is_alive():
            # the worker died between the check above and the put: its drain
            # may have run already (the consumer reads the first item only)
            req.out_q.put(RuntimeError("batcher worker is dead (see earlier log)"))
        return StreamHandle(req, self.model.sample_rate)

    def close(self, timeout: float = 30.0):
        self._stop.set()
        self._pending.put(_SENTINEL)  # wake the worker
        self._worker.join(timeout=timeout)

    @property
    def alive(self) -> bool:
        """True while the worker thread is serving (False after close() or a
        failure of the worker itself)."""
        return self._worker.is_alive() and not self._stop.is_set()

    @property
    def stats(self) -> Dict:
        return dict(self._stats,
                    queue_depth=self._pending.qsize() + len(self._waiting))

    # ------------------------------------------------------------------
    # worker side
    # ------------------------------------------------------------------

    def _drain_arrivals(self) -> None:
        """Move every already-arrived request from _pending into _waiting
        (never blocks).  Worker thread only."""
        while True:
            try:
                nxt = self._pending.get_nowait()
            except queue.Empty:
                return
            if nxt is _SENTINEL:
                self._stop.set()
                return
            self._waiting.append(nxt)

    def _collect_start_burst(self) -> None:
        """Before starting a batch: if a burst is evident (>= 2 requests
        waiting, or arrivals advertised via ``arriving()`` still preparing),
        keep collecting briefly so that the batch starts as full as
        possible.  The window refreshes on each arrival, scales with the
        number waiting and is capped overall; a lone request with nothing
        advertised starts with no added latency."""
        deadline = time.perf_counter() + START_WINDOW_CAP_S
        while len(self._waiting) < self.B and not self._stop.is_set():
            try:
                nxt = self._pending.get_nowait()
            except queue.Empty:
                burst = len(self._waiting) >= 2 or self._incoming > 0
                if not burst or START_WINDOW_S <= 0:
                    return
                wait = min(START_WINDOW_S * (len(self._waiting) + 1),
                           deadline - time.perf_counter())
                if wait <= 0:
                    return
                try:
                    nxt = self._pending.get(timeout=wait)
                except queue.Empty:
                    if self._incoming > 0 and time.perf_counter() < deadline:
                        continue  # advertised arrivals still preparing
                    return  # no new arrival inside the refresh window
            if nxt is _SENTINEL:
                self._stop.set()
                return
            self._waiting.append(nxt)

    def _run(self):
        batch: List[_Request] = []  # popped but not yet served
        try:
            while not self._stop.is_set():
                if not self._waiting:
                    first = self._pending.get()
                    if first is _SENTINEL or self._stop.is_set():
                        break
                    self._waiting.append(first)
                self._collect_start_burst()
                batch = self._waiting[: self.B]
                del self._waiting[: self.B]
                self._serve_batch(batch)
                batch = []
        except Exception:  # the worker itself failed: fail every stream it holds
            logger.exception("batcher worker died")
            self._stop.set()  # alive -> False before the drain, not after
            for req in batch + self._waiting:
                req.out_q.put(RuntimeError("batcher worker died"))
            self._waiting = []
            while True:
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    break
                if req is not _SENTINEL:
                    req.out_q.put(RuntimeError("batcher worker died"))
        finally:
            for req in self._waiting:  # terminate never-started streams
                req.out_q.put(_SENTINEL)
            self._waiting = []
            while True:  # drain: end anything still queued at shutdown
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    break
                if req is not _SENTINEL:
                    req.out_q.put(_SENTINEL)

    # ---- batch lifecycle

    def _serve_batch(self, initial: List[_Request]):
        """Run one batch to completion.  A failure fails every request the
        batch owns (live rows and admitted-but-not-yet-joined ones): a
        stream that hangs is worse than one that raises.  The worker
        survives to serve the next batch."""
        rows: List[Optional[_Request]] = [None] * self.B
        for i, req in enumerate(initial):
            rows[i] = req
        admitted: List[_Request] = []  # popped from _pending, not yet in rows
        try:
            self._serve_batch_inner(rows, initial, admitted)
        except Exception as exc:  # noqa: BLE001 -- deliver, don't hang
            logger.exception("batch serving failed")
            victims = {id(r): r for r in rows + admitted if r is not None}
            for req in victims.values():
                self._fail(req, RuntimeError(f"batch serving failed: {exc!r}"))

    def _serve_batch_inner(self, rows: List[Optional[_Request]],
                           initial: List[_Request],
                           admitted: List[_Request]):
        eng, B = self.engine, self.B
        H = self.model.cfg.talker.hidden_size
        self._stats["batches"] += 1
        state = None
        with TRACE.scope(TRACE.new_request()):
            try:
                with TRACE.span("batch_setup"):
                    # --- stacked initial prefill: rows left-padded on the host
                    #     to the bucket with their own pad counts; unused rows
                    #     are fully padded and marked done.  When requests are
                    #     already waiting, the position starts at the largest
                    #     bucket they need, so that each can join the moment a
                    #     row frees.
                    with TRACE.span("embeds"):
                        T = max(r.embeds.shape[1] for r in initial)
                        self._drain_arrivals()
                        need = max((bucket_for(r.embeds.shape[1]) for r in self._waiting),
                                   default=0)
                        Tb = max(bucket_for(T), need)
                        self._check_warmed(Tb)
                        embeds = np.zeros((B, Tb, H), np.float32)
                        pads = np.full((B,), Tb, np.int64)
                        for i, req in enumerate(initial):
                            L = req.embeds.shape[1]
                            pads[i] = Tb - L
                            embeds[i, Tb - L:] = req.embeds[0]
                    with TRACE.span("prefill"):
                        state = eng.prefill(embeds, self.generator, self.policy,
                                            self.pred_policy, pad_count=pads,
                                            pos_floor=need if need else None)
                    batch = self._batch_inputs(state, initial)
                self._serve_rows(state, rows, admitted, *batch)
            finally:
                if state is not None:
                    eng.release(state)  # its cache keeps the graphs for the next batch
                self._stats["active_rows"] = 0
                self._stats["batch_pos"] = 0

    def _batch_inputs(self, state: Dict, initial: List[_Request]):
        """The batch's trailing text [B, W, H], tts_pad embeddings and
        trailing-text lengths on the card, and its codec stream state with
        each initial row primed.  The width starts at the warmed floor, so a
        joiner inside it is a row write into the same tensor (the graphs see
        it by its version counter) and replays a warmed graph."""
        eng, B = self.engine, self.B
        dev, dt = eng.device, eng.dtype
        H = self.model.cfg.talker.hidden_size
        if len(initial) < B:
            with torch.inference_mode():
                state["done"][len(initial):] = True
        with TRACE.span("tth"):
            tth_w = max(bucket_for(max(max(r.trailing.shape[1] for r in initial), 1),
                                   TTH_BUCKETS), self._tth_floor)
            tth = np.zeros((B, tth_w, H), np.float32)
            tth_lens = np.zeros((B,), np.int64)
            tpe = np.zeros((B, 1, H), np.float32)
            for i, req in enumerate(initial):
                L = req.trailing.shape[1]
                tth[i, :L] = req.trailing[0]
                tth[i, L:] = req.tpe[0]
                tth_lens[i] = L
                tpe[i] = req.tpe[0]
            tth_dev = upload(tth, dev, dt)
            tpe_dev = upload(tpe, dev, dt)
            tth_lens_dev = upload(tth_lens, dev, torch.int64)
        # one batched codec stream state for the whole batch: each row's
        # chunk is vocoded in the chunk's graph; an admission copies a primed
        # single-row state into its row
        voc = self.model.vocoder
        with TRACE.span("vocinit"):
            voc_state = voc.stream_state_batched(B)
        with TRACE.span("prime"):
            for i, req in enumerate(initial):
                voc_state = voc.scatter_stream_row(voc_state, self._primed_state(req), i)
        for req in initial:
            self._start_request(req)
        return tth_dev, tpe_dev, tth_lens_dev, voc_state

    def _serve_rows(self, state: Dict, rows: List[Optional[_Request]],
                    admitted: List[_Request], tth_dev: torch.Tensor, tpe_dev: torch.Tensor,
                    tth_lens_dev: torch.Tensor, voc_state):
        eng, B = self.engine, self.B
        dev, dt = eng.device, eng.dtype
        H = self.model.cfg.talker.hidden_size
        pos = state["pos_host"]
        voc = self.model.vocoder
        spf = voc.spf

        # --- pipelined chunk loop.  Up to ``depth`` chunks are in flight;
        # each one's outputs start their copy to pinned host memory right
        # after its replay.  Mutations (joins, forced done) are written into
        # the live state before the next dispatch: the state and the
        # pipeline tail are one.  Two occupancy views: ``row_owner`` is
        # occupancy at the tail (set at join, cleared at retirement) and
        # drives admission; ``rows`` is occupancy as the chunk being READ
        # sees it (a join becomes visible with the first chunk dispatched
        # after it: each queue entry carries its activations).  A chunk
        # dispatched after its rows are done runs no step; a budget- or
        # cancel-forced row runs at most ``depth`` chunks before the force
        # lands, and its frames are trimmed at emission.
        limit = eng.max_seq_len - 1
        depth = max(1, int(os.environ.get("QWEN3TTS_BATCH_PIPELINE", str(PIPELINE_DEPTH))))
        deferred_joins: List[Tuple[int, _Request]] = []
        pending_force = np.zeros((B,), bool)
        row_owner: List[Optional[_Request]] = list(rows)
        q: deque = deque()
        cur_voc = voc_state
        pos_lb = pos  # position through the last chunk READ
        activations: List[Tuple[int, _Request]] = []  # joins awaiting their first chunk
        ramp: List[int] = list(self.first_chunks)  # upcoming dispatch sizes
        captures = eng.graphs.captures if eng.graphs is not None else 0

        def dispatch_one():
            nonlocal cur_voc, activations, captures
            size = ramp.pop(0) if ramp else self.chunk_size
            before = state["pos_host"]
            with TRACE.span("dispatch"):
                _, _frames, n, lens, done, audio, cur_voc = eng.chunk_vocode_batched(
                    voc, state, tth_dev, tth_lens_dev, tpe_dev, size, cur_voc,
                    pcm16=self._pcm16)
                q.append((HostCopy([n, lens, audio, done]), activations))
            booked = state["pos_host"] - before
            activations = []
            if eng.graphs is not None and eng.graphs.captures != captures:
                captures = eng.graphs.captures
                self._warn_once(("chunk", size, tth_dev.shape[1]),
                                "chunk %d at trailing-text width %d was captured at serve "
                                "time, every live stream waiting: warmup() did not cover it",
                                size, tth_dev.shape[1])
            # --- predictive budget retirement: this chunk takes each live
            # tail row to ``planned`` steps (an upper bound: an EOS only
            # retires it sooner).  A row whose budget an in-flight chunk
            # exhausts frees its tail slot now, so its replacement joins
            # before that chunk is read; the frames are still emitted at
            # the read (via ``rows``), and the force stops the card from
            # stepping the row past this chunk.
            for b in range(B):
                r = row_owner[b]
                if r is None or r.retiring:
                    continue
                r.planned += booked
                if r.planned >= r.max_new_tokens:
                    r.retiring = True
                    pending_force[b] = True
                    row_owner[b] = None
                    self._stats["retired_predictively"] += 1

        dispatch_one()
        while True:
            # --- mutations decided at the previous read, into the live
            # state.  Force-done lands before joins, so a join into a row
            # whose previous occupant was forced resets its done flag.
            if pending_force.any():
                with torch.inference_mode():
                    for fb in np.nonzero(pending_force)[0]:
                        state["done"][int(fb)] = True
                pending_force[:] = False
            for b, req in deferred_joins:
                with TRACE.span("join", rid=req.rid):
                    eng.join_row(state, b, req.embeds_dev, policy=self.policy,
                                 pred_policy=self.pred_policy, pos_hint=pos_lb,
                                 pad_inner=req.join_pad)
                    req.embeds_dev = None
                    L = req.trailing.shape[1]
                    if L > tth_dev.shape[1]:  # widen the batch's trailing text
                        new_w = bucket_for(L, TTH_BUCKETS)
                        tth_dev = torch.cat(
                            [tth_dev, tpe_dev.expand(B, new_w - tth_dev.shape[1], H)], dim=1)
                    # the pre-uploaded row fits unless a join widened the batch since
                    if req.tth_row_dev is None or req.tth_row_dev.shape[0] != tth_dev.shape[1]:
                        req.tth_row_dev = upload(self._tth_row(req, tth_dev.shape[1]), dev, dt)
                    tth_dev[b].copy_(req.tth_row_dev)
                    req.tth_row_dev = None
                    tpe_dev[b].copy_(upload(req.tpe[0], dev, dt))
                    tth_lens_dev[b] = L
                    # reset and prime the row's slice of the batch's codec
                    # stream (its first frames come in the chunk dispatched next)
                    cur_voc = voc.scatter_stream_row(cur_voc, self._primed_state(req), b)
                row_owner[b] = req
                activations.append((b, req))
                self._stats["joined_mid_batch"] += 1
                self._start_request(req)
            if deferred_joins and self._ramp_after_join([req for _, req in deferred_joins]):
                ramp[:] = self.first_chunks  # joiner TTFA: run the ramp again
            deferred_joins = []

            # --- keep the pipeline full.  Growth is bounded per iteration so
            # that the oldest chunk's read (someone's TTFA) is not starved
            # behind a dispatch burst; dispatch stops at the window's end or
            # when nothing is live at the tail.
            grown = 0
            while (len(q) <= depth and grown < 2 and state["pos_host"] < limit
                   and any(r is not None for r in row_owner)):
                dispatch_one()
                grown += 1
            if not q:
                break  # nothing in flight, nothing live to dispatch

            # --- read the oldest chunk in flight
            with TRACE.span("fetch"):
                copy, acts = q.popleft()
                for b, req in acts:  # joins visible from this chunk on
                    rows[b] = req
                    admitted.remove(req)
                n_val, lens_np, audio_np, row_done = copy.get()
                n_val = int(n_val)
                eng.settle(state, n_val)
                pos_lb += n_val
            self._stats["batch_pos"] = pos_lb
            self._stats["max_batch_pos"] = max(self._stats["max_batch_pos"], pos_lb)

            with TRACE.span("emit"):
                # --- emit each row's audio; retire rows at EOS / budget.  Row
                # b's valid samples are the prefix ``lens[b] * spf`` (the codec
                # is causal).
                retires: List[int] = []
                for b in range(B):
                    req = rows[b]
                    if req is None:
                        continue
                    valid = int(lens_np[b])
                    if req.cancelled:
                        valid = 0
                    take = min(valid, req.max_new_tokens - req.steps)
                    if take > 0:
                        req.steps += take  # counted at decode time (budget)
                        # pcm16 buffers go out as int16 and become float32 on
                        # the consumer's thread (StreamHandle.chunks)
                        self._deliver(req, audio_np[b, : take * spf], take)
                    over_budget = req.steps >= req.max_new_tokens
                    if bool(row_done[b]) or over_budget or req.cancelled:
                        if req.cancelled:
                            self._stats["cancelled"] += 1
                        if not bool(row_done[b]) and not req.retiring:
                            # over budget or cancelled: mark it done on the card
                            # too, before the next dispatch.  A predictively
                            # retired row was forced when its slot was freed;
                            # forcing again could kill the slot's new occupant.
                            pending_force[b] = True
                        retires.append(b)
                for b in retires:
                    req = rows[b]
                    self._finish_request(req)
                    rows[b] = None
                    if row_owner[b] is req:
                        row_owner[b] = None  # slot reusable at the tail
                    # else: predictive retirement freed the slot at dispatch and
                    # a new request may own it already

                # --- decide admissions; they join before the next dispatch
                for b in range(B):
                    if row_owner[b] is not None or any(jb == b for jb, _ in deferred_joins):
                        continue
                    req = self._peek_admissible(pos_lb, state["pos_host"], limit)
                    if req is None:
                        break
                    # start the joiner's uploads now (pinned, asynchronous): the
                    # prompt padded on the host to its bucket, the trailing-text
                    # row at the batch's width
                    Lp = req.embeds.shape[1]
                    req.join_pad = bucket_for(Lp) - Lp
                    padded = np.concatenate(
                        [np.zeros((1, req.join_pad, H), np.float32), req.embeds],
                        axis=1) if req.join_pad else req.embeds
                    req.embeds_dev = upload(padded, dev, dt)
                    if req.trailing.shape[1] <= tth_dev.shape[1]:
                        req.tth_row_dev = upload(self._tth_row(req, tth_dev.shape[1]), dev, dt)
                    deferred_joins.append((b, req))
                    admitted.append(req)
            self._stats["active_rows"] = sum(r is not None for r in rows)
            if not any(r is not None for r in row_owner) \
                    and not any(r is not None for r in rows) \
                    and not deferred_joins and not admitted:
                # batch over.  Chunks still in flight carry no deliverable
                # frames (done rows run no step; forced rows' frames are over
                # budget).  ``rows`` (a retiring row's frames in flight) and
                # ``admitted`` (a joiner whose first chunk is in flight) must
                # be empty too, or audio would be dropped and a client hung.
                break

        # --- wind-down.  A request still owned at the tail hit the window's
        # end (the batch-1 truncation contract).
        for b in range(B):
            if row_owner[b] is not None:
                self._finish_request(row_owner[b])
                rows[b] = None
                row_owner[b] = None
        # admitted-but-never-joined requests seed the NEXT batch
        for _, req in deferred_joins:
            admitted.remove(req)
        self._waiting[:0] = [req for _, req in deferred_joins]

    # ---- per-request helpers

    @staticmethod
    def _tth_row(req: _Request, width: int) -> np.ndarray:
        """The request's trailing text [width, H], padded with its tts_pad
        embedding."""
        row = np.tile(req.tpe[0], (width, 1))
        row[: req.trailing.shape[1]] = req.trailing[0]
        return row

    def _start_request(self, req: _Request):
        req.started_at = time.perf_counter()

    def _ramp_after_join(self, joined: List[_Request]) -> bool:
        """Run the TTFA ramp again only when some joiner is
        latency-dominated (queue wait under RAMP_FRESH_S)."""
        if not self.first_chunks:
            return False
        return any(r.started_at - r.submitted_at < RAMP_FRESH_S for r in joined)

    def _primed_state(self, req: _Request):
        """Single-row codec stream state primed with the request's ICL
        reference codes, LRU-cached per voice.  ``scatter_stream_row`` reads
        it and leaves it intact."""
        voc = self.model.vocoder
        if req.ref_codes is None:
            key = None
        else:
            c = np.ascontiguousarray(req.ref_codes, np.int32)
            key = (c.shape, hashlib.sha1(c.tobytes()).hexdigest())
        st = self._voice_states.get(key)
        if st is None:
            st = voc.stream_state()
            if req.ref_codes is not None:
                _, st = voc.stream_feed(st, req.ref_codes, collect_audio=False)
            self._voice_states[key] = st
            while len(self._voice_states) > self._voice_cache_cap:
                self._voice_states.popitem(last=False)
        else:
            self._voice_states.move_to_end(key)
        return st

    def _deliver(self, req: _Request, audio: np.ndarray, n_frames: int):
        timing = {
            "chunk_index": req.chunk_index,
            "chunk_steps": n_frames,
            "total_steps_so_far": req.steps,
            "is_final": False,
            "queue_ms": (req.started_at - req.submitted_at) * 1000.0,
        }
        if req.chunk_index == 0:
            timing["ttfa_ms"] = (time.perf_counter() - req.submitted_at) * 1000.0
        req.chunk_index += 1
        try:
            req.out_q.put((audio, timing), timeout=EMIT_TIMEOUT_S)
        except queue.Full:
            # the consumer stopped pulling.  Dropping chunks would hand the
            # client gapped PCM with no error: fail the stream instead (the
            # row retires at the next chunk boundary)
            self._fail(req, RuntimeError(
                "stream consumer stalled (audio queue full for 5s); "
                "request cancelled"))

    def _fail(self, req: _Request, exc: Exception):
        """Cancel ``req`` and deliver ``exc`` at once, dropping any audio
        still queued so that a stalled consumer sees the failure.  Never
        blocks."""
        req.cancelled = True
        while True:
            try:
                req.out_q.get_nowait()
            except queue.Empty:
                break
        try:
            req.out_q.put_nowait(exc)
        except queue.Full:  # pragma: no cover -- a racing consumer refilled it
            pass

    def _finish_request(self, req: _Request):
        self._stats["served"] += 1
        try:
            req.out_q.put(_SENTINEL, timeout=EMIT_TIMEOUT_S)
        except queue.Full:
            # the consumer stopped pulling at retirement: fail the stream and
            # still land the terminator (the worker never blocks on it)
            self._fail(req, RuntimeError("stream consumer stalled at end of stream"))
            try:
                req.out_q.put_nowait(_SENTINEL)
            except queue.Full:  # pragma: no cover
                pass

    def _peek_admissible(self, pos_lb: int, pos_ub: int,
                         limit: int) -> Optional[_Request]:
        """Pop the next waiting request admissible into the running batch,
        scanning the first ADMIT_SCAN waiting requests out of order (FIFO
        preferred; a request whose prompt bucket exceeds the position does
        not block those behind it).  With chunks in flight the position is
        bracketed on the host: ``pos_lb`` (through the last chunk read)
        bounds it below, ``pos_ub`` (plus the steps booked in flight) above.
        The prompt's bucket must fit below ``pos_lb`` (the join writes
        [pos - Tb, pos): an underflow corrupts the row), and the window must
        have room past ``pos_ub`` for the row to speak."""
        self._drain_arrivals()
        if any(r.cancelled for r in self._waiting):
            # cancelled while waiting: end the stream now
            for r in self._waiting:
                if r.cancelled:
                    self._stats["cancelled"] += 1
                    # every submitted request counts as served once
                    # (ReplicaPool tracks inflight = submits - served)
                    self._stats["served"] += 1
                    r.out_q.put(_SENTINEL)
            self._waiting[:] = [r for r in self._waiting if not r.cancelled]
        for j, req in enumerate(self._waiting[:ADMIT_SCAN]):
            if bucket_for(req.embeds.shape[1]) > pos_lb:
                continue  # too early in the batch window for this request
            if pos_ub + min(req.max_new_tokens, 64) > limit:
                continue  # not enough window left for it to speak
            return self._waiting.pop(j)
        return None

    # ---- warmup

    def _warn_once(self, key, msg: str, *args) -> None:
        if key not in self._warned:
            self._warned.add(key)
            logger.warning(msg, *args)

    def _check_warmed(self, Tb: int) -> None:
        """Warn (once per bucket) when a batch starts at a prefill bucket
        that warmup() did not run: its prefill and joins allocate their
        buffers at serve time."""
        if self._warmed_buckets and Tb not in self._warmed_buckets:
            self._warn_once(("bucket", Tb),
                            "prefill bucket %d was not warmed (warmup had %s): the first "
                            "batch/join at this size allocates at serve time while live "
                            "streams wait; add it to warmup(prefill_buckets=...)",
                            Tb, sorted(self._warmed_buckets))

    def warmup(self, prefill_buckets=(128,), max_tth: Optional[int] = None) -> float:
        """Capture every graph the batcher replays before it serves: the
        decode + batched vocode chunk at each dispatched size
        (``first_chunks`` and ``chunk_size``) for each ``TTH_BUCKETS`` width
        up to ``max_tth``, with pcm16 as served, on the KV cache its batches
        take; and run a batched prefill and a join at each prefill bucket.
        Each join is legal: the state's position equals the bucket (an
        underflowing join would send flash-decode out of bounds).  Serving
        starts its trailing text at the widest warmed width.  Returns
        seconds."""
        t0 = time.perf_counter()
        self._warmed_buckets |= set(prefill_buckets)
        eng, B = self.engine, self.B
        H = self.model.cfg.talker.hidden_size
        gen = torch.Generator(device=eng.device).manual_seed(0)

        def prefill(Tb):
            return eng.prefill(torch.zeros((B, Tb, H), dtype=eng.dtype, device=eng.device),
                               gen, self.policy, self.pred_policy)

        state = None
        try:
            for Tb in sorted(set(prefill_buckets)):
                if state is not None:
                    eng.release(state)
                state = prefill(Tb)
                eng.join_row(state, 0, torch.zeros((1, Tb, H), dtype=eng.dtype,
                                                   device=eng.device),
                             policy=self.policy, pred_policy=self.pred_policy, pos_hint=Tb)
            if state is None:
                state = prefill(PREFILL_BUCKETS[0])
            voc = self.model.vocoder
            vst = voc.scatter_stream_row(voc.stream_state_batched(B), voc.stream_state(), 0)
            # at least the smallest width: a trailing text below it still
            # takes TTH_BUCKETS[0]
            widths = [w for w in TTH_BUCKETS if w <= (max_tth or TTH_BUCKETS[-1])] \
                or [TTH_BUCKETS[0]]
            self._tth_floor = widths[-1]
            tpe = torch.zeros((B, 1, H), dtype=eng.dtype, device=eng.device)
            lens = torch.zeros((B,), dtype=torch.int64, device=eng.device)
            for w in widths:
                tth = torch.zeros((B, w, H), dtype=eng.dtype, device=eng.device)
                for size in dict.fromkeys(self.first_chunks + (self.chunk_size,)):
                    if eng._steps(state, size) < size:  # the cache would cap it
                        eng.release(state)
                        state = prefill(PREFILL_BUCKETS[0])
                    _, _, n, *_, vst = eng.chunk_vocode_batched(
                        voc, state, tth, lens, tpe, size, vst, pcm16=self._pcm16)
                    eng.settle(state, int(n))
        finally:
            if state is not None:
                eng.release(state)
        dt = time.perf_counter() - t0
        logger.info("batcher warmup: %.1fs", dt)
        return dt
