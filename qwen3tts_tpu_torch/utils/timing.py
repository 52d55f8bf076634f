"""The port's tracer, and optional device profiling.

Port of ``qwen3tts_tpu/utils/timing.py``.  ``TRACE`` is the port's one
tracer.  It keeps:

- host spans: a name, a start and an end in ``time.perf_counter`` seconds,
  the span that was open on the same thread when it began (its parent) and
  a request id.  Every span of one API call, batch call or served request
  carries that call's id (``one_request``, ``Tracer.scope``).  Spans are
  recorded only while the tracer is on; while it is off a span site tests
  ``on`` and gets one shared context that does nothing (no clock read, no
  allocation).  They stay in memory, in a bounded buffer, and are read by
  name and time range (``spans``);
- device parts of the captured steps: a recording ``ChunkGraphs`` places
  ``%globaltimer`` stamps inside each captured step (``runtime/graphs.py``)
  and hands a device copy of each replay's stamps here; ``device_spans``
  maps them onto the host spans' clock, linearly between anchors (a stamp
  taken between two synchronises when tracing starts and again when they
  are read);
- counters: plain numbers, kept whether the tracer is on or not;
- the hybrid talker's routing counters: each engine's device counters
  (``ops/routed_experts.py:RouteStats``, which the routed layers add to in
  eager and captured steps alike), read only by ``summary`` and
  ``route_stats``.

``summary`` gives the count, median, largest and total ms of each span and
device part in a time range, with the counters.

A recording ``ChunkGraphs`` turns the tracer on, and so does
``openai_server --trace`` (``enable``), whose ``/health`` then shows the
last minute's ``summary``.
``device_trace`` wraps a generation in a ``torch.profiler`` trace
(``QWEN3TTS_PROFILE_DIR``) and ``device_memory_stats`` gives per-card
memory numbers for status endpoints.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import itertools
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

MAX_SPANS = 1 << 17
MAX_REPLAYS = 1 << 14  # stamped replays held (device copies, ~0.5 KB each)
MAX_ROUTES = 64  # engines' routing counters held (the newest)
# the stamps a captured step takes, in slot order: (step part, 0 at its start
# or 1 at its end); in a graph with the codec its two follow the steps'
STEP_STAMPS = (("predictor_frame", 0), ("talker_step", 0), ("talker_step", 1), ("step", 1))
CODEC_STAMPS = (("codec_stream", 0), ("codec_stream", 1))
# the device parts of a step that ran: (name, its start stamp, its end stamp)
STEP_PARTS = (("predictor_frame", ("predictor_frame", 0), ("talker_step", 0)),
              ("talker_step", ("talker_step", 0), ("talker_step", 1)),
              ("step", ("predictor_frame", 0), ("step", 1)))


def stamp_slots(steps: int, codec: bool) -> int:
    """The stamp buffer's length for a graph of ``steps`` steps."""
    return len(STEP_STAMPS) * steps + (len(CODEC_STAMPS) if codec else 0)


def stamp_slot(part: str, edge: int, step: int, steps: int) -> Optional[int]:
    """The slot of the stamp at ``edge`` of ``part`` in step ``step`` of a
    graph of ``steps`` steps; None where the layout takes none."""
    if (part, edge) in CODEC_STAMPS:
        return len(STEP_STAMPS) * steps + CODEC_STAMPS.index((part, edge))
    if (part, edge) in STEP_STAMPS:
        return len(STEP_STAMPS) * step + STEP_STAMPS.index((part, edge))
    return None


class Span(NamedTuple):
    name: str
    start: float  # time.perf_counter seconds
    end: float
    parent: Optional[int]  # id of the span open on the thread when this one began
    rid: Optional[int]  # request id
    id: Optional[int]  # None for a device part


class _Open:
    __slots__ = ("name", "start", "parent", "rid", "id", "closed")

    def __init__(self, name, start, parent, rid, id_):
        self.name, self.start, self.parent, self.rid, self.id = name, start, parent, rid, id_
        self.closed = False


class _Off:
    """What a span site gets while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _SpanCtx:
    __slots__ = ("tracer", "name", "rid", "open")

    def __init__(self, tracer, name, rid):
        self.tracer, self.name, self.rid = tracer, name, rid

    def __enter__(self):
        self.open = self.tracer.begin(self.name, rid=self.rid)
        return self.open

    def __exit__(self, *exc):
        self.tracer.end(self.open)
        return False


class _ScopeCtx:
    __slots__ = ("local", "rid", "prev")

    def __init__(self, local, rid):
        self.local, self.rid = local, rid

    def __enter__(self):
        self.prev = getattr(self.local, "rid", None)
        self.local.rid = self.rid
        return self.rid

    def __exit__(self, *exc):
        self.local.rid = self.prev
        return False


class Timed:
    """A span whose ends are read whether the tracer is on or not (the
    loops' timing dicts are made from them); recorded while it is on,
    unless ``discard`` was called inside the block."""

    __slots__ = ("tracer", "name", "start", "end", "_open", "_keep")

    def __init__(self, tracer, name):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.start = time.perf_counter()
        self._open = self.tracer.begin(self.name, self.start) if self.tracer.on else None
        self._keep = True
        return self

    def discard(self) -> None:
        self._keep = False

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        if self._open is not None:
            self.tracer.end(self._open, self.end, record=self._keep)
        return False

    @property
    def seconds(self) -> float:
        return self.end - self.start


class _Replay(NamedTuple):
    stamps: torch.Tensor  # a device copy of the replay's stamp buffer
    n: torch.Tensor  # ... and of its steps run
    steps: int  # the graph's chunk size
    codec: bool
    parent: Optional[int]
    rid: Optional[int]


def to_host(ns: np.ndarray, anchors: Sequence[Tuple[float, int]]) -> np.ndarray:
    """``time.perf_counter`` seconds of device timer readings ``ns``
    (int64 nanoseconds): linear between the two anchors (host seconds,
    device ns) around each reading, the nearest two beyond them; one anchor
    maps by its offset alone.  Differences are taken in integers first, so
    that a reading of ~1.8e18 ns keeps its nanoseconds."""
    ns = np.asarray(ns, np.int64)
    pts = sorted(anchors, key=lambda a: a[1])
    if not pts:
        raise ValueError("no clock anchor: the device clock was never read")
    if len(pts) == 1:
        h, d = pts[0]
        return h + (ns - np.int64(d)).astype(np.float64) * 1e-9
    dev = np.array([d for _, d in pts], np.int64)
    host = np.array([h for h, _ in pts], np.float64)
    i = np.clip(np.searchsorted(dev, ns), 1, len(pts) - 1)
    d0, d1 = dev[i - 1], dev[i]
    rate = (host[i] - host[i - 1]) / (d1 - d0).astype(np.float64)
    return host[i - 1] + (ns - d0).astype(np.float64) * rate


class Tracer:
    def __init__(self):
        self.on = False
        self.counters: Dict[str, float] = {}
        self._spans: deque = deque(maxlen=MAX_SPANS)
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._rids = itertools.count(1)
        self._lock = threading.Lock()
        self._clock: Optional[Callable[[], Tuple[float, int]]] = None
        self.anchors: List[Tuple[float, int]] = []
        self._replays: deque = deque(maxlen=MAX_REPLAYS)
        self._routes: deque = deque(maxlen=MAX_ROUTES)

    # ---- on and off
    def enable(self, clock: Optional[Callable[[], Tuple[float, int]]] = None) -> None:
        """Record spans from now on.  ``clock`` reads the device timer
        against the host's (a (perf_counter seconds, timer ns) pair, between
        two synchronises); it is read now and whenever device parts are."""
        if clock is not None:
            self._clock = clock
            self.anchors.append(clock())
        self.on = True

    def disable(self) -> None:
        self.on = False

    def clear(self) -> None:
        """Drop every span, device part and anchor (counters stay)."""
        with self._lock:
            self._spans.clear()
            self._replays.clear()
            self.anchors = self.anchors[-1:] if self._clock is not None else []

    # ---- counters
    def count(self, name: str, k: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + k

    def add_routes(self, stats) -> None:
        """Keep an engine's routing counters (``RouteStats``)."""
        with self._lock:
            self._routes.append(stats)

    def route_stats(self) -> list:
        """The routing counters held, oldest first."""
        with self._lock:
            return list(self._routes)

    def _route_counters(self) -> Dict[str, float]:
        """``moe.experts_touched`` (experts a routed layer's decode call
        touched, the mean over every call) and ``moe.load_max_over_mean``
        (the busiest expert's rows over the mean expert's, by layer, the
        mean over layers and engines, weighted by calls), over the engines
        held that routed; nothing without them."""
        reads = [r for r in (s.read() for s in self.route_stats()) if r["calls"]]
        calls = sum(r["calls"] for r in reads)
        if not calls:
            return {}
        return {"moe.experts_touched": sum(r["experts_touched"] * r["calls"]
                                           for r in reads) / calls,
                "moe.load_max_over_mean": sum(r["load_max_over_mean"] * r["calls"]
                                              for r in reads) / calls}

    # ---- request ids
    def new_request(self) -> int:
        return next(self._rids)

    def current_request(self) -> Optional[int]:
        return getattr(self._local, "rid", None)

    def scope(self, rid: Optional[int]):
        """Spans begun on this thread inside the block carry ``rid``."""
        if not self.on:
            return _OFF
        return _ScopeCtx(self._local, rid)

    # ---- spans
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, rid: Optional[int] = None):
        """A context that records the span ``name`` around its block."""
        if not self.on:
            return _OFF
        return _SpanCtx(self, name, rid)

    def timed(self, name: str) -> Timed:
        return Timed(self, name)

    def begin(self, name: str, start: Optional[float] = None,
              rid: Optional[int] = None) -> Optional[_Open]:
        """Open the span ``name`` (None while off); ``end`` closes it."""
        if not self.on:
            return None
        st = self._stack()
        parent = st[-1] if st else None
        if rid is None:
            rid = getattr(self._local, "rid", None)
            if rid is None and parent is not None:
                rid = parent.rid
        sp = _Open(name, time.perf_counter() if start is None else start,
                   parent.id if parent is not None else None, rid, next(self._ids))
        st.append(sp)
        return sp

    def end(self, sp: Optional[_Open], end: Optional[float] = None,
            record: bool = True) -> None:
        """Close ``sp`` (recorded unless ``record`` is False)."""
        if sp is None or sp.closed:
            return
        sp.closed = True
        t = time.perf_counter() if end is None else end
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        elif any(o is sp for o in st):
            st[:] = [o for o in st if o is not sp]
        if record:
            self._record(Span(sp.name, sp.start, t, sp.parent, sp.rid, sp.id))

    def _record(self, span: Span) -> None:
        if len(self._spans) == self._spans.maxlen:
            self.count("spans_dropped")
        self._spans.append(span)

    def spans(self, name=None, lo: Optional[float] = None,
              hi: Optional[float] = None) -> List[Span]:
        """Recorded spans (oldest first) named ``name`` (a name or a set of
        them; any when None) that overlap [lo, hi]."""
        return _select(list(self._spans), name, lo, hi)

    # ---- device parts of the captured steps
    def device_replay(self, stamps: torch.Tensor, n: torch.Tensor, steps: int,
                      codec: bool) -> None:
        """Take a recording replay's stamps (``STEP_STAMPS`` a step, then
        ``CODEC_STAMPS`` with the codec; a slot the replay skipped reads 0)
        and its steps run ``n``: copies on the device that nothing writes
        again, read when the device parts are."""
        if not self.on:
            return
        st = self._stack()
        parent = st[-1] if st else None
        rid = getattr(self._local, "rid", None)
        if rid is None and parent is not None:
            rid = parent.rid
        self._replays.append(_Replay(stamps, n, steps, codec,
                                     parent.id if parent else None, rid))
        self.count("stamped_replays")

    def stamped_replays(self) -> List[Tuple[_Replay, np.ndarray, int]]:
        """Each replay held (oldest first): its record, its raw stamps
        (int64 ns, 0 where a step did not run) and its steps run.  Reads the
        device clock first (a synchronise: every replay has run)."""
        replays = list(self._replays)
        if replays and self._clock is not None:
            self.anchors.append(self._clock())
        return [(r, r.stamps.cpu().numpy(), int(r.n)) for r in replays]

    def device_spans(self, name=None, lo: Optional[float] = None,
                     hi: Optional[float] = None) -> List[Span]:
        """The captured steps' device parts as spans on the host's clock:
        ``predictor_frame`` (the predictor frame's start to the talker
        step's), ``talker_step`` (the talker step's two ends), ``step``
        (the predictor frame's start to the step's end) and, in the graphs
        with the codec, ``codec_stream``; a step that did not run has none.
        Each carries the parent and request id of the host span open at its
        replay.  Filtered as ``spans`` filters."""
        parts = []
        for r, raw, n in self.stamped_replays():
            for i in range(min(n, r.steps)):
                at = {k: raw[stamp_slot(*k, i, r.steps)] for k in STEP_STAMPS}
                if all(at.values()):  # 0: the step did not run
                    parts += [(name, at[a], at[b], r) for name, a, b in STEP_PARTS]
            if r.codec:
                c0, c1 = (raw[stamp_slot(*k, 0, r.steps)] for k in CODEC_STAMPS)
                if c0 and c1:
                    parts.append(("codec_stream", c0, c1, r))
        if not parts:
            return []
        ns = np.array([[p[1], p[2]] for p in parts], np.int64)
        host = to_host(ns, self.anchors)
        out = [Span(p[0], float(h[0]), float(h[1]), p[3].parent, p[3].rid, None)
               for p, h in zip(parts, host)]
        return _select(out, name, lo, hi)


    def summary(self, lo: Optional[float] = None, hi: Optional[float] = None) -> dict:
        """For status endpoints and tools: each span name's count and its
        median, largest and total ms over the spans that overlap [lo, hi],
        the captured steps' device parts the same way (``device``; none
        without a stamped replay, so that no caller synchronises for
        nothing) and the counters, the routing counters' ``moe.*`` with
        them (a device read, where an engine routed)."""
        device = self.device_spans(lo=lo, hi=hi) if self._replays and self.anchors else []
        return {"spans": _durations(self.spans(lo=lo, hi=hi)),
                "device": _durations(device),
                "counters": {**self.counters, **self._route_counters()}}


def _durations(spans: Iterable[Span]) -> Dict[str, dict]:
    by: Dict[str, List[float]] = {}
    for s in spans:
        by.setdefault(s.name, []).append((s.end - s.start) * 1e3)
    return {k: {"n": len(v), "p50_ms": float(np.median(v)), "max_ms": max(v),
                "total_ms": sum(v)} for k, v in sorted(by.items())}


def _select(spans: Iterable[Span], name, lo, hi) -> List[Span]:
    names = {name} if isinstance(name, str) else (set(name) if name is not None else None)
    return [s for s in spans
            if (names is None or s.name in names)
            and (lo is None or s.end >= lo) and (hi is None or s.start <= hi)]


TRACE = Tracer()


def one_request(fn):
    """Give every span that ``fn`` (a function or a generator function)
    records one request id of its own, or the id of the request it runs in.
    A generator's id holds across its yields: each resumption runs in the
    request's scope, and the caller's code between them does not."""
    if inspect.isgeneratorfunction(fn):
        @functools.wraps(fn)
        def gen(*a, **k):
            inner = fn(*a, **k)
            if not TRACE.on:
                return (yield from inner)
            rid = TRACE.current_request() or TRACE.new_request()
            with contextlib.closing(inner):
                while True:
                    with TRACE.scope(rid):
                        try:
                            item = next(inner)
                        except StopIteration as stop:
                            return stop.value
                    yield item
        return gen

    @functools.wraps(fn)
    def call(*a, **k):
        if not TRACE.on or TRACE.current_request() is not None:
            return fn(*a, **k)
        with TRACE.scope(TRACE.new_request()):
            return fn(*a, **k)
    return call


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
    ``use_cuda_graphs=False``; the captured steps' parts are timed by
    ``TRACE``'s stamps instead."""
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
