"""Captured decode chunks: one CUDA graph per chunk program.

The port's counterpart of the JAX engine's ``jax.jit(_chunk_impl)`` and
``_build_chunk_vocode`` (``qwen3tts_tpu/runtime/engine.py``): a chunk of
frame steps, and optionally the streaming codec over its frames (row 0's,
or every row's), captured once into a ``torch.cuda.CUDAGraph`` and replayed
for every later chunk with the same key.  A key is (chunk size,
trailing-text length, the policies' ``StaticPolicy``, the vocoder or none,
pcm16, one row or every row to the codec) within one KV cache: a graph reads
and writes fixed addresses, so each cache (a ``_Slot``) has its own graphs
and its own static buffers:

- the decode state's tensors (``engine.STATE_TENSORS``), which the steps
  update in place; a request's state is copied in at its first chunk on the
  slot, and its dict then points at the slot's tensors;
- the inputs: the knob tensor, the trailing text per length, the tts_pad
  embedding and the trailing-text length, copied in when the caller passes
  another tensor than the one copied last or wrote that one in place since
  (its version counter), the length at every replay;
- the outputs per graph: ``frames [B, chunk, 16]``, ``n``, ``lens``,
  ``done`` and, with the codec, the audio; the next replay of that graph
  overwrites them;
- the codec's stream state per vocoder: ``decode_stream`` returns a new
  state, which the graph copies back into the static one;
- the cache itself, the hybrid talker's convolution state with it, which
  the steps update in place.

Every graph shares one memory pool and replays on the caller's stream; the
kernels' workspaces are one set per shape, ordered on that stream, so the
graphs never run at once.  Before a capture one eager step runs on copies of
the state, so that the kernels allocate their workspaces (they refuse to
during capture) without touching the request.  Python's cycle collector is
paused while a chunk is captured: a collection could free an unreachable
engine's graphs, and a graph destroyed during a capture breaks it.  A
capture is thread-local (``capture_error_mode="thread_local"``), so a
server's other threads may run CUDA work meanwhile.  A capture that fails
raises.

The chunk stops as the JAX ``while_loop`` does: each step is the body of a
CUDA graph conditional (IF) node, whose predicate, ``any(~done) & (pos <
max_seq_len - 1)``, the graph computes on the device just before it.  A step
that does not run launches nothing; the frames past the last step that ran
stay zeros, and ``n`` counts the steps that ran.  The node is built through
the CUDA runtime (``csrc/graph_cond.cu``, CUDA 12.4 or later; the card's
torch has no ``CUDAGraph.begin_capture_to_if_node``): the step is captured
on a stream of its own into the node's body graph, its allocations routed
to a memory pool of the graphs' own (``_IfNodes``).  A capture that cannot
build its nodes raises: no chunk is captured without them.

``ChunkGraphs(engine, record=True)`` is for measurement: its graphs keep
their ``cudaGraph_t`` and the bodies of their conditional nodes, so that
``kernel_nodes`` can walk what a replay launches, and ``log`` takes every
replay (its graph, a copy of its ``n``, CUDA events around it).  It turns
the tracer on (``utils/timing.py:TRACE``), and its captured steps carry
device timestamps: a one-thread kernel
(``csrc/graph_cond.cu:qwen3tts_stamp``) writes ``%globaltimer`` into a slot
of the graph's stamp buffer where the predictor frame starts, where the
talker step starts and ends and where the step ends, inside the step's
conditional body, and around the codec in the graphs that have it
(``Engine._part`` places them).  The buffer is zeroed in the graph's
preamble, so a step that did not run reads 0; after each replay a device
copy of it goes to the tracer with the replay's ``n``.  The kernel walk skips the stamps, so a
graph counts the same nodes with them or without.  An unrecorded graph has
no stamps.

Sampling draws from a generator the graphs are registered with; each replay
takes the request's generator's seed and offset and hands the advanced
offset back, so a replay draws what the same steps would draw eagerly.  The
offsets are fixed at capture: a step that the conditional node skips
advances the generator's offset as if it had run, so the steps that run draw
what eager steps draw, and a request after a chunk that stopped early draws
from a later offset than the eager steps would have.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import time
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models import talker as talker_lib
from ..ops import cuda_build
from ..utils.timing import TRACE, stamp_slot, stamp_slots
from .engine import STATE_TENSORS


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _copy_tree(dst, src) -> None:
    for d, s in zip(_leaves(dst), _leaves(src), strict=True):
        d.copy_(s)


@functools.lru_cache(maxsize=None)
def _cond_lib() -> ctypes.CDLL:
    lib = cuda_build.library("graph_cond")
    lib.qwen3tts_cond_stream.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.qwen3tts_cond_begin.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.POINTER(ctypes.c_void_p)] * 2
    lib.qwen3tts_cond_end.argtypes = [ctypes.c_void_p]
    lib.qwen3tts_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.qwen3tts_stamp_clear.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.qwen3tts_graph_kernels.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t)]
    for fn in (lib.qwen3tts_cond_stream, lib.qwen3tts_cond_begin, lib.qwen3tts_cond_end,
               lib.qwen3tts_graph_kernels, lib.qwen3tts_stamp, lib.qwen3tts_stamp_clear):
        fn.restype = ctypes.c_int
    return lib


def _stamp(slot_ptr: int, device: torch.device) -> None:
    """``%globaltimer`` into the int64 at ``slot_ptr``, on the current stream."""
    _check(_cond_lib().qwen3tts_stamp(torch.cuda.current_stream(device).cuda_stream, slot_ptr),
           "launch a stamp")


class _DeviceClock:
    """The device timer read against ``time.perf_counter``: a stamp
    between two synchronises, placed at the middle of the host's two
    readings."""

    def __init__(self, device: torch.device):
        self.device = device
        self.buf = torch.zeros((1,), dtype=torch.int64, device=device)

    def __call__(self) -> Tuple[float, int]:
        torch.cuda.synchronize(self.device)
        h0 = time.perf_counter()
        _stamp(self.buf.data_ptr(), self.device)
        torch.cuda.synchronize(self.device)
        h1 = time.perf_counter()
        return (h0 + h1) / 2, int(self.buf.item())


class _Stamps:
    """A recording capture's stamp buffer, in the tracer's layout
    (``utils/timing.py:STEP_STAMPS``).  ``mark(part, edge)`` captures a
    stamp for the ``edge`` (0 start, 1 end) of ``part`` in step ``step``
    where the layout has one, and nothing elsewhere."""

    def __init__(self, chunk: int, codec: bool, device: torch.device):
        self.chunk, self.device = chunk, device
        self.buf = torch.zeros((stamp_slots(chunk, codec),), dtype=torch.int64, device=device)
        self.step = 0

    def clear(self) -> None:
        _check(_cond_lib().qwen3tts_stamp_clear(
            torch.cuda.current_stream(self.device).cuda_stream, self.buf.data_ptr(),
            self.buf.numel() * self.buf.element_size()), "clear the stamps")

    def mark(self, part: str, edge: int) -> None:
        slot = stamp_slot(part, edge, self.step, self.chunk)
        if slot is None:
            return
        _stamp(self.buf.data_ptr() + slot * self.buf.element_size(), self.device)


def graph_kernels(graph: int, needles: Sequence[str]) -> Tuple[List[int], List[int]]:
    """The kernel nodes of the CUDA graph ``graph`` (a ``cudaGraph_t``) and
    of its child graphs, by kernel name: one count per needle (the nodes
    whose mangled name contains it, the first that matches), then all of
    them; and the graph's conditional nodes, whose bodies are not walked."""
    lib = _cond_lib()
    names = (ctypes.c_char_p * len(needles))(*(n.encode() for n in needles))
    counts = (ctypes.c_longlong * (len(needles) + 1))()
    cap = 4096
    conds = (ctypes.c_void_p * cap)()
    n_conds = ctypes.c_size_t(cap)
    _check(lib.qwen3tts_graph_kernels(graph, names, len(needles), counts, conds,
                                      ctypes.byref(n_conds)), "walk a CUDA graph")
    if n_conds.value > cap:
        raise RuntimeError(f"a graph of {n_conds.value} conditional nodes (at most {cap})")
    return list(counts), [conds[i] for i in range(n_conds.value)]


class _IfNodes:
    """Conditional nodes for one device's captures.  ``node(pred)`` is a
    context: what it runs is captured into the body of an IF node of the
    graph being captured on the current stream, run when the 0-d bool device
    tensor ``pred`` holds.  The body is captured on a stream of its own,
    with the current thread's allocations routed to a private pool that
    stays reserved while this object lives: the allocator gives a capture's
    temporaries its graph's pool only on streams that share the capture's
    id, and the body's stream captures the node's body graph instead."""

    def __init__(self, device: torch.device):
        self.index = device.index if device.index is not None else torch.cuda.current_device()
        lib = _cond_lib()
        ptr = ctypes.c_void_p()
        _check(lib.qwen3tts_cond_stream(ctypes.byref(ptr)), "create the body stream")
        self.body_ptr = ptr.value
        self.body = torch.cuda.ExternalStream(self.body_ptr, device=device)
        self.pool = torch.cuda.graph_pool_handle()
        # one use of the pool held until this object goes
        torch._C._cuda_beginAllocateCurrentThreadToPool(self.index, self.pool)
        torch._C._cuda_endAllocateToPool(self.index, self.pool)
        weakref.finalize(self, torch._C._cuda_releasePool, self.index, self.pool)

    @contextlib.contextmanager
    def node(self, pred: torch.Tensor, bodies: Optional[list] = None):
        """``bodies``, when given, takes (the node, its body graph)."""
        lib = _cond_lib()
        parent = torch.cuda.current_stream(pred.device).cuda_stream
        node, body = ctypes.c_void_p(), ctypes.c_void_p()
        _check(lib.qwen3tts_cond_begin(parent, pred.data_ptr(), self.body_ptr,
                                       ctypes.byref(node), ctypes.byref(body)),
               "begin a conditional node")
        if bodies is not None:
            bodies.append((node.value, body.value))
        torch._C._cuda_beginAllocateCurrentThreadToPool(self.index, self.pool)
        try:
            with torch.cuda.stream(self.body):
                yield
        finally:
            torch._C._cuda_endAllocateToPool(self.index, self.pool)
            torch._C._cuda_releasePool(self.index, self.pool)
            _check(lib.qwen3tts_cond_end(self.body_ptr), "end a conditional node")


def _check(rc: int, what: str) -> None:
    if rc == -1:
        raise RuntimeError(f"cannot {what}: the stream is not capturing a graph")
    if rc >= 10000:
        raise RuntimeError(f"cannot {what}: CUresult {rc - 10000}")
    if rc != 0:
        raise RuntimeError(f"cannot {what}: cudaError {rc}")


class _Graph(NamedTuple):
    """One captured chunk and its output buffers."""

    graph: torch.cuda.CUDAGraph
    frames: torch.Tensor
    n: torch.Tensor
    lens: torch.Tensor
    done: torch.Tensor
    audio: Optional[torch.Tensor]
    bodies: Tuple = ()  # (IF node, its body graph) a step, with record=True
    stamps: Optional[_Stamps] = None  # with record=True


class _Slot:
    """One KV cache's static buffers and graphs."""

    def __init__(self, kv: Dict[str, torch.Tensor]):
        self.kv = kv
        self.state: Optional[Dict[str, torch.Tensor]] = None
        self.inputs: Dict = {}  # name -> static tensor
        self.sources: Dict = {}  # name -> (the caller's tensor copied in last, its version)
        self.voc: Dict[tuple, tuple] = {}  # (id(vocoder), full_batch) -> (vocoder, stream state)
        self.graphs: Dict[tuple, _Graph] = {}


class ChunkGraphs:
    """The captured chunks of one Engine on the card."""

    def __init__(self, engine, record: bool = False):
        self.engine = engine
        self.record = record
        self.log: List[tuple] = []  # with record: (_Graph, n, start, end) a replay
        dev = engine.device
        if record:
            TRACE.enable(_DeviceClock(dev))
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(dev)
        self.generator = torch.Generator(device=dev)
        self._default_gen = torch.cuda.default_generators[
            dev.index if dev.index is not None else torch.cuda.current_device()]
        self._slots: Dict[int, _Slot] = {}  # id(kv) -> slot (which holds kv)
        self._if_nodes: Optional[_IfNodes] = None
        self.captures = 0
        self.replays = 0

    def has_graphs(self, kv) -> bool:
        slot = self._slots.get(id(kv))
        return slot is not None and slot.kv is kv and bool(slot.graphs)

    def _slot(self, kv) -> _Slot:
        slot = self._slots.get(id(kv))
        if slot is None or slot.kv is not kv:
            slot = self._slots[id(kv)] = _Slot(kv)
        return slot

    def _input(self, slot: _Slot, name, src: torch.Tensor) -> torch.Tensor:
        """The slot's static copy of ``src``, refreshed when ``src`` is
        another tensor than the one copied in last or was written since (its
        version counter moved: a batch writes a joining row's trailing text
        and tts_pad embedding in place).  An inference tensor keeps no
        version counter, so it is copied every time."""
        buf = slot.inputs.get(name)
        if buf is None:
            buf = slot.inputs[name] = torch.empty_like(src)
        version = None if src.is_inference() else src._version
        last = slot.sources.get(name)
        if last is None or last[0] is not src or version is None or last[1] != version:
            buf.copy_(src)
            slot.sources[name] = (src, version)
        return buf

    def _bind(self, slot: _Slot, state: Dict, tth, tth_len, tpe):
        """Point the state at the slot's tensors (copying the request's
        values in at its first chunk here) and the inputs at the slot's."""
        if slot.state is None:
            slot.state = {k: torch.empty_like(state[k]) for k in STATE_TENSORS}
        for k in STATE_TENSORS:
            if state[k] is not slot.state[k]:
                slot.state[k].copy_(state[k])
                state[k] = slot.state[k]
        state["owned"] = True
        tth_s = self._input(slot, ("tth", tth.shape[1]), tth)
        tpe_s = self._input(slot, "tpe", tpe)
        n = slot.inputs.get("tth_len")
        if n is None:
            n = slot.inputs["tth_len"] = torch.empty((self.engine.batch,), dtype=torch.int64,
                                                     device=self.engine.device)
        if isinstance(tth_len, torch.Tensor):
            n.copy_(tth_len)
        else:
            n.fill_(int(tth_len))
        return tth_s, n, tpe_s

    def _bind_voc(self, slot: _Slot, vocoder, voc_state: Dict, full_batch: bool) -> Dict:
        key = (id(vocoder), full_batch)
        entry = slot.voc.get(key)
        if entry is None or entry[0] is not vocoder:
            entry = slot.voc[key] = (vocoder, vocoder.stream_state_batched(self.engine.batch)
                                     if full_batch else vocoder.stream_state())
        static = entry[1]
        if voc_state is not static:
            _copy_tree(static, voc_state)
        return static

    def run(self, state: Dict, tth, tth_len, tpe, chunk: int, vocoder=None,
            voc_state: Optional[Dict] = None, pcm16: bool = False, full_batch: bool = False):
        """Replay (capturing first when needed) the chunk for this key.
        Returns (frames, n, lens, done) and, with a vocoder, also (audio,
        voc_state): the graph's buffers."""
        slot = self._slot(state["kv"])
        tth_s, tth_len_s, tpe_s = self._bind(slot, state, tth, tth_len, tpe)
        voc_s = (self._bind_voc(slot, vocoder, voc_state, full_batch)
                 if vocoder is not None else None)
        key = (chunk, tth.shape[1], state["policy"].static, state["pred_policy"].static,
               id(vocoder) if vocoder is not None else None, pcm16, full_batch)
        g = slot.graphs.get(key)
        if g is None:
            with TRACE.span("capture"):
                g = slot.graphs[key] = self._capture(slot, state, tth_s, tth_len_s, tpe_s,
                                                     chunk, vocoder, voc_s, pcm16, full_batch)
        src = state["generator"] if state["generator"] is not None else self._default_gen
        self.generator.set_state(src.get_state())
        if self.record:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            g.graph.replay()
            end.record()
            n = g.n.clone()
            self.log.append((g, n, start, end))
            if g.stamps is not None:
                TRACE.device_replay(g.stamps.buf.clone(), n, chunk, vocoder is not None)
        else:
            g.graph.replay()
        src.set_state(self.generator.get_state())
        self.replays += 1
        if vocoder is None:
            return g.frames, g.n, g.lens, g.done
        return g.frames, g.n, g.lens, g.done, g.audio, voc_s

    def _capture(self, slot: _Slot, state: Dict, tth, tth_len, tpe, chunk: int, vocoder,
                 voc: Optional[Dict], pcm16: bool, full_batch: bool) -> _Graph:
        eng = self.engine
        if self._if_nodes is None:
            self._if_nodes = _IfNodes(eng.device)
        if_node = self._if_nodes.node
        B, dev = eng.batch, eng.device
        frames = torch.zeros((B, chunk, 16), dtype=torch.int64, device=dev)
        n = torch.zeros((), dtype=torch.int64, device=dev)
        lens = torch.zeros((B,), dtype=torch.int64, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        audio = None
        if vocoder is not None:
            samples = chunk * vocoder.spf
            audio = torch.zeros((B, samples) if full_batch else (samples,),
                                dtype=torch.int16 if pcm16 else torch.float32, device=dev)
        # one eager step (and codec call) on copies: the kernels allocate
        # their workspaces here; the request's state, stream and generator
        # stay as they were (the step's cache row at ``pos`` is rewritten by
        # the next real step before anything reads it; the hybrid talker's
        # convolution state, which a step shifts, is copied)
        copy = {**state, **{k: slot.state[k].clone() for k in STATE_TENSORS},
                "generator": self.generator,
                "kv": talker_lib.with_row_state_copied(state["kv"])}
        eng._one_step(copy, tth, tth_len, tpe)
        if vocoder is not None:
            eng._vocode(vocoder, _clone_tree(voc), frames, pcm16, full_batch)
        static = {**state, "generator": self.generator}
        limit = eng.max_seq_len - 1
        bodies = [] if self.record else None
        stamps = _Stamps(chunk, vocoder is not None, dev) if self.record else None

        def body():
            if stamps is not None:
                stamps.clear()
            frames.zero_()
            n.zero_()
            lens.zero_()
            for i in range(chunk):
                # the JAX loop's cond, on the device: some row live, room left
                live = (~static["done"]).any() & (static["pos"][0] < limit)
                with if_node(live, bodies):
                    if stamps is not None:
                        stamps.step = i
                    eng._chunk_step(static, tth, tth_len, tpe, frames, lens, n, i)
                    if stamps is not None:
                        stamps.mark("step", 1)
            done.copy_(static["done"])
            if vocoder is not None:
                a, new = eng._vocode(vocoder, voc, frames, pcm16, full_batch)
                audio.copy_(a)
                _copy_tree(voc, new)

        graph = torch.cuda.CUDAGraph(keep_graph=True) if self.record else torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        # thread-local capture: another thread's CUDA calls (a server's
        # speaker encoder) neither break nor are refused by this capture
        eng._stamps = stamps
        try:
            with _no_gc(), torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                            capture_error_mode="thread_local"):
                body()
        finally:
            eng._stamps = None
        if self.record:
            graph.instantiate()
        self.captures += 1
        return _Graph(graph, frames, n, lens, done, audio, tuple(bodies or ()), stamps)

    def kernel_nodes(self, g: _Graph, needles: Sequence[str]
                     ) -> Tuple[List[int], List[List[int]]]:
        """What a replay of ``g`` (captured with ``record=True``) launches:
        the counts of ``graph_kernels`` for the graph outside its
        conditional nodes, and for each step's node body in step order (a
        replay runs the bodies of its first ``n`` steps)."""
        if not self.record:
            raise ValueError("kernel_nodes needs ChunkGraphs(record=True)")
        top, conds = graph_kernels(g.graph.raw_cuda_graph(), needles)
        if sorted(conds) != sorted(node for node, _ in g.bodies):
            raise RuntimeError(f"the graph holds {len(conds)} conditional nodes; "
                               f"{len(g.bodies)} were captured")
        steps = []
        for _node, body in g.bodies:
            counts, inner = graph_kernels(body, needles)
            if inner:
                raise RuntimeError("a step's body holds a conditional node")
            steps.append(counts)
        return top, steps


@contextlib.contextmanager
def _no_gc():
    """Python's cycle collector paused: a collection during a capture could
    free an unreachable engine's graphs, and destroying a graph while a
    stream captures fails and breaks the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.clone()
